"""device_ops_per_frame.seq: device operations (kernels, copies, fills) in
the trace of one pass, over the frames the pass was fed."""


def read(run):
    t, u = run.trace, run.trace_unit
    if t is None or not t.n_device_ops or not u.get("frames"):
        return None
    return t.n_device_ops / u["frames"]
