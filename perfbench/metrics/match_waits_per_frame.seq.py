"""match_waits_per_frame.seq: host waits for the device (lib/spans.WAITS)
inside the span xrsfm.match of the traced pass (pair selection to fp.bin),
over the frames the pass was fed.  None where the trace or the span is
absent."""

from perfbench.lib import spans


def read(run):
    t, u = run.trace, run.trace_unit
    if t is None or not t.n_device_ops or not u.get("frames"):
        return None
    n = spans.waits(t, "xrsfm.match")
    return None if n is None else n / u["frames"]
