"""device_idle_pct.seq: share of the traced pass in which no kernel, copy
or fill ran on the card, in %."""


def read(run):
    t = run.trace
    if t is None or not t.n_device_ops or not run.trace_unit.get("frames"):
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
