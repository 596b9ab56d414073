"""device_idle_pct.bal: share of the traced solve in which no kernel, copy
or fill ran on the card, in %."""


def read(run):
    t = run.trace
    if t is None or not t.n_device_ops or "solve" not in \
            run.trace_unit.get("spans", {}):
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
