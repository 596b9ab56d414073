"""waits_per_lm.bal: host waits for the device (lib/spans.WAITS) inside
the span xrsfm.ba.solve of the traced solve, over its LM iterations
(optim/ba.COUNTS["lm_iters"]).  None where the trace or the span is
absent."""

from perfbench.lib import spans


def read(run):
    t, u = run.trace, run.trace_unit
    if t is None or not t.n_device_ops or not u.get("lm_iters"):
        return None
    n = spans.waits(t, "xrsfm.ba.solve")
    return None if n is None else n / u["lm_iters"]
