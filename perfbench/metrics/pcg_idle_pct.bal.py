"""pcg_idle_pct.bal: device-idle share of the time inside the spans
xrsfm.ba.pcg of the traced solve (the PCG loop with its stop test's read
an iteration, and the back-substitution), in %: PCG's host / device
split.  Prints on stderr the share of the solve's device-idle time that
lies inside any xrsfm.* span and inside the LM step's rows, schur, pcg
and cost spans.  None where the trace or the spans are absent."""

from perfbench.lib import spans

STEP = ("xrsfm.ba.rows", "xrsfm.ba.schur", "xrsfm.ba.pcg", "xrsfm.ba.cost")


def read(run):
    t = run.trace
    if t is None or not t.n_device_ops or "solve" not in \
            run.trace_unit.get("spans", {}):
        return None
    spans.print_coverage(t, STEP, "xrsfm.ba.solve")
    inside = spans.span_s(t, "xrsfm.ba.pcg")
    if not inside:
        return None
    return 100.0 * spans.idle_s(t, "xrsfm.ba.pcg") / inside
