"""register_idle_pct.seq: device-idle seconds inside the mapper's
registration phases (spans xrsfm.mapper.select, .register, .consistency)
over the traced pass's seconds, in %.  Prints on stderr the share of the
pass's device-idle time that lies inside any xrsfm.* span.  None where the
trace or the spans are absent."""

from perfbench.lib import spans

PHASES = ("xrsfm.mapper.select", "xrsfm.mapper.register",
          "xrsfm.mapper.consistency")


def read(run):
    t = run.trace
    if t is None or not t.n_device_ops or not run.trace_unit.get("frames"):
        return None
    spans.print_coverage(t)
    idle = spans.idle_s(t, PHASES)
    return None if idle is None else 100.0 * idle / t.window_s
