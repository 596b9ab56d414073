"""tracks_idle_pct.seq: device-idle seconds inside the mapper's track
phases (spans xrsfm.mapper.triangulate, .filter, .merge) over the traced
pass's seconds, in %.  None where the trace or the spans are absent."""

from perfbench.lib import spans

PHASES = ("xrsfm.mapper.triangulate", "xrsfm.mapper.filter",
          "xrsfm.mapper.merge")


def read(run):
    t = run.trace
    if t is None or not t.n_device_ops or not run.trace_unit.get("frames"):
        return None
    idle = spans.idle_s(t, PHASES)
    return None if idle is None else 100.0 * idle / t.window_s
