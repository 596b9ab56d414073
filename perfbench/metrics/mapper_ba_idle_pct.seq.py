"""mapper_ba_idle_pct.seq: device-idle seconds inside the mapper's bundle
adjustment phases (spans xrsfm.mapper.lba, .gba and .polish: the
intervals ba_s.seq sums) over the traced pass's seconds, in %.  None where
the trace or the spans are absent."""

from perfbench.lib import spans

PHASES = ("xrsfm.mapper.lba", "xrsfm.mapper.gba", "xrsfm.mapper.polish")


def read(run):
    t = run.trace
    if t is None or not t.n_device_ops or not run.trace_unit.get("frames"):
        return None
    idle = spans.idle_s(t, PHASES)
    return None if idle is None else 100.0 * idle / t.window_s
