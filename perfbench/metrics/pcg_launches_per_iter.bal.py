"""pcg_launches_per_iter.bal: the host's launch calls (cudaLaunchKernel*,
cuLaunchKernel*, cudaGraphLaunch, cudaMemsetAsync) that start inside the
spans xrsfm.ba.pcg of the traced solve, over its PCG iterations
(optim/ba.COUNTS["cg_iters"]): what the host issues for an iteration of
PCG, with PCG's setup (and a graph's capture, where the program captures
one) shared out over the iterations.  None where the trace, the spans or
the iterations are absent."""

import numpy as np

from perfbench.lib import spans

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
            "cudaMemsetAsync")


def read(run):
    t, u = run.trace, run.trace_unit
    if t is None or not t.n_device_ops or not u.get("cg_iters"):
        return None
    iv = spans.intervals(t, "xrsfm.ba.pcg")
    if iv is None:
        return None
    ids = [i for i, n in enumerate(t.names) if n.startswith(LAUNCHES)]
    s = t.host_start[np.isin(t.host_name, ids)]
    k = np.searchsorted(iv[0], s, side="right") - 1
    inside = (k >= 0) & (s < iv[1][np.maximum(k, 0)])
    return int(inside.sum()) / u["cg_iters"]
