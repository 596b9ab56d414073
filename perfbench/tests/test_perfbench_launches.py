"""The reader of pcg_launches_per_iter.bal on a hand-built trace: the
host's launch calls inside the spans xrsfm.ba.pcg over the traced unit's
PCG iterations, and None where the trace, the spans or the iterations
are absent."""

import types

import numpy as np
import pytest

from perfbench.lib import spec, tracing

MS = 1_000_000


def trace_of(dev, host):
    names, ids = [], {}

    def arrays(evs):
        n, s, d = [], [], []
        for name, a, b in evs:
            if name not in ids:
                ids[name] = len(names)
                names.append(name)
            n.append(ids[name])
            s.append(a * MS)
            d.append((b - a) * MS)
        return tuple(np.asarray(x, np.int64) for x in (n, s, d))

    return tracing.Trace(names, arrays(dev), arrays(host), 1.0)


def call(name, t):
    return (name, t, t + 1)


DEV = [("k", 260, 300), ("k", 620, 700)]
# two LM steps; PCG at 250-450 and 600-800 ms
HOST = [
    ("xrsfm.ba.solve", 100, 900), ("xrsfm.ba.lm_step", 150, 500),
    ("xrsfm.ba.schur", 200, 250), ("xrsfm.ba.pcg", 250, 450),
    ("xrsfm.ba.pcg.capture", 260, 300), ("xrsfm.ba.lm_step", 500, 850),
    ("xrsfm.ba.pcg", 600, 800),
    call("cudaLaunchKernel", 210),  # in the Schur setup: not counted
    call("cudaLaunchKernel", 255), call("cudaMemsetAsync", 258),
    call("cudaLaunchKernelExC", 270), call("cuLaunchKernel", 280),
    call("cudaGraphLaunch", 310), call("cudaGraphLaunch", 330),
    call("cudaMemcpyAsync", 331), call("cudaStreamSynchronize", 332),
    call("cudaGraphInstantiateWithFlags", 300),  # not a launch
    call("cudaLaunchKernel", 605), call("cudaGraphLaunch", 640),
    call("cudaLaunchKernel", 820),  # the candidate's cost: not counted
]


def read(trace, unit):
    run = types.SimpleNamespace(trace=trace, trace_unit=unit)
    return spec.metric_reader("pcg_launches_per_iter.bal")(run)


def test_launches_inside_pcg_over_iterations():
    assert read(trace_of(DEV, HOST), {"cg_iters": 3}) == pytest.approx(8 / 3)


def test_none_without_trace_spans_or_iterations():
    t = trace_of(DEV, HOST)
    assert read(None, {"cg_iters": 3}) is None
    assert read(t, {"cg_iters": 0}) is None
    assert read(t, {}) is None
    assert read(trace_of([], HOST), {"cg_iters": 3}) is None  # no card
    bare = [e for e in HOST if not e[0].startswith("xrsfm.")]
    assert read(trace_of(DEV, bare), {"cg_iters": 3}) is None
