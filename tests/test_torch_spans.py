"""The port's spans (utils/profiling.span) on torch.profiler's clock, on the
CPU: nested spans are host events of the profiler's trace with the right
names, nesting and seconds and add nothing else to it; a mapper run on
tests/test_torch_mapper.py's scene opens a span for every phase that ran,
and each MapperStats.time_* is the sum of its spans' seconds; one
solve_ba opens one xrsfm.ba.lm_step an LM iteration, each holding one
rows, schur, pcg and cost span."""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from synthetic import make_scene
from test_torch_mapper import build_map
from xrsfm_tpu_torch.base.map import SfMMap as TMap
from xrsfm_tpu_torch.mapper import IncrementalMapper, MapperOptions
from xrsfm_tpu_torch.mapper import incremental
from xrsfm_tpu_torch.optim import ba as TB
from xrsfm_tpu_torch.utils import synth
from xrsfm_tpu_torch.utils.profiling import span

torch.set_num_threads(2)


def _traced(fn):
    """fn() under a CPU profile: its host events as (name, start_ns,
    end_ns, user annotation), in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
           e.is_user_annotation())
          for e in prof.profiler.kineto_results.events()]
    return sorted(ev, key=lambda e: (e[1], -e[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _work():
    x = torch.ones(256) * 2.0
    time.sleep(0.02)
    return float(x.sum())


def test_spans_are_host_events_that_nest():
    made = {}

    def spanned():
        with span("xrsfm.test.outer") as made["outer"]:
            with span("xrsfm.test.inner") as made["inner"]:
                _work()
        with pytest.raises(KeyError):
            with span("xrsfm.test.raises") as made["raises"]:
                raise KeyError("closes on the way out")

    plain = collections.Counter(e[0] for e in _traced(_work))
    ev = _traced(spanned)
    got = collections.Counter(e[0] for e in ev)
    assert got - plain == collections.Counter(
        {"xrsfm.test.outer": 1, "xrsfm.test.inner": 1,
         "xrsfm.test.raises": 1})
    assert not plain - got
    by = {e[0]: e for e in ev if e[0].startswith("xrsfm.")}
    assert not any(e[3] for e in by.values())  # no user annotation
    assert _inside(by["xrsfm.test.inner"], by["xrsfm.test.outer"])
    assert by["xrsfm.test.inner"][2] <= by["xrsfm.test.raises"][1]
    for e in ev:  # the work's operations lie inside the inner span
        if not e[0].startswith("xrsfm."):
            assert _inside(e, by["xrsfm.test.inner"]), e
    outer, inner = made["outer"], made["inner"]
    assert outer.seconds >= inner.seconds >= 0.02
    for sp in (outer, inner):
        trace_s = (by[sp.name][2] - by[sp.name][1]) * 1e-9
        assert abs(trace_s - sp.seconds) < 5e-3, (sp.name, trace_s)
    # without a profiler a span still times its block
    with span("xrsfm.test.untraced") as sp:
        time.sleep(0.01)
    assert sp.seconds >= 0.01


# MapperStats field -> the mapper phase spans its seconds sum
_FIELDS = {
    "time_init": ("init",), "time_select": ("select",),
    "time_register": ("register",), "time_consistency": ("consistency",),
    "time_check": ("correct",), "time_triangulate": ("triangulate",),
    "time_filter": ("filter",), "time_merge": ("merge",),
    "time_lba": ("lba",), "time_gba": ("gba", "polish"),
}


def test_mapper_phase_spans_give_mapper_stats(monkeypatch):
    """make_scene's 6 cameras: every phase that runs on it has its spans in
    the trace, inside xrsfm.mapper; each MapperStats.time_* is the sum of
    the seconds of its spans, time_total the seconds of xrsfm.mapper; the
    BA glue's spans lie inside the init, LBA, GBA and polish phases."""
    made = []

    def recording(name):
        made.append(span(name))
        return made[-1]

    monkeypatch.setattr(incremental, "span", recording)
    m = build_map(TMap, make_scene(n_cams=6, n_pts=150, seed=20, noise=0.0))
    mapper = IncrementalMapper(MapperOptions(verbose=False), device="cpu")
    out = {}
    ev = _traced(lambda: out.update(ok=mapper.reconstruct(m)))
    assert out["ok"] and int(np.count_nonzero(m.registered)) == 6

    phases = [e for e in ev if e[0].startswith("xrsfm.mapper")]
    assert collections.Counter(e[0] for e in phases) == \
        collections.Counter(s.name for s in made)
    ran = {s.name.split(".")[-1] for s in made}
    assert ran >= {"mapper", "init", "select", "register", "consistency",
                   "triangulate", "filter", "merge", "lba", "gba", "polish"}
    whole = [e for e in phases if e[0] == "xrsfm.mapper"]
    assert len(whole) == 1
    assert all(_inside(e, whole[0]) for e in phases)

    st = mapper.stats
    for field, names in _FIELDS.items():
        total = 0.0
        for s in made:
            if s.name.split(".")[-1] in names:
                total = total + s.seconds
        assert getattr(st, field) == pytest.approx(total, rel=1e-12,
                                                   abs=1e-15), field
    assert st.time_total == [s.seconds for s in made
                             if s.name == "xrsfm.mapper"][0]

    hosts = [e for e in phases if e[0].split(".")[-1]
             in ("init", "lba", "gba", "polish")]
    glue = [e for e in ev if e[0] in ("xrsfm.ba.build", "xrsfm.ba.solve",
                                      "xrsfm.ba.fetch", "xrsfm.ba.writeback")]
    assert glue and all(any(_inside(g, h) for h in hosts) for g in glue)


@pytest.mark.parametrize("layout", ["rows", "coo"])
def test_each_lm_iteration_is_one_lm_step_span(layout):
    """One CPU solve_ba: COUNTS["lm_iters"] xrsfm.ba.lm_step spans inside
    xrsfm.ba.solve, each holding exactly one rows, schur, pcg and cost
    span in that order; one more cost span (the start's) before the
    first step; the pack's span where the problem was packed."""
    d = synth.ba_problem(n_cams=12, n_pts=300, seed=0)
    opts = TB.BAOptions(max_iters=6)
    out = {}

    def solve():
        p = TB.BAProblem.from_numpy("cpu", **d)
        ell = None
        if layout == "rows":
            p, ell = TB.pack_camera_major(p)
        n0 = TB.COUNTS["lm_iters"]
        out["res"] = TB.solve_ba(p, opts, ell)
        out["iters"] = TB.COUNTS["lm_iters"] - n0

    ev = _traced(solve)
    ba = [e for e in ev if e[0].startswith("xrsfm.")]
    names = collections.Counter(e[0] for e in ba)
    n = out["iters"]
    assert n == out["res"][1]["iters"] and n >= 2
    assert names["xrsfm.ba.pack"] == (layout == "rows")
    assert names["xrsfm.ba.solve"] == 1
    assert names["xrsfm.ba.lm_step"] == n
    for k in ("rows", "schur", "pcg"):
        assert names[f"xrsfm.ba.{k}"] == n, k
    assert names["xrsfm.ba.cost"] == n + 1
    solve_ev = [e for e in ba if e[0] == "xrsfm.ba.solve"][0]
    steps = [e for e in ba if e[0] == "xrsfm.ba.lm_step"]
    inner = [e for e in ba if e[0].split(".")[-1]
             in ("rows", "schur", "pcg", "cost")]
    assert all(_inside(e, solve_ev) for e in steps + inner)
    assert inner[0][0] == "xrsfm.ba.cost" and inner[0][2] <= steps[0][1]
    for st in steps:
        kids = [e[0].split(".")[-1] for e in inner if _inside(e, st)]
        assert kids == ["rows", "schur", "pcg", "cost"], kids
