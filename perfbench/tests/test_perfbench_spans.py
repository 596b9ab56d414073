"""lib/spans.py and the seven readers of the program's spans on hand-built
traces with known device intervals, host spans and runtime waits: the
exact numbers they return, and None where the trace or the spans are
absent.  On the card (marker cuda; skips elsewhere): one local BA solve
and one 8-frame pass under lib/tracing.capture put no xrsfm.* event on the
device's timeline, nest their spans, start each PCG stop test's copy
inside its span, and launch the row kernels as often as optim/ba.LAUNCHES
counts."""

import types

import numpy as np
import pytest

from perfbench.lib import spans, spec, tracing

MS = 1_000_000  # ns: the hand-built timelines count in milliseconds


def trace_of(dev, host, window_s):
    """A Trace from (name, start_ms, end_ms) tuples of the device and of the
    host."""
    names = []
    ids = {}

    def arrays(evs):
        n, s, d = [], [], []
        for name, a, b in evs:
            if name not in ids:
                ids[name] = len(names)
                names.append(name)
            n.append(ids[name])
            s.append(round(a * MS))
            d.append(round(b * MS) - round(a * MS))
        return tuple(np.asarray(x, np.int64) for x in (n, s, d))

    return tracing.Trace(names, arrays(dev), arrays(host), window_s)


def wait(name, t):
    return (name, t, t + 1)


# a pass: matching 0-300 ms, the mapper 300-1000 ms; the device busy
# 100-250 ms (two overlapping kernels) and 600-700 ms
PASS_DEV = [("kernel_a", 100, 200), ("kernel_b", 150, 250),
            ("Memcpy DtoH (Device -> Pageable)", 600, 700)]
PASS_HOST = [
    ("perfbench.match", 0, 300), ("xrsfm.match", 10, 290),
    ("xrsfm.match.pairs", 20, 150), ("xrsfm.match.verify", 150, 280),
    ("perfbench.reconstruct", 300, 1000), ("xrsfm.reconstruct", 300, 1000),
    ("xrsfm.mapper", 310, 990),
    ("xrsfm.mapper.select", 320, 400), ("xrsfm.mapper.register", 400, 500),
    ("xrsfm.mapper.consistency", 500, 520),
    ("xrsfm.mapper.triangulate", 520, 580),
    ("xrsfm.mapper.filter", 580, 600), ("xrsfm.mapper.merge", 600, 650),
    ("xrsfm.mapper.lba", 650, 800), ("xrsfm.mapper.polish", 900, 980),
    wait("cudaStreamSynchronize", 50), wait("cudaLaunchKernel", 60),
    wait("cudaStreamSynchronize", 280), wait("cudaStreamSynchronize", 450),
    wait("cudaMemcpyAsync", 690), wait("cudaStreamSynchronize", 700),
    wait("cudaStreamSynchronize", 995),
    ("cudaDeviceSynchronize", 1000, 1010)]

# a solve: 100-900 ms, two LM steps; the device busy 160-190, 260-320,
# 620-700 and 720-730 ms
SOLVE_DEV = [("rows_kernel", 160, 190), ("k", 260, 300), ("k", 300, 320),
             ("k", 620, 700), ("k", 720, 730)]
SOLVE_HOST = [
    ("perfbench.solve", 100, 900), ("xrsfm.ba.solve", 100, 900),
    ("xrsfm.ba.cost", 110, 150),
    ("xrsfm.ba.lm_step", 150, 500), ("xrsfm.ba.rows", 150, 200),
    ("xrsfm.ba.schur", 200, 250), ("xrsfm.ba.pcg", 250, 450),
    ("xrsfm.ba.cost", 450, 500),
    ("xrsfm.ba.lm_step", 500, 850), ("xrsfm.ba.rows", 500, 550),
    ("xrsfm.ba.schur", 550, 600), ("xrsfm.ba.pcg", 600, 800),
    ("xrsfm.ba.cost", 800, 850),
    wait("cudaEventSynchronize", 50), wait("cudaMemcpy", 120),
    wait("cudaStreamSynchronize", 300), wait("cudaStreamSynchronize", 440),
    wait("cudaStreamSynchronize", 790), wait("cudaStreamSynchronize", 845),
    wait("cudaDeviceSynchronize", 950)]


def run_of(trace, unit):
    return types.SimpleNamespace(trace=trace, trace_unit=unit)


def pass_run(host=PASS_HOST, dev=PASS_DEV):
    return run_of(trace_of(dev, host, 1.0), {"frames": 4})


def solve_run(host=SOLVE_HOST, dev=SOLVE_DEV):
    return run_of(trace_of(dev, host, 0.8),
                  {"lm_iters": 2, "spans": {"solve": 0.8}})


def read(name, run):
    return spec.metric_reader(name)(run)


def test_intervals_idle_and_waits():
    t = pass_run().trace
    s, e = spans.intervals(t, "xrsfm.")
    assert s.tolist() == [10 * MS, 300 * MS]
    assert e.tolist() == [290 * MS, 1000 * MS]
    assert spans.intervals(t, "xrsfm.nothing") is None
    assert spans.span_s(t, "xrsfm.mapper.lba") == pytest.approx(0.15)
    # 20-150 ms with 100-150 busy; 150-280 with 150-250 busy
    assert spans.idle_s(t, "xrsfm.match.pairs") == pytest.approx(0.08)
    assert spans.idle_s(t, ("xrsfm.match.pairs", "xrsfm.match.verify")) \
        == pytest.approx(0.11)
    assert spans.idle_s(t, "xrsfm.nothing") is None
    assert spans.waits(t, "xrsfm.match") == 2
    assert spans.waits(t, "xrsfm.mapper") == 2
    assert spans.waits(t, "xrsfm.reconstruct") == 3
    assert spans.waits(t, "xrsfm.") == 5
    assert spans.waits(t, "xrsfm.nothing") is None
    # the unit: 0-1010 ms, busy 250 ms of it
    assert spans.unit_idle_s(t) == pytest.approx(0.76)


def test_pass_readers():
    run = pass_run()
    assert read("register_idle_pct.seq", run) == pytest.approx(20.0)
    assert read("tracks_idle_pct.seq", run) == pytest.approx(8.0)
    assert read("mapper_ba_idle_pct.seq", run) == pytest.approx(18.0)
    assert read("mapper_waits_per_frame.seq", run) == pytest.approx(0.75)
    assert read("match_waits_per_frame.seq", run) == pytest.approx(0.5)


def test_solve_readers():
    run = solve_run()
    # PCG 250-450 and 600-800 ms: 400 ms, busy 60 + 80 + 10 of it
    assert read("pcg_idle_pct.bal", run) == pytest.approx(62.5)
    # cudaMemcpy at 120 and four stream synchronisations inside the solve
    assert read("waits_per_lm.bal", run) == pytest.approx(2.5)


def test_coverage_lines(capsys):
    read("register_idle_pct.seq", pass_run())
    err = capsys.readouterr().err
    assert "spans hold 0.730000 s of the traced unit's 0.760000 s device " \
        "idle (96.05%)" in err
    read("pcg_idle_pct.bal", solve_run())
    err = capsys.readouterr().err
    # the solve 100-900 ms idles 620 ms; the start's cost and the LM
    # steps' spans, 110-850 ms, hold 560 of it
    assert "xrsfm.ba.rows|xrsfm.ba.schur|xrsfm.ba.pcg|xrsfm.ba.cost hold " \
        "0.560000 s of the 0.620000 s inside xrsfm.ba.solve (90.32%)" in err



def test_device_clock_put_on_the_host_clock(capsys):
    """The device 50 ms late in the trace: each fetch (the host asks for a
    copy at 60 / 160 ms and waits until 70 / 170 ms, the copy lasting the
    last millisecond) puts it back, so that each span holds its own
    kernel; with a copy lost the times are used as they are."""
    late = 50
    copy = "Memcpy DtoH (Device -> Pageable)"
    dev = [("kernel", 40 + late, 60 + late), (copy, 69 + late, 70 + late),
           ("kernel", 140 + late, 160 + late), (copy, 169 + late, 170 + late)]
    host = [("xrsfm.a", 0, 100), ("xrsfm.b", 100, 200),
            ("cudaMemcpyAsync", 60, 60.01),
            ("cudaStreamSynchronize", 60.02, 70),
            ("cudaMemcpyAsync", 160, 160.01),
            ("cudaStreamSynchronize", 160.02, 170)]
    t = trace_of(dev, host, 0.2)
    at, off = spans.clock_offsets(t)
    assert at.tolist() == [120 * MS, 220 * MS]
    assert off.tolist() == [late * MS, late * MS]
    assert (spans.aligned(t) == t.dev_start - late * MS).all()
    assert spans.idle_s(t, "xrsfm.a") == pytest.approx(0.079)
    assert spans.idle_s(t, "xrsfm.b") == pytest.approx(0.079)
    spans.print_coverage(t)
    assert "device clock put on the host's at 2 fetches, offsets 50000.0 " \
        "to 50000.0 us" in capsys.readouterr().err
    lost = trace_of(dev[:-1], host, 0.2)
    assert spans.clock_offsets(lost) is None
    assert (spans.aligned(lost) == lost.dev_start).all()
    # as they are: 90-110 ms of the first kernel and 119-120 ms of its copy
    # fall in b
    assert spans.idle_s(lost, "xrsfm.a") == pytest.approx(0.09)

PASS = ("register_idle_pct.seq", "tracks_idle_pct.seq",
        "mapper_ba_idle_pct.seq", "mapper_waits_per_frame.seq",
        "match_waits_per_frame.seq")
SOLVE = ("pcg_idle_pct.bal", "waits_per_lm.bal")


def test_none_without_trace_or_spans():
    no_spans = [e for e in PASS_HOST if not e[0].startswith("xrsfm.")]
    no_solve_spans = [e for e in SOLVE_HOST if not e[0].startswith("xrsfm.")]
    for names, make, bare in ((PASS, pass_run, no_spans),
                              (SOLVE, solve_run, no_solve_spans)):
        for name in names:
            assert read(name, run_of(None, None)) is None, name
            assert read(name, make(host=bare)) is None, name
            assert read(name, make(dev=[])) is None, name  # no card


# --- on the card -------------------------------------------------------------

SEED = 2147483747
PARENT = {"xrsfm.ba.lm_step": "xrsfm.ba.solve",
          "xrsfm.ba.rows": "xrsfm.ba.lm_step",
          "xrsfm.ba.schur": "xrsfm.ba.lm_step",
          "xrsfm.ba.pcg": "xrsfm.ba.lm_step",
          "xrsfm.match.pairs": "xrsfm.match",
          "xrsfm.match.verify": "xrsfm.match",
          "xrsfm.reconstruct.load": "xrsfm.reconstruct",
          "xrsfm.reconstruct.write": "xrsfm.reconstruct",
          "xrsfm.mapper": "xrsfm.reconstruct"}


def _parent(name):
    if name in PARENT:
        return PARENT[name]
    if name.startswith("xrsfm.mapper."):
        return "xrsfm.mapper"
    return None


def _inside(times, iv):
    """How many of times lie inside the sorted disjoint intervals iv."""
    times = np.asarray(times, np.int64)
    k = np.searchsorted(iv[0], times, side="right") - 1
    return int(((k >= 0) & (times < iv[1][np.maximum(k, 0)])).sum())


def card_check(cell):
    """One unit of the cell (the pipeline's at 8 frames) after a warm one,
    under lib/tracing.capture as the first profile of this process, as in
    a run of the benchmark; raises AssertionError where a check fails."""
    import json
    import sys
    import tempfile

    import torch

    from perfbench.lib import harness
    from xrsfm_tpu_torch.optim import ba as BA

    c = spec.Cell(cell)
    config = dict(c.config)
    if c.traffic["driver"] == "pipeline":
        config["n_frames"] = 8
    dev = torch.device("cuda:0")
    drv = spec.driver_class(c.traffic["driver"])(c, config, SEED, dev,
                                                 tempfile.mkdtemp())
    with harness.quiet():
        drv.setup()
        drv.unit()  # builds the kernels and warms the shapes
        l0 = dict(BA.LAUNCHES)
        unit, t = tracing.capture(drv.unit, dev)
    names = t.names
    # (a) nothing of the program's on the device's timeline
    assert not [n for n in t.dev_name.tolist()
                if names[n].startswith("xrsfm.")]
    # (b) every span a host event, inside its parent
    ev = [(names[n], s, s + d) for n, s, d in
          zip(t.host_name.tolist(), t.host_start.tolist(),
              t.host_dur.tolist()) if names[n].startswith("xrsfm.")]
    got = {e[0] for e in ev}
    want = ({"xrsfm.ba.solve", "xrsfm.ba.lm_step", "xrsfm.ba.pcg"}
            if "lba" in cell else {"xrsfm.extract", "xrsfm.match",
                                   "xrsfm.mapper.lba", "xrsfm.ba.pcg"})
    assert want <= got, got
    for name, s, e in ev:
        p = _parent(name)
        if p is not None:
            assert any(q[0] == p and q[1] <= s and e <= q[2] for q in ev), \
                (name, s, e)
    # (c) the k-th copy the host asked for is the k-th the device ran,
    # each blocking fetch's copy fits inside the host's wait for it, and
    # on the host's clock the copy of each PCG stop test starts inside
    # the span whose host call asked for it
    host_copy = np.sort(t.host_start[np.isin(t.host_name, [
        i for i, n in enumerate(names) if n.startswith("cudaMemcpy")])])
    is_copy = np.isin(t.dev_name, [i for i, n in enumerate(names)
                                   if n.startswith("Memcpy")])
    o = np.argsort(t.dev_start[is_copy], kind="stable")
    assert len(host_copy) == int(is_copy.sum()) > 0
    pts = spans.clock_offsets(t)
    assert pts is not None and len(pts[0]) >= unit["cg_iters"]
    start_on_host = spans.aligned(t)[is_copy][o]
    pcg = spans.intervals(t, "xrsfm.ba.pcg")
    asked = np.zeros(len(host_copy), bool)
    k = np.searchsorted(pcg[0], host_copy, side="right") - 1
    asked = (k >= 0) & (host_copy < pcg[1][np.maximum(k, 0)])
    n_asked = int(asked.sum())
    assert n_asked >= unit["cg_iters"] > 0
    assert _inside(start_on_host[asked], pcg) == n_asked
    raw = _inside(t.dev_start[is_copy][o][asked], pcg)
    # (d) the row kernels in the trace, against the wrappers' counts
    by = {}
    for n in t.dev_name.tolist():
        key = tracing.short_name(names[n])
        by[key] = by.get(key, 0) + 1
    cam = BA.LAUNCHES["ba_cam_rows_cuda"] - l0["ba_cam_rows_cuda"]
    pt = BA.LAUNCHES["ba_pt_rows_cuda"] - l0["ba_pt_rows_cuda"]
    assert cam > 0 and pt > 0
    assert by.get("rows_kernel", 0) == by.get("cams_kernel", 0) == cam
    assert by.get("pt_rows_kernel", 0) == pt
    print("CARD " + json.dumps({
        "cell": cell, "fetches": len(pts[0]),
        "offset_us": [float(pts[1].min()) / 1e3, float(pts[1].max()) / 1e3],
        "pcg_copies": n_asked, "pcg_copies_inside_raw": raw,
        "cam_rows_calls": cam, "pt_rows_calls": pt}), file=sys.stderr)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bal-dubrovnik356.lba",
                                  "kitti-corridor48.pipeline"])
def test_spans_on_the_card(cell):
    """card_check in a fresh interpreter: the benchmark profiles once a
    process, and a profile after earlier ones in a process loses device
    events on the card (utils/profiling.dispatch_counter)."""
    import os
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = ("import runpy, sys; sys.path.insert(0, '.'); runpy.run_path("
            f"{os.path.abspath(__file__)!r})['card_check']({cell!r})")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    card = [ln for ln in out.stderr.splitlines() if ln.startswith("CARD ")]
    print("\n".join(card))
    assert out.returncode == 0, out.stderr[-3000:]
