"""The port's benchmark drivers (xrsfm_tpu_torch/tools/bench.py and
tools/e2e_bench.py) against the JAX repo's bench.py and
scripts/e2e_bench.py, on the CPU at small sizes: the LM step against the
same composition of the JAX package's COO functions, the matcher's and
SIFT's inputs and outputs against what bench.py feeds the JAX package,
and both JSON lines' keys against the scripts'."""

import ast
import dataclasses
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrsfm_tpu.ops import matching as JM
from xrsfm_tpu.ops import sift as JS
from xrsfm_tpu.optim import ba as JB
from xrsfm_tpu_torch.device import full_precision
from xrsfm_tpu_torch.ops.sift import SiftExtractor
from xrsfm_tpu_torch.optim import ba as TB
from xrsfm_tpu_torch.tools import bench as TBENCH
from xrsfm_tpu_torch.tools import e2e_bench as TE2E
from xrsfm_tpu_torch.tools.profile_sift import bench_image
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fields every BA problem has (the intrinsics metadata and fix_rot are
# optional)
_FIELDS = [f.name for f in dataclasses.fields(TB.BAProblem)
           if f.default is dataclasses.MISSING]


def _jax_bench():
    """The repo's bench.py as a module (its jax imports are local to its
    functions)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@jax.jit
def _jax_lm_step(p, lam):
    """bench.py's lm_step on the JAX package's COO functions."""
    r, z, Jc, Jp = JB._residuals_and_jacobians(p)
    cost, w = JB._robust_cost_and_weight(r, z, p.obs_w, 4.0)
    U, V, W, bc, bp = JB._build_normal_blocks(p, r, Jc, Jp, w)
    dx_c, dx_p = JB._schur_solve(p, U, V, W, bc, bp, lam, 2, 1e-2)
    cand = JB._apply_step(p, dx_c, dx_p)
    r2, z2 = JB._residuals_only(cand)
    c2, _ = JB._robust_cost_and_weight(r2, z2, p.obs_w, 4.0)
    accept = c2 < cost
    lam2 = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
    return (JB._select_accept(accept, p, cand), lam2,
            jnp.where(accept, c2, cost), accept)


def test_lm_step_matches_jax_coo_composition():
    """5 steps at cg 2 on a 12-camera, 600-point problem (seed 0): every
    accept decision and lambda equal, the cost within 1e-4 relative at
    every step; lm_run ends where the steps end."""
    d = synth.ba_problem(n_cams=12, n_pts=600, seed=0)
    pj = JB.BAProblem(**{k: jnp.asarray(d[k]) for k in _FIELDS})
    pt = TB.BAProblem.from_numpy("cpu", **d)
    lam_j = jnp.float32(1e-4)
    lam_t = torch.tensor(1e-4, dtype=torch.float32)
    p0, l0 = pt, lam_t
    with jax.default_matmul_precision("highest"), full_precision():
        for step in range(5):
            pj, lam_j2, cost_j, acc_j = _jax_lm_step(pj, lam_j)
            pt, lam_t2, cost_t = TBENCH.lm_step(pt, lam_t, 2)
            assert bool(lam_t2 < lam_t) == bool(acc_j), step
            assert float(lam_t2) == float(lam_j2), step
            assert abs(float(cost_t) - float(cost_j)) \
                <= 1e-4 * float(cost_j), (step, float(cost_t), float(cost_j))
            lam_j, lam_t = lam_j2, lam_t2
        _, lam_r, cost_r = TBENCH.lm_run(p0, l0, 5, 2)
    assert float(lam_r) == float(lam_t) and float(cost_r) == float(cost_t)


def test_bench_matching_equals_jax_bench(monkeypatch):
    """bench.py's bench_matching at (batch 2, 256 features) with the JAX
    package's match_descriptors_batch recorded: the port's inputs are the
    same bytes and its outputs equal JAX's fused path (Pallas in interpret
    mode), distances within 1e-7."""
    calls = []
    orig = JM.match_descriptors_batch

    def record(*args):
        out = orig(*args)
        calls.append(([np.asarray(a) for a in args],
                      [np.asarray(o) for o in out]))
        return out

    monkeypatch.setattr(JM, "match_descriptors_batch", record)
    _jax_bench().bench_matching(n_feats=256, batch=2, reps=1)
    (args_j, (mj, cj, dj)), = calls[-1:]
    d1, d2, m = TBENCH.matching_inputs(256, 2, 0)
    for a, b in zip(args_j, (d1, d2, m, m)):
        np.testing.assert_array_equal(a, b)
    assert JM._pallas_ok(256, 256, 128)
    rate, (mt, ct, dt) = TBENCH.bench_matching(n_feats=256, batch=2, reps=1,
                                               device="cpu")
    assert rate > 0
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(mt.numpy(), mj)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-7)


def test_bench_sift_input_and_count(monkeypatch):
    """bench.py's bench_sift with the JAX package's SiftExtractor replaced
    by a recorder: its image (5x5 box blur of seeded noise), options and
    batch are the port's; the port's keypoint count equals a direct
    extract_batch of the image."""
    seen = {}

    class Recorder:
        def __init__(self, opts):
            seen["opts"] = opts

        def extract_batch(self, imgs, batch):
            seen["imgs"], seen["batch"] = imgs, batch
            return [(np.zeros((3, 4), np.float32), None)] * len(imgs)

    monkeypatch.setattr(JS, "SiftExtractor", Recorder)
    _jax_bench().bench_sift(size=(96, 128), reps=1)
    img = bench_image(96, 128, seed=0)
    assert seen["batch"] == 16 and len(seen["imgs"]) == 16
    for a in seen["imgs"]:
        np.testing.assert_array_equal(a, img)
    for k in ("num_octaves", "features_per_octave", "max_features",
              "first_octave"):
        assert getattr(seen["opts"], k) == getattr(TBENCH.BENCH_SIFT, k), k
    rate, n_kp = TBENCH.bench_sift(size=(96, 128), reps=1, device="cpu")
    direct = SiftExtractor(TBENCH.BENCH_SIFT, device="cpu").extract_batch(
        [img], batch=1)[0][0]
    assert rate > 0 and n_kp == len(direct) > 0


def _stub(monkeypatch, mod, anchor, pairs):
    """The same figures from every measurement of a bench module
    (bench_matching returns pairs/s in bench.py, with the matches here)."""
    monkeypatch.setattr(mod, "bench_ba",
                        lambda *a, **k: (50.0, 1000, 123.456, 0.01))
    monkeypatch.setattr(mod, "bench_matching", lambda *a, **k: pairs)
    monkeypatch.setattr(mod, "bench_sift", lambda *a, **k: (5.0, 1200))
    monkeypatch.setattr(mod, "measure_cpu_anchor", lambda *a, **k: anchor)


@pytest.mark.parametrize("anchor", [2.5, None])
def test_run_benchmarks_keys_equal_bench_py(monkeypatch, capsys, anchor):
    """With every measurement stubbed, the port's JSON line has bench.py's
    keys less its tunnel fields, plus "device", and the same values and
    baseline kind."""
    jb = _jax_bench()
    _stub(monkeypatch, jb, anchor, 10.0)
    _stub(monkeypatch, TBENCH, anchor, (10.0, None))
    jb.run_benchmarks()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = TBENCH.run_benchmarks("cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    for k in ("tunnel_overhead_s", "tunnel_degraded"):
        del ref["secondary"][k]
    assert got.pop("device") == "cpu"
    assert got == ref


def test_cpu_anchor_failure_is_reported(capsys):
    """A child that gives no result returns None and says why on stderr."""
    assert TBENCH.measure_cpu_anchor(timeout_s=0.01) is None
    assert "cpu anchor" in capsys.readouterr().err


def _script_keys():
    """The keys of scripts/e2e_bench.py's JSON line: the `out` dict's,
    and those it adds under --count_dispatches."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "e2e_bench.py")).read())
    base, extra = [], []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        t = node.targets[0]
        if isinstance(t, ast.Name) and t.id == "out" \
                and isinstance(node.value, ast.Dict):
            base = [k.value for k in node.value.keys]
        elif isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                and t.value.id == "out":
            extra.append(t.slice.value)
    return base, extra


def test_e2e_bench_on_cpu(tmp_path):
    """8 corridor frames on the CPU, fresh with --count_dispatches and
    --steady: the script's keys letter for letter, 8/8 registered, a
    finite ATE, and null counts (the CPU launches nothing)."""
    base, extra = _script_keys()
    assert "ate_pct_span" in base and extra == ["dispatch_counts",
                                                "dispatch_top"]
    common = ["--device", "cpu", "--n_images", "8", "--workdir",
              str(tmp_path / "e2e")]
    fresh = TE2E.main(common + ["--count_dispatches"])
    steady = TE2E.main(common + ["--steady"])
    assert list(fresh) == base + extra and list(steady) == base
    assert fresh["mode"] == "fresh_process" and steady["mode"] == "steady"
    assert fresh["dispatch_counts"] is None and fresh["dispatch_top"] is None
    for out in (fresh, steady):
        assert out["registered"] == out["n_images"] == 8
        assert math.isfinite(out["ate_pct_span"])
        assert out["n_feats_mean"] > 0
        assert out["total_s"] == pytest.approx(
            out["extract_s"] + out["match_s"] + out["reconstruct_s"],
            abs=2e-3)


@pytest.mark.parametrize("name,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AUnaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, std::array<char*, 2ul> >(int, at::native::"
     "AUnaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, std::array<char*, 2ul>)",
     "vectorized_elementwise_kernel<4, AUnaryFunctor<float, float, float, "
     "MulFunctor<float> >, array<char*, 2ul> >"),
    ("void at::native::(anonymous namespace)::distribution_kernel<float, 4>"
     "(long, at::PhiloxCudaState, {lambda(int)#1})",
     "distribution_kernel<float, 4>"),
    ("topstats_kernel", "topstats_kernel"),
])
def test_dispatch_counter_short_kernel_names(name, short):
    """dispatch_top's keys: a kernel's name without "void", namespace
    qualifiers and its parameter list (names as torch.profiler gives
    them on an H100)."""
    from xrsfm_tpu_torch.utils.profiling import _short_name, dispatch_counter

    assert _short_name(name) == short
    with dispatch_counter("cpu") as c:
        pass
    assert c == {"dispatches": None, "fetches": None, "by_name": None}
