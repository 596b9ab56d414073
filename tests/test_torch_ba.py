"""The port's bundle adjuster (xrsfm_tpu_torch.optim.ba) against the JAX
package's COO path (xrsfm_tpu/optim/ba.py: solve_ba(prob, opts) with
ell=None, float32), on the same seeded numpy problems, on the CPU.

The JAX mapper solves through the camera-major ELL layout with bf16 Schur
operands; the port solves the COO layout in float32, so it is held to
JAX's COO solver here, and to outcomes at the mapper level."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from xrsfm_tpu.optim import ba as JB
from xrsfm_tpu_torch.optim import ba as TB
from xrsfm_tpu_torch.utils import camera as TC
from xrsfm_tpu_torch.utils import geometry as TG
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

# the fields every problem has (the intrinsics metadata is optional)
_FIELDS = [f.name for f in dataclasses.fields(TB.BAProblem)
           if f.default is dataclasses.MISSING]


def _problem(seed=0, n_cams=12, n_pts=300, distorted=True):
    """bench.make_ba_problem's generator at a small size, with OPENCV
    distortion, some frozen points and a few zero-weight and
    behind-the-camera observations."""
    d = synth.ba_problem(n_cams=n_cams, n_pts=n_pts, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if distorted:
        d["cam_intri"][:, 4:] = [-0.05, 0.01, 1e-3, -5e-4]
    d["fix_pt"][rng.choice(n_pts, n_pts // 10, replace=False)] = True
    d["obs_w"][rng.choice(len(d["obs_w"]), 5, replace=False)] = 0.0
    d["points"][:3, 2] -= 200.0  # behind every camera: cheirality guard
    return d


def _jax(d):
    return JB.BAProblem(**{k: jnp.asarray(d[k]) for k in _FIELDS})


def _port(d):
    return TB.BAProblem.from_numpy("cpu", **d)


def test_residuals_and_jacobians_match_jax():
    """Residuals within 1e-4 px (float32 pixels ~600: a few ulps), depths
    within 1e-4, Jacobians within 1e-4 relative to their largest entry."""
    d = _problem()
    r_t, z_t, Jc_t, Jp_t = (a.numpy() for a in
                            TB._residuals_and_jacobians(_port(d)))
    r_j, z_j, Jc_j, Jp_j = (np.asarray(a) for a in
                            jax.jit(JB._residuals_and_jacobians)(_jax(d)))
    np.testing.assert_allclose(r_t, r_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(z_t, z_j, atol=1e-4, rtol=0)
    for a, b in ((Jc_t, Jc_j), (Jp_t, Jp_j)):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), rtol=0)


def test_jacobians_match_autodiff():
    """The analytic Jacobians against torch.func.jacfwd of the residual of
    one observation under a 9-dof perturbation (6 pose + 3 point), within
    1e-3 relative to the largest entry."""
    d = _problem(seed=2, n_cams=6, n_pts=60)
    p = _port(d)
    _, _, Jc, Jp = TB._residuals_and_jacobians(p)

    def res(delta9, q, t, intri, uv, xyz):
        q2, t2 = TG.pose_retract(q, t, delta9[:6])
        xy, _ = TC.project(intri, q2, t2, xyz + delta9[6:])
        return xy - uv

    J = torch.func.vmap(torch.func.jacfwd(res))(
        torch.zeros(len(d["obs_cam"]), 9), p.cam_q[p.obs_cam],
        p.cam_t[p.obs_cam], p.cam_intri[p.obs_cam], p.obs_uv,
        p.points[p.obs_pt])
    front = (TB._residuals_only(p)[1] > 1e-3).numpy()
    for got, exp in ((Jc, J[..., :6]), (Jp, J[..., 6:])):
        got, exp = got.numpy()[front], exp.numpy()[front]
        np.testing.assert_allclose(got, exp, atol=1e-3 * np.abs(exp).max(),
                                   rtol=0)


def test_robust_cost_and_normal_blocks_match_jax():
    """Huber cost and IRLS weights (cheirality guard and zero-weight rows
    included) within 1e-5 relative; the gauge-masked normal blocks U, V,
    W, bc, bp within 1e-4 relative to each block's largest entry."""
    d = _problem(seed=3)
    pt, pj = _port(d), _jax(d)
    r, z, Jc, Jp = TB._residuals_and_jacobians(pt)
    c_t, w_t = TB._robust_cost_and_weight(r, z, pt.obs_w, 4.0)
    rj, zj, Jcj, Jpj = JB._residuals_and_jacobians(pj)
    c_j, w_j = JB._robust_cost_and_weight(rj, zj, pj.obs_w, 4.0)
    assert float(c_t) == pytest.approx(float(c_j), rel=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5)
    assert (w_t.numpy() == 0).sum() >= 5
    got = TB._build_normal_blocks(pt, r, Jc, Jp, w_t)
    exp = jax.jit(JB._build_normal_blocks)(pj, rj, Jcj, Jpj, w_j)
    for name, a, b in zip(("U", "V", "W", "bc", "bp"), got, exp):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("cg_iters", [2, 15])
def test_solve_ba_matches_jax_coo(cg_iters):
    """LM on a 20-camera, 500-point problem (bench settings: Huber 4 px,
    lambda0 1e-4, 10 iterations): initial and final cost within rtol 1e-3
    of the JAX package's COO solve (observed 2e-7), iteration counts
    equal, rotations within 1e-4, translations (up to 200 units) within
    1e-4 + 1e-5 relative and points within 1e-3 (observed 2e-8, 6e-6
    relative and 4e-4)."""
    d = synth.ba_problem(n_cams=20, n_pts=500, seed=0)
    opts = dict(max_iters=10, cg_iters=cg_iters, huber_px=4.0, lam_init=1e-4)
    sj, ij = JB.solve_ba(_jax(d), JB.BAOptions(**opts))
    st, it = TB.solve_ba(_port(d), TB.BAOptions(**opts))
    for k in ("initial_cost", "final_cost"):
        assert it[k] == pytest.approx(float(ij[k]), rel=1e-3), k
    assert it["final_cost"] < 0.1 * it["initial_cost"]
    assert it["iters"] == int(ij["iters"])
    for a, b, atol, rtol in ((st.cam_q, sj.cam_q, 1e-4, 0),
                             (st.cam_t, sj.cam_t, 1e-4, 1e-5),
                             (st.points, sj.points, 1e-3, 0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=rtol)


def test_frozen_parameters_stay_bit_unchanged():
    """Frozen cameras keep q and t, translation-frozen cameras keep t, and
    frozen points keep their coordinates, bit for bit; the free ones
    move."""
    d = _problem(seed=4, distorted=False)
    d["fix_cam"][[0, 5]] = True
    d["fix_trans"][[1, 7]] = True
    p = _port(d)
    sol, info = TB.solve_ba(p, TB.BAOptions(max_iters=8, huber_px=4.0))
    assert info["final_cost"] < info["initial_cost"]
    fc, ft, fp = d["fix_cam"], d["fix_cam"] | d["fix_trans"], d["fix_pt"]
    assert torch.equal(sol.cam_q[fc], p.cam_q[fc])
    assert torch.equal(sol.cam_t[ft], p.cam_t[ft])
    assert torch.equal(sol.points[fp], p.points[fp])
    assert not torch.equal(sol.cam_q[~fc], p.cam_q[~fc])
    assert not torch.equal(sol.cam_t[~ft], p.cam_t[~ft])
    assert not torch.equal(sol.points[~fp], p.points[~fp])


def test_solve_counts_by_device():
    d = synth.ba_problem(n_cams=8, n_pts=100, seed=5)
    TB.reset_counts()
    _, info = TB.solve_ba(_port(d), TB.BAOptions(max_iters=3))
    assert TB.COUNTS["solves_cpu"] == 1 and TB.COUNTS["solves_cuda"] == 0
    assert TB.COUNTS["lm_iters"] == info["iters"] > 0
    assert TB.COUNTS["cg_iters"] > 0


def test_ba_problem_generator_matches_bench():
    """synth.ba_problem draws bench.make_ba_problem's problem: at a small
    size, the same observations, points and cameras as the JAX helper's
    camera-major packed table holds."""
    import bench

    prob, ell, n_obs = bench.make_ba_problem(n_cams=20, n_pts=500, seed=0,
                                             cam_width=16, pt_width=8)
    d = synth.ba_problem(n_cams=20, n_pts=500, seed=0)
    assert n_obs == len(d["obs_cam"])
    live = np.asarray(prob.obs_w) > 0
    # the packed table holds the same (camera, point, pixel) rows
    got = sorted(zip(np.asarray(prob.obs_cam)[live].tolist(),
                     np.asarray(prob.obs_pt)[live].tolist(),
                     np.asarray(prob.obs_uv)[live, 0].tolist()))
    exp = sorted(zip(d["obs_cam"].tolist(), d["obs_pt"].tolist(),
                     d["obs_uv"][:, 0].tolist()))
    assert got == exp
    np.testing.assert_array_equal(np.asarray(prob.points), d["points"])
    np.testing.assert_array_equal(np.asarray(prob.cam_t), d["cam_t"])


@pytest.mark.slow
def test_bench_size_cost_matches_jax_coo():
    """bench.py's 140k-observation problem (30 iterations, cg 2, Huber 4,
    lambda0 1e-4): the port's final cost within rtol 1e-3 of the JAX COO
    solve's (54,267.0 on this host) and inside chip_smoke.py's band."""
    import chip_smoke

    d = synth.ba_problem(seed=0)
    opts = dict(max_iters=30, cg_iters=2, huber_px=4.0, lam_init=1e-4)
    _, ij = JB.solve_ba(_jax(d), JB.BAOptions(**opts))
    _, it = TB.solve_ba(_port(d), TB.BAOptions(**opts))
    assert it["final_cost"] == pytest.approx(float(ij["final_cost"]), rel=1e-3)
    lo, hi = chip_smoke.BA_COST_BAND
    assert lo <= it["final_cost"] <= hi
