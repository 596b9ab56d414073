"""Rotation-frozen bundle adjustment (BAProblem.fix_rot,
ba_glue.build_problem / run_ba(freeze_rotations=)) in the port against the
JAX package, on the same seeded numpy problems and maps, on the CPU.

The JAX package masks the rotation columns of fix_rot cameras and zeroes
their rotation step, then re-normalizes every quaternion (a last-bit
change) and writes the map's quaternions back through float32.  The port
masks the same columns and keeps frozen quaternions bit for bit, in the
solver and in the map."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import _intri_problem, _perturb_intri
from test_torch_error_correct import _jax_map
from xrsfm_tpu.mapper import ba_glue as JG
from xrsfm_tpu.optim import ba as JB
from xrsfm_tpu_torch.base.map import SfMMap as TMap
from xrsfm_tpu_torch.mapper import ba_glue as TG
from xrsfm_tpu_torch.optim import ba as TB
from xrsfm_tpu_torch.parallel.mesh import Mesh
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

_FIELDS = [f.name for f in dataclasses.fields(TB.BAProblem)
           if f.default is dataclasses.MISSING]


def _rot_problem(seed=0):
    """bench.make_ba_problem's generator at 20 cameras and 500 points, with
    every rotation frozen but those of cameras 2 and 3, and their
    translations pushed off by 0.3 units so the translations have work."""
    d = synth.ba_problem(n_cams=20, n_pts=500, seed=seed)
    d["fix_rot"] = np.ones(20, bool)
    d["fix_rot"][[2, 3]] = False
    d["cam_t"] = d["cam_t"] + np.float32(0.3)
    return d


def test_rot_frozen_solve_matches_jax_coo():
    """LM with fix_rot against the JAX package's float32 COO solve (bench
    settings, 10 iterations): the port keeps the frozen quaternions bit
    for bit, JAX keeps them within 1e-6 (its re-normalization); the free
    rotations, translations, points and costs within
    test_torch_ba.test_solve_ba_matches_jax_coo's tolerances (costs rtol
    1e-3, rotations 1e-4, translations 1e-4 + 1e-5 relative, points
    1e-3); the frozen translation and camera stay put."""
    d = _rot_problem()
    opts = dict(max_iters=10, cg_iters=15, huber_px=4.0, lam_init=1e-4)
    pj = JB.BAProblem(**{k: jnp.asarray(d[k]) for k in _FIELDS},
                      fix_rot=jnp.asarray(d["fix_rot"]))
    sj, ij = JB.solve_ba(pj, JB.BAOptions(**opts))
    pt = TB.BAProblem.from_numpy("cpu", **d)
    assert pt.fix_rot.dtype == torch.bool
    st, it = TB.solve_ba(pt, TB.BAOptions(**opts))
    fr = d["fix_rot"] | d["fix_cam"]
    assert torch.equal(st.cam_q[fr], pt.cam_q[fr])
    np.testing.assert_allclose(np.asarray(sj.cam_q)[fr], d["cam_q"][fr],
                               atol=1e-6, rtol=0)
    assert not torch.equal(st.cam_q[~fr], pt.cam_q[~fr])
    for k in ("initial_cost", "final_cost"):
        assert it[k] == pytest.approx(float(ij[k]), rel=1e-3), k
    assert it["final_cost"] < 0.1 * it["initial_cost"]
    for a, b, atol, rtol in ((st.cam_q, sj.cam_q, 1e-4, 0),
                             (st.cam_t, sj.cam_t, 1e-4, 1e-5),
                             (st.points, sj.points, 1e-3, 0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=rtol)
    ft = d["fix_cam"] | d["fix_trans"]
    assert torch.equal(st.cam_t[ft], pt.cam_t[ft])


def test_rot_frozen_columns_are_masked():
    """The rotation columns of fix_rot cameras are zero in the masked
    Jacobian and in the normal blocks (their diagonal is the damping
    alone), on the pose-only and the 14-dof tangent; the JAX package's
    _colmask6 agrees."""
    d = _rot_problem(seed=3)
    pt = TB.BAProblem.from_numpy("cpu", **d)
    fr = torch.from_numpy(d["fix_rot"] | d["fix_cam"])
    for with_intri in (False, True):
        if with_intri:
            C = len(d["cam_q"])
            pt = dataclasses.replace(
                pt, cam_kam=torch.zeros(C, dtype=torch.int64),
                fix_intri=torch.zeros(C, 8, dtype=torch.bool),
                tie_f=torch.zeros(C, dtype=torch.bool))
        mask = TB._cam_colmask(pt, with_intri)
        assert mask.shape == (len(fr), 14 if with_intri else 6)
        assert torch.all(mask[fr, :3] == 0) and torch.all(mask[~fr, :3] == 1)
        r, z, Jc, Jp = TB._residuals_and_jacobians(pt, with_intri=with_intri)
        _, w = TB._robust_cost_and_weight(r, z, pt.obs_w, 4.0)
        U, *_ = TB._build_normal_blocks([pt], [r], [Jc], [Jp], [w])
        assert torch.all(U[fr][:, :3, :] == 0)
        assert torch.all(U[fr][:, :, :3] == 0)
    pj = JB.BAProblem(**{k: jnp.asarray(d[k]) for k in _FIELDS},
                      fix_rot=jnp.asarray(d["fix_rot"]))
    np.testing.assert_array_equal(np.asarray(JB._colmask6(pj)),
                                  TB._cam_colmask(pt, False).numpy())


def test_rot_frozen_intrinsics_solve_matches_jax():
    """The 14-dof intrinsics solve with every rotation frozen, against the
    JAX package's (camera-major ELL layout, precise) on tests/test_ba.py's
    shared-camera problem with its intrinsics perturbed: port rotations bit
    for bit, JAX's within 1e-6; final cost within rtol 1e-3; focal within
    1e-3 relative and k1 within 1e-3 of JAX's."""
    p0, _ = _intri_problem(noise_px=0.0, shared=True)
    pb = dataclasses.replace(_perturb_intri(p0),
                             fix_rot=jnp.ones(p0.cam_q.shape[0], bool))
    opts = dict(max_iters=40, huber_px=4.0, precise=True,
                optimize_intrinsics=True)
    pk, ell = JB.pack_camera_major(pb)
    sj, ij = JB.solve_ba(pk, JB.BAOptions(**opts), ell)
    pt = TB.BAProblem.from_numpy("cpu", **{
        f.name: np.asarray(getattr(pb, f.name))
        for f in dataclasses.fields(TB.BAProblem)})
    st, it = TB.solve_ba(pt, TB.BAOptions(**opts))
    assert torch.equal(st.cam_q, pt.cam_q)
    np.testing.assert_allclose(np.asarray(sj.cam_q)[:len(pt.cam_q)],
                               np.asarray(pb.cam_q), atol=1e-6, rtol=0)
    assert it["final_cost"] == pytest.approx(float(ij["final_cost"]),
                                             rel=1e-3, abs=1e-3)
    assert it["final_cost"] < it["initial_cost"]
    fj = np.asarray(sj.cam_intri)[:len(pt.cam_q)]
    ft = st.cam_intri.numpy()
    np.testing.assert_allclose(ft[:, 0], fj[:, 0], rtol=1e-3)
    np.testing.assert_allclose(ft[:, 4], fj[:, 4], atol=1e-3)


def _maps():
    """The JAX map of tests/test_torch_error_correct (6 frames, 150 tracks,
    0.3 px noise, 3% wrong matches) with frames 2-5 pushed off by 0.05
    units, and the port's copy of it."""
    mj, _ = _jax_map()
    mj.t[2:] += 0.05
    return mj, TMap.from_state(mj)


def test_run_ba_freeze_rotations_matches_jax():
    """run_ba(freeze_rotations=True) over every frame, both packages (JAX:
    precise ELL): the port's map keeps every quaternion bit for bit, the
    JAX map's stay within 1e-6 (a float32 round trip); final costs within
    rtol 1e-2 (JAX's ELL operands against the port's COO), translations
    within 1e-3; the problem carries fix_rot; the cost drops."""
    mj, mt = _maps()
    frames = list(range(mj.num_frames))
    q0 = mt.q.copy()
    prob, *_ = TG.build_problem(mt, frames, "cpu", freeze_rotations=True)
    assert prob.fix_rot is not None and bool(prob.fix_rot.all())
    rj = JG.run_ba(mj, frames, JB.BAOptions(max_iters=20, huber_px=4.0,
                                            precise=True),
                   freeze_rotations=True)
    rt = TG.run_ba(mt, frames, TB.BAOptions(max_iters=20, huber_px=4.0,
                                            precise=True),
                   freeze_rotations=True, device="cpu")
    assert np.array_equal(mt.q, q0)
    np.testing.assert_allclose(mj.q, q0, atol=1e-6, rtol=0)
    assert rt.final_cost < rt.initial_cost
    assert rt.final_cost == pytest.approx(rj.final_cost, rel=1e-2)
    np.testing.assert_allclose(mt.t, mj.t, atol=1e-3, rtol=0)


def test_run_ba_freeze_rotations_on_a_mesh():
    """The same rotation-frozen run_ba through Mesh([cpu] * 4) against one
    device: final cost within 1% (phase 16's bound), rotations bit for bit
    in both; and the JAX package's sharded solve on its 8-device CPU mesh
    keeps fix_rot too (its rotations within 1e-6 of the input, its cost
    within 1% of its single-device one)."""
    mj, mt = _maps()
    frames = list(range(mt.num_frames))
    m1 = TMap.from_state(mt)
    q0 = mt.q.copy()
    r4 = TG.run_ba(mt, frames, TB.BAOptions(max_iters=20, huber_px=4.0),
                   freeze_rotations=True, mesh=Mesh(["cpu"] * 4),
                   device="cpu")
    r1 = TG.run_ba(m1, frames, TB.BAOptions(max_iters=20, huber_px=4.0),
                   freeze_rotations=True, device="cpu")
    assert np.array_equal(mt.q, q0) and np.array_equal(m1.q, q0)
    assert abs(r4.final_cost - r1.final_cost) <= 0.01 * r1.final_cost
    assert r4.final_cost < r4.initial_cost

    from jax.sharding import Mesh as JMesh

    mj2, _ = _maps()
    jmesh = JMesh(np.array(jax.devices()[:8]), ("obs",))
    rj8 = JG.run_ba(mj, frames, JB.BAOptions(max_iters=20, huber_px=4.0),
                    freeze_rotations=True, mesh=jmesh)
    rj1 = JG.run_ba(mj2, frames, JB.BAOptions(max_iters=20, huber_px=4.0,
                                              precise=True),
                    freeze_rotations=True)
    np.testing.assert_allclose(mj.q, q0, atol=1e-6, rtol=0)
    assert abs(rj8.final_cost - rj1.final_cost) <= 0.01 * rj1.final_cost
    assert r1.final_cost == pytest.approx(rj1.final_cost, rel=1e-2)
