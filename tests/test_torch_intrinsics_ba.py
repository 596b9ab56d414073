"""The port's intrinsics-refining bundle adjustment (the 14-dof camera
tangent of xrsfm_tpu_torch.optim.ba, its metadata and write-back in
mapper/ba_glue) against the JAX package's (xrsfm_tpu/optim/ba.py with
optimize_intrinsics, which solves on the camera-major ELL layout), on the
problems of tests/test_ba.py, on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import _intri_problem, _perturb_intri
from test_torch_error_correct import _jax_map
from xrsfm_tpu.optim import ba as JB
from xrsfm_tpu.utils import camera as JC
from xrsfm_tpu_torch.base.map import SfMMap as TMap
from xrsfm_tpu_torch.mapper import ba_glue
from xrsfm_tpu_torch.mapper import incremental as TINC
from xrsfm_tpu_torch.mapper import triangulate as TTRI
from xrsfm_tpu_torch.optim import ba as TB
from xrsfm_tpu_torch.utils import camera as TC
from xrsfm_tpu_torch.utils import geometry as TG

torch.set_num_threads(2)

_OPTS = dict(max_iters=40, huber_px=4.0, precise=True,
             optimize_intrinsics=True)


def _port(pj):
    """The port's problem from a JAX BAProblem (intrinsics fields too)."""
    return TB.BAProblem.from_numpy("cpu", **{
        f.name: np.asarray(getattr(pj, f.name))
        for f in dataclasses.fields(TB.BAProblem)})


def _opencv_problem():
    """tests/test_ba.py:329-342: an untied OPENCV camera, every column."""
    p, _ = _intri_problem(n_cams=3, n_pts=20, seed=50)
    intri = np.tile(JC.canonicalize_params(
        JC.OPENCV, [480.0, 505.0, 320, 240, 0.06, -0.02, 0.002, -0.001]),
        (3, 1)).astype(np.float32)
    free, _ = JC.intri_free_mask(JC.OPENCV)
    return dataclasses.replace(
        p, cam_intri=jnp.asarray(intri),
        fix_intri=jnp.asarray(np.tile(~free, (3, 1))),
        tie_f=jnp.zeros(3, bool))


def test_intri_jacobian_matches_jax_and_autodiff():
    """The [O, 2, 14] camera Jacobian equals JAX's
    _residuals_and_jacobians(with_intri=True) within atol 1e-4, and
    torch.func.jacfwd of the residual through _apply_step's retraction
    (pose, f exp(dlog f), additive rest) within 1e-4 of its largest
    entry."""
    pj = _opencv_problem()
    pt = _port(pj)
    r, z, Jc, Jp = TB._residuals_and_jacobians(pt, with_intri=True)
    rj, zj, Jcj, Jpj = jax.jit(JB._residuals_and_jacobians,
                               static_argnums=1)(pj, True)
    assert Jc.shape == (len(pt.obs_cam), 2, 14)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(Jc.numpy(), np.asarray(Jcj), atol=1e-4)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jpj), atol=1e-4)

    def res(d14, q, t, intri, uv, xyz):
        q2, t2 = TG.pose_retract(q, t, d14[:6])
        i2 = torch.cat([intri[:2] * torch.exp(d14[6:8]), intri[2:] + d14[8:]])
        xy, _ = TC.project(i2, q2, t2, xyz)
        return xy - uv

    J = torch.func.vmap(torch.func.jacfwd(res))(
        torch.zeros(len(pt.obs_cam), 14), pt.cam_q[pt.obs_cam],
        pt.cam_t[pt.obs_cam], pt.cam_intri[pt.obs_cam], pt.obs_uv,
        pt.points[pt.obs_pt])
    np.testing.assert_allclose(Jc.numpy(), J.numpy(),
                               atol=1e-4 * float(J.abs().max()), rtol=0)


def test_tied_focal_column_carries_both_axes():
    """A tied SIMPLE_RADIAL problem: column 7 (dlog fy) is zero and column
    6 carries d/dlog f for both rows."""
    p0, _ = _intri_problem(n_cams=3, n_pts=20, seed=51)
    _, _, Jc, _ = TB._residuals_and_jacobians(_port(p0), with_intri=True)
    assert torch.all(Jc[:, :, 7] == 0)
    assert torch.all(Jc[:, 1, 6] != 0) and torch.all(Jc[:, 0, 6] != 0)


def _per_image_problem():
    """tests/test_ba.py:387-399: every frame its own intrinsic block, each
    focal and k1 perturbed, 0.3 px noise."""
    p0, gt = _intri_problem(noise_px=0.3, shared=False, seed=60)
    rng = np.random.default_rng(61)
    intri = np.array(p0.cam_intri)
    per = 1.0 + rng.uniform(-0.05, 0.05, len(intri))
    intri[:, 0] *= per
    intri[:, 1] *= per
    intri[:, 4] += rng.uniform(-0.04, 0.04, len(intri))
    return dataclasses.replace(p0, cam_intri=jnp.asarray(intri)), gt


@pytest.mark.parametrize("shared", [True, False])
def test_solve_intrinsics_matches_jax(shared):
    """Port solve_ba(optimize_intrinsics) against JAX's on the packed
    problem (precise), for the shared-camera problem (5% focal, k1 and
    3 px principal point off, noiseless) and the per-image blocks: final
    cost within rtol 1e-3; recovered focal and k1 within the limits of
    tests/test_ba.py (shared: focal 1e-3 relative, k1 1e-3, cx and cy
    0.5 px; per image: medians 5e-3); a tied focal stays tied and a shared
    block stays shared, bit for bit."""
    if shared:
        p0, gt = _intri_problem(noise_px=0.0, shared=True)
        pb = _perturb_intri(p0)
    else:
        pb, gt = _per_image_problem()
    pk, ell = JB.pack_camera_major(pb)
    sj, ij = JB.solve_ba(pk, JB.BAOptions(**_OPTS), ell)
    TB.reset_counts()
    st, it = TB.solve_ba(_port(pb), TB.BAOptions(**_OPTS))
    assert TB.COUNTS["intri_solves_cpu"] == 1
    assert it["final_cost"] == pytest.approx(float(ij["final_cost"]),
                                             rel=1e-3, abs=1e-3)
    got = st.cam_intri.numpy()
    assert np.array_equal(got[:, 0], got[:, 1])  # tied
    if shared:
        assert (got == got[0]).all()  # one block
        assert abs(got[0, 0] - gt[0]) / gt[0] < 1e-3
        assert abs(got[0, 4] - gt[4]) < 1e-3
        assert abs(got[0, 2] - gt[2]) < 0.5 and abs(got[0, 3] - gt[3]) < 0.5
    else:
        assert np.median(np.abs(got[:, 0] - gt[0]) / gt[0]) < 5e-3
        assert np.median(np.abs(got[:, 4] - gt[4])) < 5e-3
    jf = np.asarray(sj.cam_intri)[: len(got)]
    np.testing.assert_allclose(got[:, [0, 4]], jf[:, [0, 4]], rtol=2e-3,
                               atol=2e-3)


def test_jax_ell_solve_stalls_where_the_port_leaves_it():
    """tests/test_torch_ba_stall.py's cut problem (cameras 105-124 of the
    BAL-shaped problem of seed 1000004, the global BA's options) through
    the JAX package's camera-major ELL solve: it stalls as the port did
    before _keep_in_front (damping above 1 after 20 steps), and the port's
    row solve ends more than 1% below it, having accepted at least 18 of
    its 20 steps."""
    from perfbench.gen import bal
    from test_torch_ba_stall import CAMS, OPTS, _config, cut_problem

    arr = cut_problem(bal.make_problem(_config(), 1000004)["start"], *CAMS)
    pj = JB.BAProblem(**{k: jnp.asarray(v.astype(np.int32) if k in (
        "obs_cam", "obs_pt") else v) for k, v in arr.items()})
    pk, ell = JB.pack_camera_major(pj)
    _, ij = JB.solve_ba(pk, JB.BAOptions(**OPTS, precise=True), ell)
    pt, et = TB.pack_camera_major(TB.BAProblem.from_numpy("cpu", **arr))
    _, it = TB.solve_ba(pt, TB.BAOptions(**OPTS), et)
    assert float(ij["lam"]) > 1.0
    assert it["accepts"] >= 18
    assert it["final_cost"] < 0.99 * float(ij["final_cost"])


def test_pose_only_solve_ignores_intrinsics_fields():
    """With the fields present and the option off, cam_intri stays
    bit-equal, and the solve is bit-equal to one without the fields."""
    p0, _ = _intri_problem(noise_px=0.2, seed=70)
    from test_ba import perturb

    pb = _port(perturb(p0, seed=71))
    bare = dataclasses.replace(pb, cam_kam=None, fix_intri=None, tie_f=None)
    opts = TB.BAOptions(max_iters=10, huber_px=4.0)
    s1, i1 = TB.solve_ba(pb, opts)
    s2, i2 = TB.solve_ba(bare, opts)
    assert torch.equal(s1.cam_intri, pb.cam_intri)
    assert i1 == i2
    for a in ("cam_q", "cam_t", "points"):
        assert torch.equal(getattr(s1, a), getattr(s2, a)), a
    with pytest.raises(ValueError, match="cam_kam"):
        TB.solve_ba(bare, TB.BAOptions(optimize_intrinsics=True))


def _radial_map(seed=3, n_cams=8, n_pts=120, shared_pairs=True):
    """tests/test_torch_error_correct's registered make_scene map, its
    pinhole camera replaced by per-frame SIMPLE_RADIAL cameras (frames 0
    and 1 share camera 0 when shared_pairs) with 4% focal errors."""
    mj, _ = _jax_map(n_cams=n_cams, n_pts=n_pts, seed=seed)
    m = TMap.from_state(mj)
    f, cx, cy = m.cameras[0][0], m.cameras[0][2], m.cameras[0][3]
    kps = [k.copy() for k in m.kps]
    m.cameras, m.camera_models = {}, {}
    rng = np.random.default_rng(seed)
    for i in range(n_cams):
        cid = 0 if (shared_pairs and i == 1) else i
        if cid == i:
            m.add_camera(cid, TC.SIMPLE_RADIAL,
                         [f * (1 + rng.uniform(-0.04, 0.04)), cx, cy, 0.0],
                         640, 480)
        m.cam_of_frame[i] = cid
    for i in range(n_cams):
        m.kps[i] = kps[i]
        m.kps_norm[i] = TC.image_to_normalized_np(
            m.cameras[int(m.cam_of_frame[i])], kps[i])
    return m, f


def test_run_ba_writes_refined_intrinsics_back():
    """run_ba(optimize_intrinsics) builds one intrinsic block per physical
    camera (frames 0 and 1 share one), moves the focals toward the truth,
    writes the cameras back and refreshes kps_norm through update_camera;
    LBA-style pose-only solves leave the cameras alone."""
    m, f_true = _radial_map()
    prob, frames, _, _ = ba_glue.build_problem(m, list(range(8)), "cpu")
    kam = prob.cam_kam.numpy()
    assert kam[0] == kam[1] and len(set(kam.tolist())) == 7
    assert prob.tie_f.all() and not prob.fix_intri[:, [0, 2, 3, 4]].any()
    assert prob.fix_intri[:, [1, 5, 6, 7]].all()
    before = {c: p.copy() for c, p in m.cameras.items()}
    ba_glue.run_ba(m, list(range(8)), TB.BAOptions(max_iters=5, huber_px=4.0),
                   device="cpu")
    assert all(np.array_equal(before[c], m.cameras[c]) for c in before)
    err0 = np.mean([abs(p[0] - f_true) for p in before.values()])
    res = ba_glue.run_ba(m, list(range(8)),
                         TB.BAOptions(max_iters=20, huber_px=4.0),
                         optimize_intrinsics=True, device="cpu")
    assert res.final_cost < res.initial_cost
    err1 = np.mean([abs(p[0] - f_true) for p in m.cameras.values()])
    assert err1 < 0.5 * err0
    for c, p in m.cameras.items():
        assert p[0] == p[1] and m.camera_models[c][1][0] == p[0]
    for i in range(8):
        np.testing.assert_array_equal(m.kps_norm[i], TC.image_to_normalized_np(
            m.cameras[int(m.cam_of_frame[i])], m.kps[i]))


def test_polish_backup_restore_with_intrinsics_is_bit_identical():
    """tests/test_incremental.py:155-215 on the port: a pose rewrite
    stand-in, a full retriangulation and an intrinsics-refining GBA, then
    polish_restore: poses, structure, cameras, camera models and kps_norm
    bit-identical to before."""
    m, _ = _radial_map(shared_pairs=False)
    nt = m.num_tracks
    snap = (m.q.copy(), m.t.copy(), m.track_xyz[:nt].copy(),
            m.track_valid[:nt].copy(), m.track_error[:nt].copy(),
            m.track_angle[:nt].copy(),
            {c: p.copy() for c, p in m.cameras.items()},
            {c: (mid, raw.copy(), w, h)
             for c, (mid, raw, w, h) in m.camera_models.items()},
            [k.copy() for k in m.kps_norm])
    backup = TINC.polish_backup(m)
    rng = np.random.default_rng(11)
    m.q[:, 1:] += rng.normal(scale=0.01, size=(8, 3))
    m.q /= np.linalg.norm(m.q, axis=1, keepdims=True)
    TTRI.retriangulate(m, np.nonzero(m.track_valid[:nt])[0], device="cpu")
    ba_glue.run_ba(m, list(range(8)), TB.BAOptions(max_iters=3),
                   optimize_intrinsics=True, device="cpu")
    assert not all(np.array_equal(snap[6][c], m.cameras[c]) for c in snap[6])
    TINC.polish_restore(m, backup)
    q, t, xyz, val, err, ang, cams, models, kn = snap
    for a, b in ((q, m.q), (t, m.t), (xyz, m.track_xyz[:nt]),
                 (val, m.track_valid[:nt]), (err, m.track_error[:nt]),
                 (ang, m.track_angle[:nt])):
        assert np.array_equal(a, b)
    for c in cams:
        assert np.array_equal(cams[c], m.cameras[c])
        assert models[c][0] == m.camera_models[c][0]
        assert np.array_equal(models[c][1], m.camera_models[c][1])
    assert all(np.array_equal(a, b) for a, b in zip(kn, m.kps_norm))
