"""The port's reconstruction ops (xrsfm_tpu_torch.ops.triangulation, the
essential half of .epipolar, .essential5pt, .pnp, .epnp) and the mapper's
batched kernels (xrsfm_tpu_torch.mapper.kernels) against the JAX
package's, on the same seeded numpy inputs, on the CPU.

Eigenvector and singular-vector signs differ between the libraries, so E
is compared up to sign and scale, poses rather than bases, and the 5-point
and P3P solution sets as sets.  RANSAC kernels are fed the JAX sampler's
own indices (drawn after the same key split as xrsfm_tpu/ops/ransac.py:72).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from xrsfm_tpu.mapper import kernels as JK
from xrsfm_tpu.ops import epipolar as JE, epnp as JEP, pnp as JP
from xrsfm_tpu.ops import ransac as JR, triangulation as JT
from xrsfm_tpu.ops.essential5pt import essential_5pt as j5pt
from xrsfm_tpu.utils import geometry as JG
from xrsfm_tpu_torch.mapper import kernels as TK
from xrsfm_tpu_torch.ops import epipolar as TE, epnp as TEP, pnp as TP
from xrsfm_tpu_torch.ops import triangulation as TT
from xrsfm_tpu_torch.ops.essential5pt import essential_5pt as t5pt

torch.set_num_threads(2)


def _pose(rng, depth=6.0, rot=0.3):
    q = JG.rotmat_to_quat_np(np.asarray(JG.so3_exp_matrix(
        jnp.asarray(rng.normal(scale=rot, size=3), jnp.float32))))
    t = np.array([0.2, -0.1, depth]) + rng.normal(scale=0.3, size=3)
    return q.astype(np.float32), t.astype(np.float32)


def _project(q, t, xyz):
    pc = xyz @ JG.quat_to_rotmat_np(q).T + t
    return (pc[:, :2] / pc[:, 2:3]).astype(np.float32)


def _rot_deg(qa, qb):
    """Angle between two rotations, from their relative quaternion (well
    conditioned near zero, unlike arccos of the dot product)."""
    dq = JG.quat_mul_np(np.asarray(qa, np.float64) * [1, -1, -1, -1], qb)
    return float(np.degrees(2 * np.arctan2(np.linalg.norm(dq[1:]),
                                           abs(dq[0]))))


def _two_view(seed, n, noise=0.0, outliers=0.0):
    """Normalized correspondences of a random scene in two views (cam1 at
    the identity), with noise and gross outliers."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 9, n)], 1)
    q2, t2 = _pose(rng, depth=0.0, rot=0.15)
    t2 = np.array([-1.0, 0.1, 0.05], np.float32) + 0.1 * t2
    x1 = _project(np.array([1, 0, 0, 0], np.float32), np.zeros(3, np.float32), X)
    x2 = _project(q2, t2, X)
    x1 = x1 + rng.normal(scale=noise, size=x1.shape).astype(np.float32)
    x2 = x2 + rng.normal(scale=noise, size=x2.shape).astype(np.float32)
    bad = rng.random(n) < outliers
    x2[bad] = rng.uniform(-0.5, 0.5, (int(bad.sum()), 2))
    return x1, x2, q2, t2, X.astype(np.float32)


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _jx(*a):
    return [jnp.asarray(x) for x in a]


def _e_dist(A, B):
    """Distance between essential matrices up to scale and sign."""
    A = A / np.linalg.norm(A)
    B = B / np.linalg.norm(B)
    return min(np.abs(A - B).max(), np.abs(A + B).max())


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------


def test_triangulation_matches_jax():
    """Two-view and masked multiview DLT within 1e-4 relative to depth;
    reprojection errors, depths and ray angles within 1e-5 (inf where JAX
    has inf)."""
    rng = np.random.default_rng(0)
    V, B = 6, 40
    poses = [_pose(rng) for _ in range(V)]
    q = np.stack([p[0] for p in poses])
    t = np.stack([p[1] for p in poses])
    X = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    uv = np.stack([_project(q[v], t[v], X) for v in range(V)], 1)
    uv = uv + rng.normal(scale=1e-3, size=uv.shape).astype(np.float32)
    mask = rng.random((B, V)) < 0.7
    mask[:, :2] = True
    qb = np.broadcast_to(q, (B, V, 4)).copy()
    tb = np.broadcast_to(t, (B, V, 3)).copy()
    got = TT.triangulate_two_view(*_t(qb[:, 0], tb[:, 0], uv[:, 0],
                                      qb[:, 1], tb[:, 1], uv[:, 1])).numpy()
    exp = np.asarray(JT.triangulate_two_view(*_jx(qb[:, 0], tb[:, 0], uv[:, 0],
                                                  qb[:, 1], tb[:, 1], uv[:, 1])))
    np.testing.assert_allclose(got, exp, atol=6e-4, rtol=0)
    got = TT.triangulate_multiview(*_t(qb, tb, uv, mask)).numpy()
    exp = np.asarray(JT.triangulate_multiview(*_jx(qb, tb, uv,
                                                   mask.astype(np.float32))))
    np.testing.assert_allclose(got, exp, atol=6e-4, rtol=0)
    Xb = np.broadcast_to(X[:, None], (B, V, 3)).copy()
    Xb[0, 0] = [0, 0, -20.0]  # behind the camera
    e_t = TT.reprojection_errors(*_t(qb, tb, uv, Xb)).numpy()
    e_j = np.asarray(JT.reprojection_errors(*_jx(qb, tb, uv, Xb)))
    assert np.array_equal(np.isinf(e_t), np.isinf(e_j)) and np.isinf(e_t).any()
    fin = np.isfinite(e_j)
    np.testing.assert_allclose(e_t[fin], e_j[fin], atol=1e-5, rtol=0)
    np.testing.assert_allclose(TT.depths(*_t(qb, tb, Xb)).numpy(),
                               np.asarray(JT.depths(*_jx(qb, tb, Xb))),
                               atol=2e-5, rtol=0)
    c = t.copy()
    np.testing.assert_allclose(
        TT.triangulation_angle(*_t(c[0], c[1], X)).numpy(),
        np.asarray(JT.triangulation_angle(*_jx(c[0], c[1], X))),
        atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# essential matrices
# ---------------------------------------------------------------------------


def _essential_8pt_float64(x1, x2, mask):
    """The 8-point E of the masked points in float64 (numpy SVD)."""
    x1, x2 = x1[mask].astype(np.float64), x2[mask].astype(np.float64)
    (u1, v1), (u2, v2) = x1.T, x2.T
    A = np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                  np.ones_like(u1)], 1)
    U, _, Vt = np.linalg.svd(np.linalg.svd(A)[2][-1].reshape(3, 3))
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt


def test_essential_8pt_and_pose_recovery_match_jax():
    """On 4 seeded noisy views with masked padding.  A float32 8-point E
    is only as well conditioned as its points, so both packages are held
    to a float64 solve: the port within max(2e-4, 1.5x the JAX package's
    error) (observed: both 2e-5..2.5e-4).  From JAX's E, the recovered
    pose within 0.01 deg and 1e-3 in translation direction, cheirality
    counts within 1 and masks equal on >= 99% of points."""
    for seed in range(4):
        x1, x2, q2, t2, _ = _two_view(seed, 120, noise=1e-3)
        mask = np.ones(128, bool)
        mask[120:] = False
        x1 = np.concatenate([x1, np.zeros((8, 2), np.float32)])
        x2 = np.concatenate([x2, np.ones((8, 2), np.float32)])
        Et, vt = TE.essential_8pt(*_t(x1, x2, mask))
        Ej, vj = jax.jit(JE.essential_8pt)(*_jx(x1, x2, mask))
        assert bool(vt) == bool(vj)
        ref = _essential_8pt_float64(x1, x2, mask)
        err_j = _e_dist(np.asarray(Ej), ref)
        assert _e_dist(Et.numpy(), ref) <= max(2e-4, 1.5 * err_j)
        res_t = TE.recover_pose_from_essential(*_t(Ej, x1, x2, mask))
        res_j = jax.jit(JE.recover_pose_from_essential)(Ej, *_jx(x1, x2, mask))
        assert _rot_deg(res_t[0].numpy(), np.asarray(res_j[0])) < 1e-2
        tt, tj = res_t[1].numpy(), np.asarray(res_j[1])
        assert np.abs(tt / np.linalg.norm(tt) - tj / np.linalg.norm(tj)).max() < 1e-3
        assert abs(int(res_t[2]) - int(res_j[2])) <= 1
        assert np.mean(res_t[3].numpy() == np.asarray(res_j[3])) >= 0.99
        # and the recovered pose is the scene's (0.5 px noise)
        assert _rot_deg(res_t[0].numpy(), q2) < 1.0
    E = np.asarray(JE.essential_from_pose(*_jx(q2, t2)))
    np.testing.assert_allclose(TE.essential_from_pose(*_t(q2, t2)).numpy(), E,
                               atol=1e-6, rtol=0)


def test_essential_5pt_finds_true_solution_as_often_as_jax():
    """64 noiseless minimal samples, batched in the port (the JAX package
    vmapped).  A float32 5-point solve is only as well conditioned as its
    sample (each package misses the truth on a few samples that the other
    solves), so both are held to the true E, the exact solution known by
    construction: the port contains it within 1e-3 on at least as many
    samples as JAX, less 2 (observed 52 vs 49), and within 1e-2 on at least
    60 (observed 61; JAX 60)."""
    S = 64
    x1s, x2s, Es = [], [], []
    for seed in range(S):
        x1, x2, q2, t2, _ = _two_view(100 + seed, 5)
        x1s.append(x1)
        x2s.append(x2)
        tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]],
                       [-t2[1], t2[0], 0]])
        Es.append(tx @ JG.quat_to_rotmat_np(q2))
    x1s, x2s = np.stack(x1s), np.stack(x2s)
    mask = np.ones((S, 5), bool)
    E_t, v_t = (a.numpy() for a in t5pt(*_t(x1s, x2s, mask)))
    E_j, v_j = (np.asarray(a) for a in jax.jit(jax.vmap(j5pt))(
        *_jx(x1s, x2s, mask)))

    def err(E, v, k):
        return min((_e_dist(S_, Es[k]) for S_ in E[k][v[k]]), default=1.0)

    d_t = np.array([err(E_t, v_t, k) for k in range(S)])
    d_j = np.array([err(E_j, v_j, k) for k in range(S)])
    assert (d_t < 1e-3).sum() >= (d_j < 1e-3).sum() - 2
    assert (d_t < 1e-2).sum() >= 60


# ---------------------------------------------------------------------------
# absolute pose
# ---------------------------------------------------------------------------


def _pnp_scene(seed, n=60, noise=0.0, planar=False):
    rng = np.random.default_rng(seed)
    q, t = _pose(rng)
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    if planar:
        xyz[:, 2] = 0.02 * rng.normal(size=n)
    uv = _project(q, t, xyz) + rng.normal(scale=noise, size=(n, 2)).astype(
        np.float32)
    return q, t, xyz, uv


def test_p3p_solution_sets_match_jax():
    """16 noiseless minimal samples.  A float32 quartic is only as well
    conditioned as its sample (on one sample both packages land 0.2-1.4
    deg off, depending even on XLA's fusion), so both are held to the true
    pose, the exact solution known by construction: the port finds it
    within 0.05 deg on at least as many samples as JAX, less 1, and on
    >= 14; where both find it, the valid solution sets are equal as sets
    (0.05, degrees plus translation)."""
    xyz, uv, truth = [], [], []
    for seed in range(16):
        q, t, X, u = _pnp_scene(200 + seed, n=3)
        xyz.append(X)
        uv.append(u)
        truth.append(q)
    xyz, uv = np.stack(xyz), np.stack(uv)
    qt, tt, vt = (a.numpy() for a in TP.p3p(*_t(xyz, uv)))
    QJ, TJ, VJ = (np.asarray(a) for a in jax.jit(jax.vmap(JP.p3p))(
        *_jx(xyz, uv)))
    found_t = found_j = 0
    for k in range(16):
        sols = [(qt[k, i], tt[k, i]) for i in range(4) if vt[k, i]]
        sj = [(QJ[k, i], TJ[k, i]) for i in range(4) if VJ[k, i]]
        ok_t = min(_rot_deg(s[0], truth[k]) for s in sols) < 0.05
        ok_j = min(_rot_deg(s[0], truth[k]) for s in sj) < 0.05
        found_t += ok_t
        found_j += ok_j
        if ok_t and ok_j:
            assert len(sj) == len(sols), k
            for q_, t_ in sj:
                assert min(_rot_deg(q_, s[0]) + np.abs(t_ - s[1]).max()
                           for s in sols) < 0.05
    assert found_t >= max(14, found_j - 1), (found_t, found_j)


def test_epnp_ippe_refine_match_jax():
    """EPnP and both IPPE poses within 0.05 deg and 5e-3 of the JAX
    package's on noisy scenes with zero-weight padding; refine_pose from
    a perturbed start lands within 0.01 deg and 1e-3 of JAX's and of the
    scene's pose."""
    for seed in range(3):
        q, t, xyz, uv = _pnp_scene(300 + seed, noise=1e-3)
        w = np.ones(64, np.float32)
        w[60:] = 0
        xyz = np.concatenate([xyz, np.full((4, 3), 9.0, np.float32)])
        uv = np.concatenate([uv, np.full((4, 2), 0.7, np.float32)])
        a, b = TEP.epnp(*_t(xyz, uv, w)), jax.jit(JEP.epnp)(*_jx(xyz, uv, w))
        assert _rot_deg(a[0].numpy(), np.asarray(b[0])) < 0.05
        assert np.abs(a[1].numpy() - np.asarray(b[1])).max() < 5e-3
        assert _rot_deg(a[0].numpy(), q) < 0.2
        _, _, xp, up = _pnp_scene(310 + seed, noise=1e-3, planar=True)
        a = TEP.ippe(*_t(xp, up, np.ones(60, np.float32)))
        b = jax.jit(JEP.ippe)(*_jx(xp, up, np.ones(60, np.float32)))
        for i in range(2):
            assert _rot_deg(a[0][i].numpy(), np.asarray(b[0][i])) < 0.05
            assert np.abs(a[1][i].numpy() - np.asarray(b[1][i])).max() < 5e-3
        rng = np.random.default_rng(seed)
        q0 = JG.quat_mul_np(q, JG.rotmat_to_quat_np(JG.quat_to_rotmat_np(
            np.asarray(JG.so3_exp_quat(jnp.asarray(
                rng.normal(scale=0.05, size=3), jnp.float32))))))
        q0 = q0.astype(np.float32)
        t0 = (t + rng.normal(scale=0.1, size=3)).astype(np.float32)
        a = TP.refine_pose(*_t(q0, t0, uv, xyz, w))
        b = jax.jit(JP.refine_pose)(*_jx(q0, t0, uv, xyz, w))
        assert _rot_deg(a[0].numpy(), np.asarray(b[0])) < 1e-2
        assert np.abs(a[1].numpy() - np.asarray(b[1])).max() < 1e-3
        assert _rot_deg(a[0].numpy(), q) < 0.1


# ---------------------------------------------------------------------------
# mapper kernels, with the JAX sampler's indices
# ---------------------------------------------------------------------------


def _jax_samples(seeds, mask, H, k):
    return torch.from_numpy(np.stack([
        np.asarray(JR._sample_indices(
            jax.random.split(jax.random.PRNGKey(s))[0], jnp.asarray(m), H, k))
        for s, m in zip(seeds, mask)]))


def test_pnp_ransac_batch_with_jax_samples_matches_jax():
    """4 frames (one planar), 30% gross outliers, ragged masks: success
    equal, poses within 0.01 deg and 1e-3, inlier counts within max(2, 1%)
    and masks equal on >= 99% of points."""
    B, N = 4, 128
    uv = np.zeros((B, N, 2), np.float32)
    xyz = np.zeros((B, N, 3), np.float32)
    mask = np.zeros((B, N), bool)
    rng = np.random.default_rng(9)
    for b, n in enumerate((128, 100, 80, 120)):
        _, _, X, u = _pnp_scene(400 + b, n=n, noise=5e-4, planar=b == 3)
        bad = rng.random(n) < 0.3
        u[bad] = rng.uniform(-0.4, 0.4, (int(bad.sum()), 2))
        uv[b, :n], xyz[b, :n], mask[b, :n] = u, X, True
    th = np.full(B, (8.0 / 500.0) ** 2, np.float32)
    seeds = [1000 + b for b in range(B)]
    got = [a.numpy() for a in TK.pnp_ransac_batch(
        *_t(uv, xyz, mask, th), sample_idx=_jax_samples(seeds, mask, 256, 3))]
    for b in range(B):
        exp = [np.asarray(a) for a in JK.pnp_ransac(
            jax.random.PRNGKey(seeds[b]), *_jx(uv[b], xyz[b], mask[b]),
            th[b])]
        assert bool(got[4][b]) == bool(exp[4]) is True
        assert _rot_deg(got[0][b], exp[0]) < 1e-2, b
        assert np.abs(got[1][b] - exp[1]).max() < 1e-3, b
        assert abs(int(got[3][b]) - int(exp[3])) <= max(2, 0.01 * exp[3])
        assert np.mean(got[2][b][mask[b]] == exp[2][mask[b]]) >= 0.99


def test_pnp_ransac_one_frame_matches_jax():
    """The one-problem pnp_ransac (mapper/register.py's call in the JAX
    package) on a frame of 100 of 128 points, 30% gross outliers: with
    the JAX sampler's indices, the batch test's gates against JAX's
    pnp_ransac and the batch form's result bit for bit; with the port's
    own generator, success and the scene's pose within 0.05 deg."""
    N, n = 128, 100
    q0, _, X, u = _pnp_scene(420, n=n, noise=5e-4)
    bad = np.random.default_rng(10).random(n) < 0.3
    u[bad] = np.random.default_rng(11).uniform(-0.4, 0.4, (int(bad.sum()), 2))
    uv = np.zeros((N, 2), np.float32)
    xyz = np.zeros((N, 3), np.float32)
    mask = np.zeros(N, bool)
    uv[:n], xyz[:n], mask[:n] = u, X, True
    th = np.float32((8.0 / 500.0) ** 2)
    idx = _jax_samples([1234], mask[None], 256, 3)
    got = [a.numpy() for a in TK.pnp_ransac(*_t(uv, xyz, mask), float(th),
                                            sample_idx=idx[0])]
    exp = [np.asarray(a) for a in JK.pnp_ransac(
        jax.random.PRNGKey(1234), *_jx(uv, xyz, mask), th)]
    batch = [a[0].numpy() for a in TK.pnp_ransac_batch(
        *_t(uv[None], xyz[None], mask[None], th[None]), sample_idx=idx)]
    assert [a.shape for a in got] == [a.shape for a in exp] \
        == [(4,), (3,), (N,), (), ()]
    for a, b in zip(got, batch):
        np.testing.assert_array_equal(a, b)
    assert bool(got[4]) == bool(exp[4]) is True
    assert _rot_deg(got[0], exp[0]) < 1e-2
    assert np.abs(got[1] - exp[1]).max() < 1e-3
    assert abs(int(got[3]) - int(exp[3])) <= max(2, 0.01 * exp[3])
    assert np.mean(got[2][mask] == exp[2][mask]) >= 0.99
    q, _, _, _, ok = TK.pnp_ransac(*_t(uv, xyz, mask), float(th),
                                   generator=torch.Generator().manual_seed(5))
    assert bool(ok) and _rot_deg(q.numpy(), q0) < 0.05


def test_init_probe_batch_with_jax_samples_matches_jax():
    """3 candidate pairs with outliers and ragged masks through the port's
    essential LO-RANSAC + pose/triangulation stats and JAX's vmapped probe
    on the same 5-point samples: success and pose equal (0.05 deg, 2e-3
    direction), inlier and cheirality counts within max(2, 1%), point
    masks on >= 98% of points, triangulated points of agreeing good
    entries within 1e-2 relative."""
    K, N = 3, 160
    uv1 = np.zeros((K, N, 2), np.float32)
    uv2 = np.zeros((K, N, 2), np.float32)
    mask = np.zeros((K, N), bool)
    for k, n in enumerate((160, 130, 150)):
        a, b, *_ = _two_view(500 + k, n, noise=5e-4, outliers=0.15)
        uv1[k, :n], uv2[k, :n], mask[k, :n] = a, b, True
    th = np.full(K, (10.0 / 500.0) ** 2, np.float32)
    seeds = [(k * 32768 + k + 1) & 0x7FFFFFFF for k in range(K)]
    got = [a.numpy() for a in TK.init_probe_batch(
        *_t(uv1, uv2, mask, th), sample_idx=_jax_samples(seeds, mask, 64, 5))]
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    exp = [np.asarray(a) for a in JK.init_probe_batch(
        keys, *_jx(uv1, uv2, mask, th))]
    q, t, n_good, X, good, ang, n_inl, ok = range(8)
    np.testing.assert_array_equal(got[ok], exp[ok])
    for k in range(K):
        assert _rot_deg(got[q][k], exp[q][k]) < 0.05
        assert np.abs(got[t][k] - exp[t][k]).max() < 2e-3
        for i in (n_good, n_inl):
            assert abs(int(got[i][k]) - int(exp[i][k])) <= max(2, 0.01 * exp[i][k])
        m = mask[k]
        assert np.mean(got[good][k][m] == exp[good][k][m]) >= 0.98
        both = got[good][k] & exp[good][k]
        rel = np.linalg.norm(got[X][k][both] - exp[X][k][both], axis=1) \
            / np.linalg.norm(exp[X][k][both], axis=1)
        assert np.max(rel) < 1e-2
        np.testing.assert_allclose(got[ang][k][both], exp[ang][k][both],
                                   atol=1e-3)


def test_essential_ransac_generators_find_the_pose():
    """The port's own sampler (one seeded generator per pair; its
    hypotheses differ from the JAX package's, which the JAX-sample test
    above covers), 2 px threshold, 20% gross outliers: every pair
    succeeds, keeps >= 97% of the scene's true inliers, and its rotation
    is within 2.5 deg of the scene's.  (The 1-unit baseline at 4-9 units
    of depth leaves a shallow rotation-translation valley: over seeds,
    JAX's own results lie 0.2-0.8 deg off, the port's 0.1-1.9.)"""
    K, N = 2, 150
    uv1 = np.zeros((K, N, 2), np.float32)
    uv2 = np.zeros((K, N, 2), np.float32)
    mask = np.ones((K, N), bool)
    truth, n_true = [], []
    for k in range(K):
        uv1[k], uv2[k], q2, t2, X = _two_view(600 + k, N, noise=5e-4,
                                              outliers=0.2)
        truth.append(q2)
        n_true.append(int(np.sum(np.abs(uv2[k] - _project(q2, t2, X)).max(1)
                                 < 1e-2)))
    th = np.full(K, (2.0 / 500.0) ** 2, np.float32)
    gens = [torch.Generator().manual_seed(7 + k) for k in range(K)]
    E, inl, n_inl, ok = TK.essential_ransac(*_t(uv1, uv2, mask, th),
                                            generators=gens)
    q = TK.init_pair_stats(E, *_t(uv1, uv2), inl)[0].numpy()
    for k in range(K):
        assert bool(ok[k])
        assert int(n_inl[k]) >= 0.97 * n_true[k], (int(n_inl[k]), n_true[k])
        assert _rot_deg(q[k], truth[k]) < 2.5


def test_robust_triangulate_and_refine_poses_match_jax():
    """robust_triangulate on 24 observation sets of up to 8 views with one
    outlier each: ok flags and observation masks equal, points within
    1e-3 relative, angles within 1e-5; reproj_errors_batch and
    refine_poses_batch within 1e-5 and 0.01 deg / 1e-3."""
    rng = np.random.default_rng(11)
    B, V = 24, 8
    poses = [_pose(rng) for _ in range(V)]
    q = np.stack([p[0] for p in poses])
    t = np.stack([p[1] for p in poses])
    X = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    uv = np.stack([_project(q[v], t[v], X) for v in range(V)], 1)
    uv += rng.normal(scale=5e-4, size=uv.shape).astype(np.float32)
    uv[np.arange(B), rng.integers(0, V, B)] += 0.05
    mask = rng.random((B, V)) < 0.8
    mask[:, :3] = True
    qb = np.broadcast_to(q, (B, V, 4)).copy()
    tb = np.broadcast_to(t, (B, V, 3)).copy()
    th, ang = (4.0 / 500.0) ** 2, float(np.deg2rad(1.5))
    got = [a.numpy() for a in TK.robust_triangulate(*_t(qb, tb, uv, mask),
                                                    th, ang)]
    exp = [np.asarray(a) for a in JK.robust_triangulate(*_jx(qb, tb, uv, mask),
                                                        th, ang)]
    np.testing.assert_array_equal(got[2], exp[2])
    np.testing.assert_array_equal(got[1], exp[1])
    assert exp[2].sum() >= 20
    ok = exp[2]
    rel = np.linalg.norm(got[0][ok] - exp[0][ok], axis=1) \
        / np.linalg.norm(exp[0][ok], axis=1)
    assert rel.max() < 1e-3
    np.testing.assert_allclose(got[3], exp[3], atol=1e-5)

    flat = (qb.reshape(-1, 4), tb.reshape(-1, 3), uv.reshape(-1, 2),
            np.repeat(X, V, 0))
    for a, b in zip(TK.reproj_errors_batch(*_t(*flat)),
                    JK.reproj_errors_batch(*_jx(*flat))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)

    Xs = np.broadcast_to(X, (V, B, 3)).copy()
    w = mask.T.astype(np.float32)
    hd = np.full(V, 4.0 / 500.0, np.float32)
    q0 = (q + rng.normal(scale=0.01, size=q.shape)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    args = (q0, t + 0.05, uv.transpose(1, 0, 2).copy(), Xs, w, hd)
    a = TK.refine_poses_batch(*_t(*args))
    b = JK.refine_poses_batch(*_jx(*args))
    for v in range(V):
        assert _rot_deg(a[0][v].numpy(), np.asarray(b[0][v])) < 1e-2
        assert np.abs(a[1][v].numpy() - np.asarray(b[1][v])).max() < 1e-3


def test_tuple_models_and_per_problem_thresholds_in_ransac():
    """The harness takes (q, t) tuple models and one threshold per
    problem: on one scene and one set of samples, the problem with the
    working threshold keeps nearly every point, its twin with a 1e-12
    threshold keeps only a minimal sample's worth."""
    _, _, X, u = _pnp_scene(700, n=64, noise=5e-4)
    uv = np.stack([u, u])
    xyz = np.stack([X, X])
    mask = np.ones((2, 64), bool)
    th = np.array([(8.0 / 500.0) ** 2, 1e-12], np.float32)
    idx = _jax_samples([1, 1], mask, 64, 3)
    *_, n_inl, ok = TK.pnp_ransac_batch(*_t(uv, xyz, mask, th),
                                        sample_idx=idx, num_hypotheses=64)
    assert bool(ok[0]) and int(n_inl[0]) >= 60
    assert int(n_inl[1]) <= 4


def test_linalg_on_cpu_is_float32_lapack():
    """ops/linalg on the CPU: eigh, svd and solve of float32 batches are
    torch.linalg's float32 LAPACK results bit for bit (tolerance 0), as the
    JAX package's on the CPU are; only a GPU decomposes in float64."""
    from xrsfm_tpu_torch.ops import linalg

    rng = np.random.default_rng(3)
    A = rng.normal(size=(64, 4, 4)).astype(np.float32)
    S = torch.from_numpy(A @ A.transpose(0, 2, 1))
    M = torch.from_numpy(A)
    b = torch.from_numpy(rng.normal(size=(64, 4, 2)).astype(np.float32))
    pairs = [(linalg.eigh(S), torch.linalg.eigh(S)),
             (linalg.svd(M), torch.linalg.svd(M)),
             ((linalg.solve(M, b),), (torch.linalg.solve(M, b),))]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert torch.equal(g, w)
