"""The port's public names that complete its surface against the JAX
package: mapper/kernels.essential_ransac(use_5pt=False) (the 8-point
hypothesis branch), utils/camera.Cameras / make_cameras and
ops/epipolar.epipolar_residual, on the same seeded numpy inputs, on the
CPU; and ops/poly's root finder, whose iteration holds the root index
first, against the index-last iteration bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recon_ops import (_e_dist, _essential_8pt_float64,
                                  _jax_samples, _jx, _project, _t,
                                  _two_view)
from xrsfm_tpu.mapper import kernels as JK
from xrsfm_tpu.ops import epipolar as JE
from xrsfm_tpu.utils import camera as JC
from xrsfm_tpu_torch.mapper import kernels as TK
from xrsfm_tpu_torch.ops import epipolar as TE
from xrsfm_tpu_torch.utils import camera as TC

torch.set_num_threads(2)


def _pairs(K=8, N=160, outliers=0.25):
    """K seeded two-view pairs at 5e-4 noise (0.25 px at f = 500) with a
    share of gross outliers, ragged masks, and the indices of each pair's
    true inliers."""
    uv1 = np.zeros((K, N, 2), np.float32)
    uv2 = np.zeros((K, N, 2), np.float32)
    mask = np.zeros((K, N), bool)
    true_inl = []
    for k in range(K):
        n = N - 10 * (k % 3)
        a, b, q2, t2, X = _two_view(700 + k, n, noise=5e-4,
                                    outliers=outliers)
        uv1[k, :n], uv2[k, :n], mask[k, :n] = a, b, True
        ok = np.abs(b - _project(q2, t2, X)).max(1) < 1e-2
        true_inl.append(np.nonzero(ok)[0])
    return uv1, uv2, mask, true_inl


def test_essential_ransac_8pt_matches_jax_branch():
    """use_5pt=False on 64 pairs at 25% gross outliers, 2 px threshold,
    the port with one seeded generator a pair and the JAX branch with one
    key a pair.  A float32 minimal solver is only as good as its sample,
    so the two are compared as draws (ROADMAP's rule): both succeed on
    every pair; the port's mean recall of the true inliers is no lower
    than JAX's less 0.03 (observed 0.976 against 0.972), and its median
    distance to the float64 8-point E of the true inliers (up to scale
    and sign) at most max(1e-2, 2x JAX's) (observed 0.0061 against
    0.0047).  No inlier lies in the padding, and the counts are the
    masks' sums."""
    uv1, uv2, mask, true_inl = _pairs(K=64)
    K = len(uv1)
    th = np.full(K, (2.0 / 500.0) ** 2, np.float32)
    gens = [torch.Generator().manual_seed(31 + k) for k in range(K)]
    E_t, inl_t, n_t, ok_t = (a.numpy() for a in TK.essential_ransac(
        *_t(uv1, uv2, mask, th), generators=gens, use_5pt=False))
    run_j = jax.jit(jax.vmap(
        lambda k, a, b, m, t: JK.essential_ransac(k, a, b, m, t,
                                                  use_5pt=False)))
    keys = jnp.stack([jax.random.PRNGKey(31 + k) for k in range(K)])
    E_j, inl_j, _, ok_j = (np.asarray(a) for a in run_j(
        keys, *_jx(uv1, uv2, mask, th)))
    assert ok_t.all() and ok_j.all()
    rec_t = np.mean([inl_t[k][true_inl[k]].mean() for k in range(K)])
    rec_j = np.mean([inl_j[k][true_inl[k]].mean() for k in range(K)])
    assert rec_t >= rec_j - 0.03, (rec_t, rec_j)
    d_t, d_j = [], []
    for k in range(K):
        truth = np.zeros(len(mask[k]), bool)
        truth[true_inl[k]] = True
        ref = _essential_8pt_float64(uv1[k], uv2[k], truth)
        d_t.append(_e_dist(E_t[k], ref))
        d_j.append(_e_dist(E_j[k], ref))
    assert np.median(d_t) <= max(1e-2, 2.0 * np.median(d_j)), (
        np.median(d_t), np.median(d_j))
    assert not (inl_t & ~mask).any()
    np.testing.assert_array_equal(n_t, inl_t.sum(axis=1))


def test_essential_ransac_8pt_on_jax_samples():
    """Fed the JAX branch's own 512 samples of 8 indices a pair
    (sample_idx [B, 512, 8], drawn after ransac.py's key split), 16 pairs:
    success equal, the port's inlier count at least JAX's less max(2, 1%)
    on every pair and equal on at least 12 (observed 15, the other one
    higher).  Samples of 5 indices give the 8-point solver too few points,
    and no pair succeeds."""
    uv1, uv2, mask, _ = _pairs(K=16)
    K = len(uv1)
    th = np.full(K, (2.0 / 500.0) ** 2, np.float32)
    seeds = [31 + k for k in range(K)]
    idx = _jax_samples(seeds, mask, 512, 8)
    _, _, n_t, ok_t = (a.numpy() for a in TK.essential_ransac(
        *_t(uv1, uv2, mask, th), sample_idx=idx, use_5pt=False))
    run_j = jax.jit(jax.vmap(
        lambda k, a, b, m, t: JK.essential_ransac(k, a, b, m, t,
                                                  use_5pt=False)))
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    _, _, n_j, ok_j = (np.asarray(a) for a in run_j(
        keys, *_jx(uv1, uv2, mask, th)))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert np.all(n_t >= n_j - np.maximum(2, 0.01 * n_j)), (n_t, n_j)
    assert np.sum(n_t == n_j) >= 12, (n_t, n_j)
    ok5 = TK.essential_ransac(*_t(uv1, uv2, mask, th),
                              sample_idx=idx[:, :64, :5], num_hypotheses=64,
                              use_5pt=False)[3]
    assert not bool(ok5.any())


_RAW = [
    (JC.SIMPLE_PINHOLE, [500.0, 320.0, 240.0]),
    (JC.PINHOLE, [500.0, 510.0, 320.0, 240.0]),
    (JC.SIMPLE_RADIAL, [480.0, 300.0, 200.0, 0.05]),
    (JC.RADIAL, [520.0, 321.0, 239.0, -0.03, 0.004]),
    (JC.OPENCV, [480.0, 505.0, 320.0, 240.0, 0.06, -0.02, 0.002, -0.001]),
]


@pytest.mark.parametrize("with_sizes", [False, True])
def test_make_cameras_matches_jax(with_sizes):
    """make_cameras over every supported model id (tests/test_camera.py's
    examples): params [N, 8] float32, model ids, widths and heights int32
    (zeros when not given), and the focal property equal to the JAX
    package's within 1e-6 relative; projections of the batch equal each
    camera's own."""
    ids = [m for m, _ in _RAW]
    params = [p for _, p in _RAW]
    sizes = (([640, 800, 1024, 320, 1920], [480, 600, 768, 240, 1080])
             if with_sizes else (None, None))
    ct = TC.make_cameras(ids, params, *sizes, device="cpu")
    cj = JC.make_cameras(ids, params, *sizes)
    assert isinstance(ct, TC.Cameras)
    assert ct.params.shape == (5, 8) and ct.params.dtype == torch.float32
    for f in ("model_id", "width", "height"):
        a = getattr(ct, f)
        assert a.dtype == torch.int32, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(cj, f)))
    np.testing.assert_allclose(ct.params.numpy(), np.asarray(cj.params),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(ct.focal.numpy(), np.asarray(cj.focal),
                               rtol=1e-6, atol=0)
    uv = torch.full((5, 2), 0.1)
    xy = TC.normalized_to_image(ct.params, uv)
    for i, (m, p) in enumerate(_RAW):
        one = torch.from_numpy(TC.canonicalize_params(m, p).astype(np.float32))
        torch.testing.assert_close(xy[i], TC.normalized_to_image(one, uv[i]))


def test_epipolar_residual_matches_jax():
    """epipolar_residual, the alias of sampson_error, on a batch of 3
    fundamental matrices and 200 seeded pixel correspondences each: equal
    to the JAX package's within 1e-6 relative, relative to the size of
    the terms that x2^T F x1 sums (float32 products summed in another
    order differ by a few ulps of those terms, not of a residual that
    cancels to near zero), and to the port's sampson_error bit for bit."""
    rng = np.random.default_rng(12)
    F = rng.normal(size=(3, 3, 3)).astype(np.float32)
    x1 = rng.uniform(0, 640, (3, 200, 2)).astype(np.float32)
    x2 = rng.uniform(0, 640, (3, 200, 2)).astype(np.float32)
    got = TE.epipolar_residual(*_t(F, x1, x2)).numpy()
    exp = np.asarray(jax.jit(JE.epipolar_residual)(*_jx(F, x1, x2)))
    p1 = np.concatenate([x1, np.ones((3, 200, 1), np.float32)], -1)
    p2 = np.concatenate([x2, np.ones((3, 200, 1), np.float32)], -1)
    Fx1 = np.einsum("bij,bnj->bni", F.astype(np.float64), p1)
    Ftx2 = np.einsum("bji,bnj->bni", F.astype(np.float64), p2)
    den = (Fx1[..., :2] ** 2).sum(-1) + (Ftx2[..., :2] ** 2).sum(-1)
    terms = np.einsum("bni,bij,bnj->bn", np.abs(p2), np.abs(F), np.abs(p1))
    np.testing.assert_array_less(np.abs(got - exp), 1e-6 * terms**2 / den)
    assert np.array_equal(got, TE.sampson_error(*_t(F, x1, x2)).numpy())


def _roots_index_last(coeffs, iters):
    """ops/poly.poly_roots's Durand-Kerner iteration written with the root
    index last, for the bit check."""
    from xrsfm_tpu_torch.ops.poly import _cdiv, _cmul

    c = coeffs / torch.where(coeffs[..., :1].abs() < 1e-12, 1e-12,
                             coeffs[..., :1])
    d = c.shape[-1] - 1
    k1 = torch.arange(1, d + 1, dtype=torch.float32)
    R = (2.0 * ((c[..., 1:].abs() + 1e-30) ** (1.0 / k1)).amax(dim=-1)
         ).clamp(1e-6, 1e6)[..., None]
    c = c / R ** torch.arange(d + 1, dtype=torch.float32)
    k = torch.arange(d)
    ang = torch.tensor(math.atan2(0.9, 0.4), dtype=torch.float32) * (k + 1)
    mag = torch.tensor(math.sqrt(0.4**2 + 0.9**2),
                       dtype=torch.float32) ** ((k + 1) % 7 + 1)
    zr = (mag * torch.cos(ang)).expand(c[..., 1:].shape)
    zi = (mag * torch.sin(ang)).expand(c[..., 1:].shape)
    eye = torch.eye(d)
    for _ in range(iters):
        dr = zr[..., :, None] - zr[..., None, :] + eye
        di = zi[..., :, None] - zi[..., None, :]
        denr, deni = torch.ones_like(zr), torch.zeros_like(zi)
        for j in range(d):
            denr, deni = _cmul(denr, deni, dr[..., :, j], di[..., :, j])
        pr, pi = torch.ones_like(zr), torch.zeros_like(zi)
        for i in range(1, d + 1):
            pr, pi = _cmul(pr, pi, zr, zi)
            pr = pr + c[..., i][..., None]
        qr, qi = _cdiv(pr, pi, denr, deni)
        zr, zi = zr - qr, zi - qi
    return zr * R, zi * R


@pytest.mark.parametrize("shape,iters", [((16, 64, 4), 60), ((9, 5), 60),
                                         ((4, 8, 11), 80), ((4,), 60)])
def test_poly_roots_keep_their_bits(shape, iters):
    """poly_roots iterates with the root index first (contiguous operands,
    faster on a CPU); every root's real and imaginary part equals the
    index-last iteration's bit for bit (NaN where it is NaN), for the
    7-point cubic, P3P's quartic and the 5-point degree-10 polynomial,
    with coefficients over six decades and a vanishing leading one."""
    from xrsfm_tpu_torch.ops import poly

    g = torch.Generator().manual_seed(len(shape) * 100 + shape[-1])
    c = torch.randn(shape, generator=g) * torch.logspace(-3, 3, shape[-1])
    c.view(-1, shape[-1])[0, 0] = 0.0
    for got, want in zip(poly.poly_roots(c, iters=iters),
                         _roots_index_last(c, iters)):
        assert got.shape == want.shape
        assert bool(((got == want) | (got.isnan() & want.isnan())).all())
