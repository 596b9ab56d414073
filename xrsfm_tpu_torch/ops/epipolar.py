"""Batched two-view epipolar geometry (port of
xrsfm_tpu/ops/epipolar.py).

  * 7-point / 8-point fundamental matrix
    (reference: src/geometry/colmap/estimators/fundamental_matrix.cc:48-199)
  * Sampson error (reference: fundamental_matrix.cc:202-230)
  * 8-point essential matrix, E from a pose, essential decomposition and
    cheirality pose recovery (reference: src/geometry/essential.cc:221-487)
  * IRLS refinement of a relative pose on the essential manifold

Every function takes any leading batch dimensions.  Nullspaces come from
the symmetric eigendecomposition of A^T A (in float64, ops/linalg); the
7-point cubic det
constraint is recovered by evaluating det(a*F1 + (1-a)*F2) at 4 nodes and
inverting the fixed Vandermonde matrix, then rooted with ops/poly.
Call under `device.full_precision` on a GPU, so that the 9x9 normal
matrices are not formed in TF32.
"""

from __future__ import annotations

import math

import torch

from . import linalg, poly
from ..utils import geometry as G


def _hom(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def sampson_error(F, x1, x2):
    """Squared Sampson distance.  F [..., 3, 3]; x1, x2 [..., N, 2]
    (x2^T F x1 convention: x1 in image 1, x2 in image 2)."""
    p1 = _hom(x1)
    p2 = _hom(x2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, p1)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, p2)
    num = (p2 * Fx1).sum(dim=-1) ** 2
    den = (
        Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
        + Ftx2[..., 1] ** 2
    )
    return num / den.clamp_min(1e-12)


def epipolar_residual(F, x1, x2):
    """Symmetric squared epipolar line distance (COLMAP's F residual): the
    squared Sampson distance."""
    return sampson_error(F, x1, x2)


def normalize_points(x, mask):
    """Hartley normalization: centroid 0, mean distance sqrt(2).

    x [..., N, 2], mask [..., N] -> (T [..., 3, 3], xn [..., N, 2]).
    (reference: CenterAndNormalizeImagePoints,
    src/geometry/colmap/estimators/utils.cc)."""
    w = mask.to(x.dtype)
    cnt = w.sum(dim=-1).clamp_min(1.0)
    mean = (x * w[..., None]).sum(dim=-2) / cnt[..., None]
    d = torch.linalg.norm((x - mean[..., None, :]) * w[..., None], dim=-1)
    md = d.sum(dim=-1) / cnt
    s = math.sqrt(2.0) / md.clamp_min(1e-9)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], dim=-1),
        torch.stack([zero, s, -s * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return T, (x - mean[..., None, :]) * s[..., None, None]


def _epipolar_nullspace(x1, x2, weights, num_vecs: int):
    """Eigenvectors of A^T A for the epipolar constraint rows.

    x1, x2 [..., N, 2]; weights [..., N].  Returns [..., 9, num_vecs]
    (ascending eigenvalue)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = torch.ones_like(u1)
    # row ordering: x2^T F x1 with F row-major
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], dim=-1
    )
    A = A * weights[..., None]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = linalg.eigh(AtA)
    return vecs[..., :num_vecs]


def fundamental_8pt(x1, x2, mask):
    """Normalized 8-point algorithm.  x1, x2 [..., N, 2] pixels, mask
    [..., N].  Returns (F [..., 3, 3], valid [...]).
    (reference: FundamentalMatrixEightPointEstimator,
    colmap/estimators/fundamental_matrix.cc:151-199)."""
    T1, xn1 = normalize_points(x1, mask)
    T2, xn2 = normalize_points(x2, mask)
    w = mask.to(x1.dtype)
    f = _epipolar_nullspace(xn1, xn2, w, 1)[..., 0]
    F = f.reshape(f.shape[:-1] + (3, 3))
    # rank-2 projection
    U, s, Vh = linalg.svd(F)
    s = torch.stack([s[..., 0], s[..., 1], torch.zeros_like(s[..., 2])], -1)
    F = (U * s[..., None, :]) @ Vh
    F = T2.transpose(-1, -2) @ F @ T1
    nrm = F[..., 2, 2]
    fro = torch.linalg.norm(F, dim=(-2, -1)) + 1e-12
    scale = torch.where(nrm.abs() > 1e-9, nrm, fro)
    F = F / scale[..., None, None]
    valid = mask.sum(dim=-1) >= 8
    return F, valid


_NODES = (0.0, 1.0, 2.0, 3.0)


def fundamental_7pt(x1, x2, mask):
    """7-point algorithm: up to 3 solutions of the cubic det constraint.

    x1, x2 [..., 7, 2], mask [..., 7].  Returns (F [..., 3, 3, 3], valid
    [..., 3]).  (reference: FundamentalMatrixSevenPointEstimator,
    colmap/estimators/fundamental_matrix.cc:48-148)."""
    T1, xn1 = normalize_points(x1, mask)
    T2, xn2 = normalize_points(x2, mask)
    w = mask.to(x1.dtype)
    basis = _epipolar_nullspace(xn1, xn2, w, 2)  # [..., 9, 2]
    F1 = basis[..., 0].reshape(basis.shape[:-2] + (3, 3))
    F2 = basis[..., 1].reshape(basis.shape[:-2] + (3, 3))

    # det(a F1 + (1 - a) F2) is cubic in a: sample at 4 nodes, interpolate
    nodes = torch.tensor(_NODES, dtype=x1.dtype, device=x1.device)
    a = nodes[:, None, None]
    dets = torch.linalg.det(a * F1[..., None, :, :]
                            + (1 - a) * F2[..., None, :, :])  # [..., 4]
    # Vandermonde for coeffs [a^3, a^2, a, 1]
    V = torch.stack([nodes**3, nodes**2, nodes, torch.ones_like(nodes)], -1)
    V = V.expand(dets.shape[:-1] + (4, 4))
    coeffs = torch.linalg.solve(V, dets[..., None])[..., 0]
    roots, rvalid = poly.real_roots(coeffs, imag_tol=1e-3)  # [..., 3]
    r = roots[..., :, None, None]
    Fs = r * F1[..., None, :, :] + (1 - r) * F2[..., None, :, :]
    Fs = T2.transpose(-1, -2)[..., None, :, :] @ Fs @ T1[..., None, :, :]
    nrm = torch.linalg.norm(Fs, dim=(-2, -1), keepdim=True)
    Fs = Fs / nrm.clamp_min(1e-12)
    valid = rvalid & (mask.sum(dim=-1) >= 7)[..., None]
    return Fs, valid


def essential_8pt(x1, x2, mask):
    """8-point essential matrix on normalized camera coordinates, projected
    to the essential manifold (singular values (s, s, 0)).  x1, x2
    [..., N, 2], mask [..., N].  Returns (E [..., 3, 3], valid [...])."""
    w = mask.to(x1.dtype)
    e = _epipolar_nullspace(x1, x2, w, 1)[..., 0]
    E = e.reshape(e.shape[:-1] + (3, 3))
    U, s, Vh = linalg.svd(E)
    sm = 0.5 * (s[..., 0] + s[..., 1])
    diag = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    E = (U * diag[..., None, :]) @ Vh
    E = E / torch.linalg.norm(E, dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    valid = mask.sum(dim=-1) >= 8
    return E, valid


def essential_from_pose(q, t):
    """E = [t]x R for the relative pose x2 = R x1 + t."""
    return G.skew(t) @ G.quat_to_rotmat(q)


def decompose_essential(E):
    """E [..., 3, 3] -> (R1, R2, t): the four hypotheses are (R1, t),
    (R1, -t), (R2, t), (R2, -t) (reference: essential.cc:221-281)."""
    U, _, Vh = linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[..., None, None]
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vh
    R2 = U @ W.transpose(0, 1) @ Vh
    t = U[..., :, 2]
    return R1, R2, t


def _depth_in_front(R, t, x1, x2, mask, max_depth=100.0):
    """Points with positive, bounded depth in both views after
    triangulation with cam1 = I, cam2 = (R, t).  R [..., 3, 3], t [..., 3],
    x1, x2 [..., N, 2].  Returns (count [...], ok [..., N])."""
    from . import triangulation as T

    shp = x1.shape[:-1]
    q2 = G.rotmat_to_quat(R)[..., None, :].expand(shp + (4,))
    t2 = t[..., None, :].expand(shp + (3,))
    qi = x1.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(shp + (4,))
    ti = x1.new_zeros(shp + (3,))
    X = T.triangulate_two_view(qi, ti, x1, q2, t2, x2)
    z1 = X[..., 2]
    z2 = G.pose_apply(q2, t2, X)[..., 2]
    ok = (z1 > 0) & (z1 < max_depth) & (z2 > 0) & (z2 < max_depth) & mask
    return ok.sum(dim=-1), ok


def recover_pose_from_essential(E, x1, x2, mask):
    """The decomposition of E with the best cheirality support; x are
    normalized coords.  Returns (q [..., 4], t [..., 3], num_good [...],
    good_mask [..., N]) (reference: check_essential_rt + decompose_rt,
    essential.cc:432-487)."""
    R1, R2, t = decompose_essential(E)
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    res = [_depth_in_front(R_, t_, x1, x2, mask) for R_, t_ in cands]
    counts = torch.stack([c for c, _ in res], dim=-1)  # [..., 4]
    masks = torch.stack([m for _, m in res], dim=-2)  # [..., 4, N]
    Rs = torch.stack([c[0] for c in cands], dim=-3)  # [..., 4, 3, 3]
    ts = torch.stack([c[1] for c in cands], dim=-2)  # [..., 4, 3]
    best = torch.argmax(counts, dim=-1)
    pick = best[..., None]
    R = torch.gather(Rs, -3, pick[..., None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    tb = torch.gather(ts, -2, pick[..., None].expand(best.shape + (1, 3)))[..., 0, :]
    n = torch.gather(counts, -1, pick)[..., 0]
    mb = torch.gather(masks, -2, pick[..., None].expand(
        best.shape + (1, masks.shape[-1])))[..., 0, :]
    return G.rotmat_to_quat(R), tb, n, mb


def _perp_basis(t):
    """Two unit vectors spanning t-perp, t [B, 3]."""
    ex = t.new_tensor([1.0, 0.0, 0.0]).expand_as(t)
    ey = t.new_tensor([0.0, 1.0, 0.0]).expand_as(t)
    a = torch.where(t[:, :1].abs() < 0.7, ex, ey)
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True).clamp_min(1e-12)
    return b1, torch.linalg.cross(t, b1, dim=-1)


def refine_essential_manifold(q0, t0, x1, x2, mask, th, iters: int = 10):
    """IRLS Gauss-Newton refinement of B relative poses on the essential
    manifold (5 dof: so(3) x the unit-sphere tangent), minimizing the
    truncated Sampson distance.  No reference counterpart (the reference
    never refines E beyond the 8-point refit, essential.cc:389-404).

    The 5-point RANSAC winner plus an algebraic refit stops short of the
    robust minimum in the rotation / lateral-translation valley of forward
    motion; iterating GN in the valley reaches the deeper minimum.

    q0 [B, 4], t0 [B, 3] (from recover_pose_from_essential), x1, x2
    [B, N, 2] normalized coords, mask [B, N], th [B] (or a float) the
    squared-Sampson inlier scale.  Returns (q, t) refined.  The per-pair
    Jacobian [B, N, 5] is forward-mode (the JAX package's jacfwd); each
    step is accepted on the device when it lowers the truncated cost."""
    from torch.func import jvp, vmap

    B = q0.shape[0]
    mk = mask.to(x1.dtype)
    th = torch.as_tensor(th, dtype=x1.dtype, device=x1.device).expand(B)[:, None]
    eye5 = torch.eye(5, dtype=x1.dtype, device=x1.device)

    def res_of(d, q, t):
        q2 = G.quat_mul(G.so3_exp_quat(d[:, :3]), q)
        b1, b2 = _perp_basis(t)
        t2 = t + d[:, 3:4] * b1 + d[:, 4:5] * b2
        t2 = t2 / torch.linalg.norm(t2, dim=-1, keepdim=True).clamp_min(1e-12)
        s = sampson_error(essential_from_pose(q2, t2), x1, x2)  # [B, N]
        return torch.sqrt(s + 1e-16), q2, t2, s

    q, t = q0, t0
    zero = x1.new_zeros((B, 5))
    tangents = eye5[:, None, :].expand(5, B, 5)
    for _ in range(iters):
        r, _, _, s = res_of(zero, q, t)
        # truncated-quadratic IRLS: inliers weight 1, outliers ~ th/s
        w = mk * torch.minimum(torch.ones_like(s), th / s.clamp_min(1e-16))
        J = vmap(lambda v: jvp(lambda d: res_of(d, q, t)[0], (zero,), (v,))[1]
                 )(tangents).permute(1, 2, 0)  # [B, N, 5]
        Jw = J * w[..., None]
        H = Jw.transpose(1, 2) @ J + 1e-8 * eye5
        g = (Jw.transpose(1, 2) @ r[..., None])[..., 0]
        d = -linalg.solve(H, g[..., None])[..., 0]
        # reject steps outside the linearization's validity
        d = torch.where(torch.linalg.norm(d[:, :3], dim=-1, keepdim=True) < 0.3,
                        d, 0.0)
        _, q2, t2, s2 = res_of(d, q, t)
        c_old = (mk * torch.minimum(s, th)).sum(dim=-1)
        c_new = (mk * torch.minimum(s2, th)).sum(dim=-1)
        accept = (c_new < c_old)[:, None]
        q = torch.where(accept, q2, q)
        t = torch.where(accept, t2, t)
    return q, t
