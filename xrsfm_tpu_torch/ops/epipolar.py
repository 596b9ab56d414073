"""Batched two-view epipolar geometry, fundamental-matrix part (port of
xrsfm_tpu/ops/epipolar.py:34-140).

  * 7-point / 8-point fundamental matrix
    (reference: src/geometry/colmap/estimators/fundamental_matrix.cc:48-199)
  * Sampson error (reference: fundamental_matrix.cc:202-230)

Every function takes any leading batch dimensions.  Nullspaces come from
the symmetric eigendecomposition of A^T A; the 7-point cubic det
constraint is recovered by evaluating det(a*F1 + (1-a)*F2) at 4 nodes and
inverting the fixed Vandermonde matrix, then rooted with ops/poly.
Call under `device.full_precision` on a GPU, so that the 9x9 normal
matrices are not formed in TF32.
"""

from __future__ import annotations

import math

import torch

from . import poly


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
    _, vecs = torch.linalg.eigh(AtA)
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
    U, s, Vh = torch.linalg.svd(F)
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
