"""Batched polynomial root finding for minimal solvers (port of
xrsfm_tpu/ops/poly.py).

A fixed-iteration Durand-Kerner (Weierstrass) simultaneous iteration over
explicit (re, im) float32 pairs: branch-free and batched over any leading
dimensions.  The pairs, the iteration count, the variable rescaling and the
starting points are those of the JAX package, so both find the same roots
in the same order.  Used by the 7-point cubic (reference equivalents use
companion-matrix eigenvalues: src/geometry/essential.cc:202-218).
"""

from __future__ import annotations

import math

import torch


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = (br * br + bi * bi).clamp_min(1e-30)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def poly_roots(coeffs: torch.Tensor, iters: int = 60):
    """Roots of a real polynomial, coefficients highest-degree first.

    coeffs: [..., d+1] real; returns (re [..., d], im [..., d]) float32.
    """
    coeffs = coeffs.float()
    dev = coeffs.device
    lead = coeffs[..., :1]
    lead = torch.where(lead.abs() < 1e-12, 1e-12, lead)
    c = coeffs / lead  # monic, real
    d = c.shape[-1] - 1

    # rescale the variable by the Fujiwara root bound so all roots lie in
    # ~the unit disk: float32 Durand-Kerner diverges when root magnitudes
    # are far from 1
    k1 = torch.arange(1, d + 1, dtype=torch.float32, device=dev)
    mags = c[..., 1:].abs() + 1e-30
    R = 2.0 * (mags ** (1.0 / k1)).amax(dim=-1)
    R = R.clamp(1e-6, 1e6)[..., None]  # [..., 1]
    # substitute z = R * w: coefficient of w^(d-k) is c_k / R^k
    c = c / R ** torch.arange(d + 1, dtype=torch.float32, device=dev)

    # initial guesses: powers of (0.4 + 0.9i) (inside/near the unit disk).
    # The iteration holds the root index first, z [d, ...]: every operand
    # below is then a contiguous block (the index last makes each op a
    # strided pass of stride d, several times slower on a CPU), and each
    # element sees the same operations as with the index last.
    k = torch.arange(d, device=dev)
    ang = torch.tensor(math.atan2(0.9, 0.4), dtype=torch.float32,
                       device=dev) * (k + 1)
    mag = torch.tensor(math.sqrt(0.4**2 + 0.9**2), dtype=torch.float32,
                       device=dev) ** ((k + 1) % 7 + 1)
    lead_shape = (d,) + (1,) * (c.dim() - 1)
    zr = (mag * torch.cos(ang)).reshape(lead_shape).expand(
        (d,) + c.shape[:-1])
    zi = (mag * torch.sin(ang)).reshape(lead_shape).expand(
        (d,) + c.shape[:-1])
    eye = torch.eye(d, dtype=torch.float32, device=dev).reshape(
        (d, d) + (1,) * (c.dim() - 1))

    for _ in range(iters):
        # denominator prod_{j != i} (z_i - z_j), with 1 on the diagonal
        dr = zr[:, None] - zr[None, :] + eye
        di = zi[:, None] - zi[None, :]
        denr, deni = torch.ones_like(zr), torch.zeros_like(zi)
        for j in range(d):
            denr, deni = _cmul(denr, deni, dr[:, j], di[:, j])
        # Horner evaluation of the monic polynomial at z
        pr, pi = torch.ones_like(zr), torch.zeros_like(zi)
        for i in range(1, d + 1):
            pr, pi = _cmul(pr, pi, zr, zi)
            pr = pr + c[..., i]
        qr, qi = _cdiv(pr, pi, denr, deni)
        zr, zi = zr - qr, zi - qi
    zr, zi = zr.movedim(0, -1), zi.movedim(0, -1)
    return zr * R, zi * R  # undo the variable scaling


def real_roots(coeffs: torch.Tensor, imag_tol: float = 1e-4,
               iters: int = 60):
    """(roots_real [..., d], valid [..., d]): a root is kept when its
    imaginary part is small relative to its magnitude."""
    zr, zi = poly_roots(coeffs, iters=iters)
    mag = torch.sqrt(zr * zr + zi * zi).clamp_min(1.0)
    return zr, zi.abs() < imag_tol * mag
