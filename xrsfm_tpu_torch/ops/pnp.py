"""Batched absolute-pose estimation: P3P and pose refinement (port of
xrsfm_tpu/ops/pnp.py).

  * P3P minimal solver (reference: P3PEstimator,
    src/geometry/colmap/estimators/absolute_pose.cc:50-186): Grunert's
    distance quartic rooted with the batched Durand-Kerner iteration, then
    Kabsch absolute orientation;
  * pose refinement (reference: Ceres Huber refine, src/geometry/pnp.cc:39-71):
    fixed-iteration Levenberg-Marquardt on Huber-weighted normalized
    reprojection with the analytic 6-dof Jacobian.

Every function takes leading batch dimensions where the JAX package vmaps.
"""

from __future__ import annotations

import torch

from . import linalg, poly
from ..utils import geometry as G


def kabsch(src, dst, weights):
    """Weighted rigid alignment dst ~ R @ src + t.  src, dst [..., N, 3],
    weights [..., N].  Returns (R [..., 3, 3], t [..., 3])."""
    w = weights[..., None]
    wsum = w.sum(dim=-2, keepdim=True).clamp_min(1e-9)
    cs = (src * w).sum(dim=-2, keepdim=True) / wsum
    cd = (dst * w).sum(dim=-2, keepdim=True) / wsum
    H = torch.einsum("...ni,...nj->...ij", (src - cs) * w, dst - cd)
    U, _, Vh = linalg.svd(H)
    V = Vh.transpose(-1, -2)
    d = torch.linalg.det(V @ U.transpose(-1, -2))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (V * D[..., None, :]) @ U.transpose(-1, -2)  # V diag(1,1,d) U^T
    t = cd[..., 0, :] - torch.einsum("...ij,...j->...i", R, cs[..., 0, :])
    return R, t


def p3p(xyz, uv):
    """Grunert P3P: xyz [..., 3, 3] world points, uv [..., 3, 2] normalized.
    Returns up to 4 poses Tcw: (q [..., 4, 4], t [..., 4, 3], valid [..., 4])."""
    f = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)  # bearings
    P1, P2, P3 = xyz[..., 0, :], xyz[..., 1, :], xyz[..., 2, :]
    a2 = ((P2 - P3) ** 2).sum(-1)
    b2 = ((P1 - P3) ** 2).sum(-1)
    c2 = ((P1 - P2) ** 2).sum(-1)
    ca = (f[..., 1, :] * f[..., 2, :]).sum(-1)  # cos(alpha): P2-P3
    cb = (f[..., 0, :] * f[..., 2, :]).sum(-1)  # cos(beta):  P1-P3
    cg = (f[..., 0, :] * f[..., 1, :]).sum(-1)  # cos(gamma): P1-P2

    b2s = b2.clamp_min(1e-12)
    acb = (a2 - c2) / b2s
    apcb = (a2 + c2) / b2s
    bcb = (b2 - c2) / b2s
    bab = (b2 - a2) / b2s

    A4 = (acb - 1.0) ** 2 - 4.0 * (c2 / b2s) * ca**2
    A3 = 4.0 * (
        acb * (1.0 - acb) * cb
        - (1.0 - apcb) * ca * cg
        + 2.0 * (c2 / b2s) * ca**2 * cb
    )
    A2 = 2.0 * (
        acb**2
        - 1.0
        + 2.0 * acb**2 * cb**2
        + 2.0 * bcb * ca**2
        - 4.0 * apcb * ca * cb * cg
        + 2.0 * bab * cg**2
    )
    A1 = 4.0 * (
        -acb * (1.0 + acb) * cb
        + 2.0 * (a2 / b2s) * cg**2 * cb
        - (1.0 - apcb) * ca * cg
    )
    A0 = (1.0 + acb) ** 2 - 4.0 * (a2 / b2s) * cg**2

    coeffs = torch.stack([A4, A3, A2, A1, A0], dim=-1)
    v, vvalid = poly.real_roots(coeffs, imag_tol=1e-3)  # [..., 4]
    acb, cb, ca, cg, b2 = (x[..., None] for x in (acb, cb, ca, cg, b2))

    denom_u = 2.0 * (cg - v * ca)
    denom_u = torch.where(denom_u.abs() < 1e-9, 1e-9, denom_u)
    u = ((-1.0 + acb) * v**2 - 2.0 * acb * cb * v + 1.0 + acb) / denom_u

    s1sq = b2 / (1.0 + v**2 - 2.0 * v * cb).clamp_min(1e-12)
    s1 = torch.sqrt(s1sq.clamp_min(0.0))
    s2 = u * s1
    s3 = v * s1
    valid = vvalid & (s1 > 0) & (s2 > 0) & (s3 > 0)

    s = torch.stack([s1, s2, s3], dim=-1)  # [..., 4, 3]
    pc = s[..., None] * f[..., None, :, :]  # [..., 4, 3, 3]
    pw = xyz[..., None, :, :].expand(pc.shape)
    R, t = kabsch(pw, pc, torch.ones_like(pc[..., 0]))
    return G.rotmat_to_quat(R), t, valid


def pnp_residuals(q, t, uv, xyz):
    """Squared normalized reprojection error of S poses against N points:
    q [..., S, 4], t [..., S, 3], uv [..., N, 2], xyz [..., N, 3] ->
    [..., S, N].  Cheirality failures get +inf."""
    pc = G.pose_apply(q[..., :, None, :], t[..., :, None, :],
                      xyz[..., None, :, :])
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    err = ((proj - uv[..., None, :, :]) ** 2).sum(dim=-1)
    return torch.where(z > 0, err, torch.inf)


def refine_pose(q, t, uv, xyz, weights, iters: int = 10,
                huber_delta=0.01, damping: float = 1e-4):
    """Fixed-iteration LM pose-only refinement on Huber-weighted normalized
    reprojection.  q [..., 4], t [..., 3], uv [..., N, 2], xyz [..., N, 3],
    weights [..., N] (0 masks an observation out); huber_delta a float or
    a [...] tensor.

    Jacobian wrt the right-multiplicative update (dw, dt), pc = R x + t:
      d pc / d dw = -R [x]_x,  d pc / d dt = I,
      d proj / d pc = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]]."""
    hd = torch.as_tensor(huber_delta, dtype=uv.dtype, device=uv.device)
    hd = hd[..., None] if hd.dim() else hd
    eye6 = torch.eye(6, dtype=q.dtype, device=q.device)

    def cost(qq, tt, good):
        rr = pnp_residuals(qq[..., None, :], tt[..., None, :], uv, xyz)[..., 0, :]
        rr = torch.where(torch.isfinite(rr), rr, 1e6)
        rn_ = torch.sqrt(rr)
        hw = torch.where(rn_ > hd, hd * (2 * rn_ - hd), rr)
        return torch.where(good, weights * hw, 0.0).sum(dim=-1)

    for _ in range(iters):
        R = G.quat_to_rotmat(q)
        pc = G.pose_apply(q[..., None, :], t[..., None, :], xyz)  # [..., N, 3]
        z = pc[..., 2]
        good = (z > 1e-6) & (weights > 0)
        zs = torch.where(good, z, 1.0)
        proj = pc[..., :2] / zs[..., None]
        r = proj - uv
        rn = torch.linalg.norm(r, dim=-1)
        hub = torch.where(rn > hd, hd / rn.clamp_min(1e-12), 1.0)
        wts = torch.where(good, weights * hub, 0.0)

        inv_z = 1.0 / zs
        zero = torch.zeros_like(inv_z)
        dproj_dpc = torch.stack([
            torch.stack([inv_z, zero, -pc[..., 0] * inv_z**2], dim=-1),
            torch.stack([zero, inv_z, -pc[..., 1] * inv_z**2], dim=-1),
        ], dim=-2)  # [..., N, 2, 3]
        dpc_dw = -torch.einsum("...ij,...njk->...nik", R, G.skew(xyz))
        Jw = dproj_dpc @ dpc_dw
        J = torch.cat([Jw, dproj_dpc], dim=-1)  # [..., N, 2, 6]

        JW = J * wts[..., None, None]
        H = torch.einsum("...nri,...nrj->...ij", JW, J) + damping * eye6
        g = torch.einsum("...nri,...nr->...i", JW, r)
        delta = -linalg.solve(H, g[..., None])[..., 0]
        q2, t2 = G.pose_retract(q, t, delta)
        better = cost(q2, t2, good) < cost(q, t, good)
        q = torch.where(better[..., None], q2, q)
        t = torch.where(better[..., None], t2, t)
    return q, t
