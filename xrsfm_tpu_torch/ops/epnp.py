"""Closed-form N-point absolute-pose solvers: EPnP and planar IPPE (port
of xrsfm_tpu/ops/epnp.py; the LO-RANSAC refiners of registration,
reference: EPNPEstimator, absolute_pose.cc:188-621).

  * epnp(): Lepetit et al.'s EPnP, 4 control points from the weighted PCA
    frame, a 12x12 nullspace eigenproblem, betas by Gauss-Newton on the
    control-point distances, pose by Kabsch;
  * ippe(): Collins & Bartoli's IPPE for the (near-)planar regime; returns
    both members of the planar two-fold ambiguity.

Everything is mask-weighted (padded observations carry weight 0) and
batched over leading dimensions.
"""

from __future__ import annotations

import torch

from . import linalg, pnp as PNP
from ..utils import geometry as G

_II = (0, 0, 0, 1, 1, 2)
_JJ = (1, 2, 3, 2, 3, 3)


def _weighted_pca(xyz, w):
    """(centroid [..., 3], eigvecs [..., 3, 3] ascending columns,
    eigvals [..., 3])."""
    wn = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    c0 = torch.einsum("...n,...ni->...i", wn, xyz)
    d = xyz - c0[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, d, d)
    evals, evecs = linalg.eigh(cov)
    return c0, evecs, evals


def _epnp_control_points(xyz, w):
    """Centroid + PCA axes scaled by the standard deviation: [..., 4, 3]."""
    c0, evecs, evals = _weighted_pca(xyz, w)
    s = torch.sqrt(evals.clamp_min(1e-10))
    return torch.stack([
        c0,
        c0 + s[..., 2:3] * evecs[..., :, 2],
        c0 + s[..., 1:2] * evecs[..., :, 1],
        c0 + s[..., 0:1] * evecs[..., :, 0],
    ], dim=-2)


def _barycentric(xyz, cw):
    """alphas [..., N, 4] with xyz = alphas @ cw and sum(alphas) = 1."""
    B = (cw[..., 1:, :] - cw[..., :1, :]).transpose(-1, -2)  # [..., 3, 3]
    eye = torch.eye(3, dtype=B.dtype, device=B.device)
    Binv = linalg.solve(B + 1e-9 * eye, eye.expand(B.shape))
    a123 = torch.einsum("...ij,...nj->...ni", Binv, xyz - cw[..., :1, :])
    a0 = 1.0 - a123.sum(dim=-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _epnp_M_kernel(alphas, uv, w):
    """The 4 smallest eigenvectors of M^T M as [..., 4 basis, 4 ctrl, 3]."""
    a = alphas
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    zeros = torch.zeros_like(a)
    shp = a.shape[:-1] + (12,)
    row_u = torch.stack([a, zeros, -a * u], dim=-1).reshape(shp)
    row_v = torch.stack([zeros, a, -a * v], dim=-1).reshape(shp)
    sw = torch.sqrt(w.clamp_min(0.0))[..., None]
    Mu = row_u * sw
    Mv = row_v * sw
    MtM = Mu.transpose(-1, -2) @ Mu + Mv.transpose(-1, -2) @ Mv
    _, evecs = linalg.eigh(MtM)
    V = evecs[..., :, :4]
    return V.transpose(-1, -2).reshape(V.shape[:-2] + (4, 4, 3))


def _ctrl_dists2(cc):
    """Squared distances of the 6 control-point pairs.  cc [..., 4, 3]."""
    d = cc[..., _II, :] - cc[..., _JJ, :]
    return (d * d).sum(dim=-1)


def epnp(xyz, uv, w, gn_iters: int = 6):
    """EPnP pose from N weighted 2D-3D correspondences: xyz [..., N, 3],
    uv [..., N, 2] normalized, w [..., N].  Returns (q [..., 4], t [..., 3])."""
    cw = _epnp_control_points(xyz, w)
    alphas = _barycentric(xyz, cw)
    V = _epnp_M_kernel(alphas, uv, w)  # [..., 4 basis, 4 ctrl, 3]
    rho = _ctrl_dists2(cw)  # [..., 6]

    d1 = _ctrl_dists2(V[..., 0, :, :])
    beta1 = torch.sqrt((rho * d1).sum(-1) / (d1 * d1).sum(-1).clamp_min(1e-12))
    zero = torch.zeros_like(beta1)
    beta = torch.stack([beta1, zero, zero, zero], dim=-1)

    dV = V[..., :, _II, :] - V[..., :, _JJ, :]  # [..., 4, 6, 3]
    eye4 = torch.eye(4, dtype=xyz.dtype, device=xyz.device)
    for _ in range(gn_iters):
        dv = torch.einsum("...k,...kez->...ez", beta, dV)
        f = (dv * dv).sum(dim=-1) - rho
        J = 2.0 * torch.einsum("...ez,...kez->...ek", dv, dV)  # [..., 6, 4]
        H = J.transpose(-1, -2) @ J + 1e-9 * eye4
        g = torch.einsum("...ek,...e->...k", J, f)
        beta = beta - linalg.solve(H, g[..., None])[..., 0]

    cc = torch.einsum("...k,...kcz->...cz", beta, V)  # camera control points
    pc = torch.einsum("...nc,...cz->...nz", alphas, cc)
    sign = torch.where((w * pc[..., 2]).sum(dim=-1) < 0, -1.0, 1.0)
    pc = pc * sign[..., None, None]
    R, t = PNP.kabsch(xyz, pc, w)
    return G.rotmat_to_quat(R), t


def _plane_frame(xyz, w):
    """(c0, M [..., 3, 3] world->plane rotation rows [e1; e2; n],
    planarity)."""
    c0, evecs, evals = _weighted_pca(xyz, w)
    e1 = evecs[..., :, 2]
    e2 = evecs[..., :, 1]
    n = torch.linalg.cross(e1, e2, dim=-1)
    M = torch.stack([e1, e2, n], dim=-2)
    planarity = evals[..., 0] / evals[..., 2].clamp_min(1e-12)
    return c0, M, planarity


def _homography_dlt(pq, uv, w):
    """DLT homography plane coords [..., N, 2] -> normalized image
    [..., N, 2], weights [..., N].  Returns H [..., 3, 3] (any scale)."""
    x, y = pq[..., 0], pq[..., 1]
    u, v = uv[..., 0], uv[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], dim=-1)
    sw = torch.sqrt(w.clamp_min(0.0))[..., None]
    A1 = r1 * sw
    A2 = r2 * sw
    AtA = A1.transpose(-1, -2) @ A1 + A2.transpose(-1, -2) @ A2
    _, evecs = linalg.eigh(AtA)
    return evecs[..., :, 0].reshape(evecs.shape[:-2] + (3, 3))


def ippe(xyz, uv, w):
    """Both planar-pose solutions from N weighted correspondences: xyz
    [..., N, 3], uv [..., N, 2], w [..., N].  Returns (q [..., 2, 4],
    t [..., 2, 3]) (Collins & Bartoli, IJCV 2014)."""
    c0, M, _ = _plane_frame(xyz, w)
    pq = torch.einsum("...ij,...nj->...ni", M, xyz - c0[..., None, :])[..., :2]
    H = _homography_dlt(pq, uv, w)
    h22 = H[..., 2, 2]
    Hs = H / torch.where(h22.abs() < 1e-12, 1e-12, h22)[..., None, None]
    v = Hs[..., :2, 2]  # image of the plane origin
    J = torch.stack([
        torch.stack([Hs[..., 0, 0] - v[..., 0] * Hs[..., 2, 0],
                     Hs[..., 0, 1] - v[..., 0] * Hs[..., 2, 1]], dim=-1),
        torch.stack([Hs[..., 1, 0] - v[..., 1] * Hs[..., 2, 0],
                     Hs[..., 1, 1] - v[..., 1] * Hs[..., 2, 1]], dim=-1),
    ], dim=-2)
    vb = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    vb = vb / torch.linalg.norm(vb, dim=-1, keepdim=True)
    e3 = torch.zeros_like(vb)
    e3[..., 2] = 1.0
    ax = torch.linalg.cross(e3, vb, dim=-1)
    s = torch.linalg.norm(ax, dim=-1)
    c = vb[..., 2]
    K = G.skew(ax)
    eye3 = torch.eye(3, dtype=v.dtype, device=v.device)
    Rv = eye3 + K + (K @ K) * ((1.0 - c) / (s * s).clamp_min(1e-12))[..., None, None]
    Rv = torch.where((s < 1e-9)[..., None, None], eye3, Rv)
    eye2 = torch.eye(2, dtype=v.dtype, device=v.device)
    Pv = torch.cat([eye2.expand(v.shape[:-1] + (2, 2)), -v[..., :, None]],
                   dim=-1)  # [I2 | -v]
    A2 = (Pv @ Rv)[..., :, :2]
    C = linalg.solve(A2, J)
    CtC = C.transpose(-1, -2) @ C
    tr = CtC[..., 0, 0] + CtC[..., 1, 1]
    det = CtC[..., 0, 0] * CtC[..., 1, 1] - CtC[..., 0, 1] * CtC[..., 1, 0]
    disc = torch.sqrt((tr * tr / 4.0 - det).clamp_min(0.0))
    lam1 = tr / 2.0 + disc
    lam2 = (tr / 2.0 - disc).clamp_min(0.0)
    d = 1.0 / torch.sqrt(lam1.clamp_min(1e-12))
    gamma = torch.sqrt((1.0 - lam2 / lam1.clamp_min(1e-12)).clamp_min(0.0))
    w2a = torch.stack([CtC[..., 0, 1], lam2 - CtC[..., 0, 0]], dim=-1)
    w2b = torch.stack([lam2 - CtC[..., 1, 1], CtC[..., 1, 0]], dim=-1)
    w2 = torch.where((torch.linalg.norm(w2a, dim=-1)
                      > torch.linalg.norm(w2b, dim=-1))[..., None], w2a, w2b)
    w2 = w2 / torch.linalg.norm(w2, dim=-1, keepdim=True).clamp_min(1e-12)
    Q_top = d[..., None, None] * C

    def unit(x):
        return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)

    def build(sign):
        b = sign * gamma[..., None] * w2
        q1 = unit(torch.cat([Q_top[..., :, 0], b[..., 0:1]], dim=-1))
        q2 = torch.cat([Q_top[..., :, 1], b[..., 1:2]], dim=-1)
        q2 = unit(q2 - (q1 * q2).sum(-1, keepdim=True) * q1)
        q3 = torch.linalg.cross(q1, q2, dim=-1)
        Q = torch.stack([q1, q2, q3], dim=-1)
        R_wc = (Rv @ Q) @ M  # world -> camera
        t_cam = d[..., None] * torch.cat([v, torch.ones_like(v[..., :1])], -1)
        t_wc = t_cam - torch.einsum("...ij,...j->...i", R_wc, c0)
        return G.rotmat_to_quat(R_wc), t_wc

    qa, ta = build(1.0)
    qb, tb = build(-1.0)
    return torch.stack([qa, qb], dim=-2), torch.stack([ta, tb], dim=-2)
