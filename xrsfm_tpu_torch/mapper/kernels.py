"""Batched device kernels of the incremental mapping loop (port of
xrsfm_tpu/mapper/kernels.py).

Every function takes tensors with a leading problem dimension B (the JAX
package's vmap) and runs on their device:
  * pnp_ransac_batch: LO-RANSAC<P3P> registration with an EPnP / IPPE /
    LM-refine local stage (reference: SolvePnP_colmap, pnp.cc:253-272);
  * robust_triangulate: all C(V, 2) two-view hypotheses of each
    observation set scored at once, then a masked multiview refit
    (reference: EstimateTriangulation, triangulation.cc:167-197);
  * essential_ransac / init_probe_batch / init_pair_stats: init-pair
    verification (reference: solve_essential + CheckInitFramePair,
    essential.cc:389-404, map_initializer.cc:13-139).

RANSAC samples come from one torch.Generator per problem, or from the
caller as sample indices (the tests feed the JAX sampler's).  Call under
`device.full_precision()` on a GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import full_precision
from ..ops import epipolar, epnp, pnp, ransac, triangulation as tri
from ..ops.essential5pt import essential_5pt
from ..utils import geometry as G


def _thresholds(th, B, like):
    return torch.as_tensor(th, dtype=like.dtype, device=like.device).expand(B)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


def pnp_ransac_batch(uv, xyz, mask, thresholds, generators=None,
                     sample_idx=None, num_hypotheses: int = 256):
    """Registration of B frames at once.  uv [B, N, 2] normalized, xyz
    [B, N, 3], mask [B, N], thresholds [B] (squared normalized).  Returns
    (q [B, 4], t [B, 3], inliers [B, N], num_inliers [B], success [B])."""
    B, N = mask.shape
    th = _thresholds(thresholds, B, uv)

    def estimate(sampled, sample_valid):
        uv_s, xyz_s = sampled
        q, t, valid = pnp.p3p(xyz_s, uv_s)
        return (q, t), valid & sample_valid.all(dim=-1, keepdim=True)

    def residual(models, data):
        q, t = models
        return pnp.pnp_residuals(q, t, *data)

    res = ransac.ransac(
        (uv, xyz), mask, estimate, residual, sample_size=3, threshold=th,
        num_hypotheses=num_hypotheses, refit_fn=None, generators=generators,
        sample_idx=sample_idx,
    )
    q, t = res.model
    # LO stage (reference: LORANSAC<P3P, EPNP> + Ceres refine,
    # pnp.cc:39-71): refit the global closed-form solvers on the inlier
    # set, LM-polish every candidate, keep the best-supported one if it
    # supports at least as many points as the RANSAC winner
    w = res.inliers.to(uv.dtype)
    q_e, t_e = epnp.epnp(xyz, uv, w)
    q_p, t_p = epnp.ippe(xyz, uv, w)
    cand_q = torch.stack([q, q_e, q_p[:, 0], q_p[:, 1]], dim=1)  # [B, 4, 4]
    cand_t = torch.stack([t, t_e, t_p[:, 0], t_p[:, 1]], dim=1)
    C = cand_q.shape[1]
    q_r, t_r = pnp.refine_pose(
        cand_q, cand_t, uv[:, None].expand(B, C, N, 2),
        xyz[:, None].expand(B, C, N, 3), w[:, None].expand(B, C, N), iters=10)
    inl_all = (pnp.pnp_residuals(q_r, t_r, uv, xyz) <= th[:, None, None]) \
        & mask[:, None, :]
    support = inl_all.sum(dim=-1)  # [B, 4]
    bi = torch.arange(B, device=uv.device)
    best = torch.argmax(support, dim=-1)
    better = support[bi, best] >= res.num_inliers
    q3 = torch.where(better[:, None], q_r[bi, best], q)
    t3 = torch.where(better[:, None], t_r[bi, best], t)
    inl3 = torch.where(better[:, None], inl_all[bi, best], res.inliers)
    return q3, t3, inl3, inl3.sum(dim=-1), res.success


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------


def robust_triangulate(q, t, uv, mask, th, min_angle):
    """q [B, V, 4], t [B, V, 3], uv [B, V, 2] normalized, mask [B, V];
    th squared normalized, min_angle radians (floats).  Returns xyz
    [B, 3], obs_ok [B, V], ok [B], angle [B]."""
    B, V = mask.shape
    th, min_angle = float(th), float(min_angle)
    ii_np, jj_np = np.triu_indices(V, k=1)
    ii = torch.as_tensor(ii_np, device=q.device)
    jj = torch.as_tensor(jj_np, device=q.device)
    X = tri.triangulate_two_view(
        q[:, ii], t[:, ii], uv[:, ii], q[:, jj], t[:, jj], uv[:, jj]
    )  # [B, H, 3]
    hyp_valid = mask[:, ii] & mask[:, jj]
    err = tri.reprojection_errors(q[:, None], t[:, None], uv[:, None],
                                  X[:, :, None, :])  # [B, H, V]
    good = (err <= th) & mask[:, None, :]
    ang_h = tri.triangulation_angle(G.pose_center(q[:, ii], t[:, ii]),
                                    G.pose_center(q[:, jj], t[:, jj]), X)
    hyp_valid = hyp_valid & (ang_h >= min_angle)
    score = torch.where(hyp_valid, good.sum(dim=-1), -1)
    bi = torch.arange(B, device=q.device)
    best = torch.argmax(score, dim=-1)
    obs_ok = good[bi, best]
    Xr = tri.triangulate_multiview(q, t, uv, obs_ok)
    err_r = tri.reprojection_errors(q, t, uv, Xr[:, None, :])
    obs_ok_r = (err_r <= th) & mask
    use_refit = obs_ok_r.sum(dim=-1) >= obs_ok.sum(dim=-1)
    Xf = torch.where(use_refit[:, None], Xr, X[bi, best])
    obs_f = torch.where(use_refit[:, None], obs_ok_r, obs_ok)
    centers = G.pose_center(q, t)
    pair_ok = obs_f[:, ii] & obs_f[:, jj]
    ang_pairs = tri.triangulation_angle(centers[:, ii], centers[:, jj],
                                        Xf[:, None, :])
    max_ang = torch.where(pair_ok, ang_pairs, 0.0).amax(dim=-1)
    ok = (obs_f.sum(dim=-1) >= 2) & (score[bi, best] >= 2) \
        & (max_ang >= min_angle)
    return Xf, obs_f & ok[:, None], ok, max_ang


def reproj_errors_batch(q, t, uv, xyz):
    """q [N, 4], t [N, 3], uv [N, 2] normalized, xyz [N, 3] -> (err [N]
    squared normalized, z [N])."""
    return tri.reprojection_errors(q, t, uv, xyz), tri.depths(q, t, xyz)


def refine_poses_batch(q, t, uv, xyz, w, huber_delta, iters: int = 10):
    """Motion-only LM refinement of B poses against fixed points: q [B, 4],
    t [B, 3], uv [B, N, 2], xyz [B, N, 3], w [B, N], huber_delta [B]
    (normalized units)."""
    return pnp.refine_pose(q, t, uv, xyz, w, iters=iters,
                           huber_delta=huber_delta)


# ---------------------------------------------------------------------------
# two-view initialization
# ---------------------------------------------------------------------------


def essential_ransac(uv1, uv2, mask, thresholds, generators=None,
                     sample_idx=None, num_hypotheses: int = 512,
                     use_5pt: bool = True):
    """Essential LO-RANSAC over B pairs: 5-point minimal hypotheses (up to
    10 per sample, so num_hypotheses // 8 samples, at least 64), or with
    use_5pt=False 8-point hypotheses (one model per sample,
    num_hypotheses samples), and an 8-point refit on the winner's
    inliers.  sample_idx is [B, samples, 5 or 8].  Returns (E [B, 3, 3],
    inliers [B, N], num_inliers [B], success [B])."""
    if use_5pt:
        def estimate(sampled, sample_valid):
            Es, valid = essential_5pt(*sampled, sample_valid)
            return Es, valid & sample_valid.all(dim=-1, keepdim=True)

        sample_size = 5
        hypotheses = max(num_hypotheses // 8, 64)
    else:
        def estimate(sampled, sample_valid):
            E, valid = epipolar.essential_8pt(*sampled, sample_valid)
            return E[:, :, None], (valid & sample_valid.all(dim=-1))[..., None]

        sample_size = 8
        hypotheses = num_hypotheses

    def residual(E, data):
        x1, x2 = data
        return epipolar.sampson_error(E, x1[:, None], x2[:, None])

    def refit(data, inl):
        return epipolar.essential_8pt(*data, inl)

    res = ransac.ransac(
        (uv1, uv2), mask, estimate, residual, sample_size=sample_size,
        threshold=_thresholds(thresholds, mask.shape[0], uv1),
        num_hypotheses=hypotheses, refit_fn=refit,
        lo_iters=2, generators=generators, sample_idx=sample_idx,
    )
    return res.model, res.inliers, res.num_inliers, res.success


def init_pair_stats(E, uv1, uv2, inliers):
    """Decompose E, triangulate and measure the ray angles of B pairs.
    Returns (q [B, 4], t [B, 3], n_cheirality [B], xyz [B, N, 3],
    good [B, N], angles [B, N]) (reference: CheckInitFramePair,
    map_initializer.cc:13-139)."""
    q, t, n_good, good = epipolar.recover_pose_from_essential(E, uv1, uv2,
                                                              inliers)
    shp = uv1.shape[:-1]
    qi = uv1.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(shp + (4,))
    ti = uv1.new_zeros(shp + (3,))
    X = tri.triangulate_two_view(
        qi, ti, uv1, q[:, None].expand(shp + (4,)),
        t[:, None].expand(shp + (3,)), uv2)
    c2 = G.pose_center(q, t)[:, None, :]
    ang = tri.triangulation_angle(torch.zeros_like(c2), c2, X)
    return q, t, n_good, X, good, ang


def init_probe_batch(uv1, uv2, mask, thresholds, generators=None,
                     sample_idx=None):
    """essential_ransac + init_pair_stats for K candidate pairs: uv1/uv2
    [K, N, 2], mask [K, N], thresholds [K].  Returns (q [K, 4], t [K, 3],
    n_good [K], X [K, N, 3], good [K, N], ang [K, N], n_inl [K],
    success [K])."""
    E, inl, n_inl, success = essential_ransac(
        uv1, uv2, mask, thresholds, generators=generators,
        sample_idx=sample_idx)
    return init_pair_stats(E, uv1, uv2, inl) + (n_inl, success)


def on_device(fn, *arrays, device, **kwargs):
    """fn on the numpy arrays moved to `device` (under full precision);
    its tensor results come back as numpy arrays."""
    with full_precision():
        out = fn(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in arrays), **kwargs)
    return tuple(o.cpu().numpy() for o in out)
