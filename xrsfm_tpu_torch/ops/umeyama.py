"""Umeyama similarity alignment, for the ATE evaluation (host numpy copy
of xrsfm_tpu/ops/umeyama.py; reference: src/geometry/umeyama.h:18-75)."""

from __future__ import annotations

import numpy as np


def umeyama(src, dst, with_scale: bool = True):
    """Least-squares similarity dst ~ s * R @ src + t.  src, dst [N, 3].
    Returns (s, R [3, 3], t [3])."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(d) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(gt_centers, est_centers, with_scale: bool = True) -> float:
    """Absolute trajectory error after similarity alignment."""
    s, R, t = umeyama(est_centers, gt_centers, with_scale)
    aligned = (s * (np.asarray(est_centers) @ R.T)) + t
    err = np.linalg.norm(aligned - np.asarray(gt_centers), axis=-1)
    return float(np.sqrt(np.mean(err**2)))
