"""Batched DLT triangulation, 2-view and N-view (port of
xrsfm_tpu/ops/triangulation.py; reference: src/geometry/triangluate_svd.cc:8-73,
src/geometry/colmap/base/triangulation.cc:40-160).

The homogeneous nullspace comes from eigh(A^T A); N-view problems carry
an observation mask so a fixed-width block triangulates ragged tracks.
"""

from __future__ import annotations

import torch

from . import linalg
from ..utils import geometry as G


def _dlt_point(A):
    """Smallest right-singular vector of A [..., m, 4] via eigh(A^T A)."""
    AtA = torch.einsum("...mi,...mj->...ij", A, A)
    _, vecs = linalg.eigh(AtA)
    h = vecs[..., :, 0]
    w = h[..., 3]
    w = torch.where(w.abs() < 1e-12, torch.where(w < 0, -1e-12, 1e-12), w)
    return h[..., :3] / w[..., None]


def _proj_rows(q, t, uv):
    """Two DLT rows per observation: uv [..., 2] normalized, pose Tcw.
    Returns [..., 2, 4]."""
    R = G.quat_to_rotmat(q)
    P = torch.cat([R, t[..., :, None]], dim=-1)  # [..., 3, 4]
    r0 = uv[..., 0:1, None] * P[..., 2:3, :] - P[..., 0:1, :]
    r1 = uv[..., 1:2, None] * P[..., 2:3, :] - P[..., 1:2, :]
    return torch.cat([r0, r1], dim=-2)


def triangulate_two_view(q1, t1, uv1, q2, t2, uv2):
    """2-view DLT over leading batch dims; uv undistorted normalized.
    Returns world points [..., 3]."""
    A = torch.cat([_proj_rows(q1, t1, uv1), _proj_rows(q2, t2, uv2)], dim=-2)
    return _dlt_point(A)


def triangulate_multiview(q, t, uv, mask):
    """N-view DLT: q [..., V, 4], t [..., V, 3], uv [..., V, 2], mask
    [..., V] (0 rows for invalid observations).  Returns [..., 3]."""
    rows = _proj_rows(q, t, uv) * mask[..., None, None].to(uv.dtype)
    A = rows.reshape(rows.shape[:-3] + (-1, 4))
    return _dlt_point(A)


def reprojection_errors(q, t, uv, xyz):
    """Squared reprojection error on the normalized plane; +inf behind the
    camera."""
    pc = G.pose_apply(q, t, xyz)
    z = pc[..., 2]
    zsafe = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zsafe[..., None]
    err = ((proj - uv) ** 2).sum(dim=-1)
    return torch.where(z > 0, err, torch.inf)


def depths(q, t, xyz):
    return G.pose_apply(q, t, xyz)[..., 2]


def triangulation_angle(center1, center2, xyz):
    """Ray-ray angle at the 3D point, radians."""
    return G.angle_between_rays(center1 - xyz, center2 - xyz)
