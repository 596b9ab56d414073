"""Batched COLMAP-compatible camera models (port of
xrsfm_tpu/utils/camera.py; reference: src/base/camera_model.hpp:93-286,
src/base/camera.hpp:10-108).

Every model is canonicalized at load time into one 8-float layout
(fx, fy, cx, cy, k1, k2, p1, p2): the five COLMAP models (SIMPLE_PINHOLE=0,
PINHOLE=1, SIMPLE_RADIAL=2, RADIAL=3, OPENCV=4) are all sub-models of
OPENCV, so the device code has one branch-free path.  Parameter vectors
are host numpy; the projection functions take torch tensors whose params
broadcast against the points' batch shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SIMPLE_PINHOLE = 0
PINHOLE = 1
SIMPLE_RADIAL = 2
RADIAL = 3
OPENCV = 4

MODEL_NUM_PARAMS = {
    SIMPLE_PINHOLE: 3,
    PINHOLE: 4,
    SIMPLE_RADIAL: 4,
    RADIAL: 5,
    OPENCV: 8,
}
MODEL_NAMES = {
    SIMPLE_PINHOLE: "SIMPLE_PINHOLE",
    PINHOLE: "PINHOLE",
    SIMPLE_RADIAL: "SIMPLE_RADIAL",
    RADIAL: "RADIAL",
    OPENCV: "OPENCV",
}
MODEL_IDS = {v: k for k, v in MODEL_NAMES.items()}


def canonicalize_params(model_id: int, params) -> np.ndarray:
    """Raw COLMAP param vector -> canonical (fx, fy, cx, cy, k1, k2, p1, p2)."""
    p = np.asarray(params, dtype=np.float64)
    out = np.zeros(8, dtype=np.float64)
    if model_id == SIMPLE_PINHOLE:
        out[:4] = [p[0], p[0], p[1], p[2]]
    elif model_id == PINHOLE:
        out[:4] = p[:4]
    elif model_id == SIMPLE_RADIAL:
        out[:4] = [p[0], p[0], p[1], p[2]]
        out[4] = p[3]
    elif model_id == RADIAL:
        out[:4] = [p[0], p[0], p[1], p[2]]
        out[4:6] = p[3:5]
    elif model_id == OPENCV:
        out[:] = p[:8]
    else:
        raise ValueError(f"unsupported camera model id {model_id}")
    return out


_FREE_ENTRIES = {
    # canonical-tangent entries the raw model has: 0=log fx, 1=log fy,
    # 2=cx, 3=cy, 4..7=k1 k2 p1 p2 (reference GBA, ba_solver.cc:330-356)
    SIMPLE_PINHOLE: [0, 2, 3],
    PINHOLE: [0, 1, 2, 3],
    SIMPLE_RADIAL: [0, 2, 3, 4],
    RADIAL: [0, 2, 3, 4, 5],
    OPENCV: [0, 1, 2, 3, 4, 5, 6, 7],
}
_TIED_FOCAL = {SIMPLE_PINHOLE, SIMPLE_RADIAL, RADIAL}


def intri_free_mask(model_id: int):
    """(free [8] bool, tie_f bool): which canonical-tangent entries the
    COLMAP model has, and whether fx/fy are one tied focal."""
    free = np.zeros(8, bool)
    free[_FREE_ENTRIES[model_id]] = True
    return free, model_id in _TIED_FOCAL


def raw_params(model_id: int, canon) -> np.ndarray:
    """Canonical 8-vector -> raw COLMAP param vector."""
    c = np.asarray(canon, dtype=np.float64)
    if model_id == SIMPLE_PINHOLE:
        return np.array([c[0], c[2], c[3]])
    if model_id == PINHOLE:
        return c[:4].copy()
    if model_id == SIMPLE_RADIAL:
        return np.array([c[0], c[2], c[3], c[4]])
    if model_id == RADIAL:
        return np.array([c[0], c[2], c[3], c[4], c[5]])
    if model_id == OPENCV:
        return c[:8].copy()
    raise ValueError(f"unsupported camera model id {model_id}")


@dataclasses.dataclass(frozen=True)
class Cameras:
    """A batch of cameras as tensors: canonical params [N, 8] (fx, fy, cx,
    cy, k1, k2, p1, p2) float32, and model id, width and height [N] int32
    (width and height 0 where unknown; the model id is kept for I/O)."""

    params: torch.Tensor
    model_id: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor

    @property
    def focal(self) -> torch.Tensor:
        return 0.5 * (self.params[..., 0] + self.params[..., 1])


def make_cameras(model_ids, params_list, widths=None, heights=None, *,
                 device) -> Cameras:
    """Cameras on `device` from raw COLMAP param vectors (canonicalized in
    float64 on the host, stored in float32)."""
    n = len(model_ids)
    canon = np.zeros((n, 8), np.float64)
    for i, (m, p) in enumerate(zip(model_ids, params_list)):
        canon[i] = canonicalize_params(int(m), p)

    def ints(a):
        a = np.zeros(n, np.int32) if a is None else np.asarray(a, np.int32)
        return torch.from_numpy(a).to(device)

    return Cameras(
        params=torch.from_numpy(canon.astype(np.float32)).to(device),
        model_id=ints(model_ids),
        width=ints(widths),
        height=ints(heights),
    )


def distort(params, uv):
    """Apply (k1, k2, p1, p2) to normalized coords uv [..., 2]."""
    k1, k2, p1, p2 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    u, v = uv[..., 0], uv[..., 1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u2)
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v2)
    return torch.stack([u + du, v + dv], dim=-1)


def distort_jacobian(params, uv):
    """Analytic 2x2 Jacobian of `distort` wrt uv: [..., 2, 2]."""
    k1, k2, p1, p2 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    u, v = uv[..., 0], uv[..., 1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    drad_du = 2 * u * (k1 + 2 * k2 * r2)
    drad_dv = 2 * v * (k1 + 2 * k2 * r2)
    j00 = 1 + radial + u * drad_du + 2 * p1 * v + 6 * p2 * u
    j01 = u * drad_dv + 2 * p1 * u + 2 * p2 * v
    j10 = v * drad_du + 2 * p2 * v + 2 * p1 * u
    j11 = 1 + radial + v * drad_dv + 2 * p2 * u + 6 * p1 * v
    J = torch.stack([j00, j01, j10, j11], dim=-1)
    return J.reshape(J.shape[:-1] + (2, 2))


def undistort(params, uv, iters: int = 10):
    """Invert `distort`: x with distort(x) = uv, by a fixed-iteration Newton
    solve with the analytic 2x2 Jacobian (reference: IterativeUndistortion,
    camera_model.hpp:8-55)."""
    k1, k2, p1, p2 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    x = uv
    for _ in range(iters):
        u, v = x[..., 0], x[..., 1]
        u2, v2 = u * u, v * v
        r2 = u2 + v2
        r4 = r2 * r2
        radial = k1 * r2 + k2 * r4
        fu = u + u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u2) - uv[..., 0]
        fv = v + v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v2) - uv[..., 1]
        drad_du = 2 * u * (k1 + 2 * k2 * r2)
        drad_dv = 2 * v * (k1 + 2 * k2 * r2)
        j00 = 1 + radial + u * drad_du + 2 * p1 * v + 6 * p2 * u
        j01 = u * drad_dv + 2 * p1 * u + 2 * p2 * v
        j10 = v * drad_du + 2 * p2 * v + 2 * p1 * u
        j11 = 1 + radial + v * drad_dv + 2 * p2 * u + 6 * p1 * v
        det = j00 * j11 - j01 * j10
        det = torch.where(det.abs() < 1e-12, 1.0, det)
        du_ = (j11 * fu - j01 * fv) / det
        dv_ = (j00 * fv - j10 * fu) / det
        x = torch.stack([u - du_, v - dv_], dim=-1)
    return x


def normalized_to_image(params, uv):
    """Normalized camera coords -> pixels, distorted (reference:
    NormalizedToImage, camera.hpp:92-108)."""
    d = distort(params, uv)
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    return torch.stack([fx * d[..., 0] + cx, fy * d[..., 1] + cy], dim=-1)


def image_to_normalized(params, xy, iters: int = 10):
    """Pixels -> undistorted normalized camera coords (reference:
    ImageToNormalized, camera.hpp:78-90)."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    uv = torch.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], dim=-1)
    return undistort(params, uv, iters=iters)


def project(params, q, t, xyz):
    """World points -> pixels through pose Tcw (q, t) and intrinsics.
    Returns (xy [..., 2], depth [...])."""
    from . import geometry as G

    pc = G.pose_apply(q, t, xyz)
    z = pc[..., 2]
    zsafe = torch.where(z.abs() < 1e-9, 1e-9, z)
    uv = pc[..., :2] / zsafe[..., None]
    return normalized_to_image(params, uv), z


def image_to_normalized_np(canon, xy) -> np.ndarray:
    """Host twin of image_to_normalized for map bookkeeping: the same
    float32 arithmetic, run by torch on the CPU."""
    params = torch.as_tensor(np.asarray(canon), dtype=torch.float32)
    pts = torch.as_tensor(np.asarray(xy, np.float32))
    return image_to_normalized(params, pts).numpy().astype(np.float32)
