"""Batched quaternion / SO(3) / SE(3) primitives (port of
xrsfm_tpu/utils/geometry.py; reference: src/base/types.h:14-61,
src/optimization/lie_algebra.h:12-57).

Every torch function broadcasts over leading batch dimensions.  The
``*_np`` twins are float64 numpy for host bookkeeping.

Conventions:
  * quaternions are stored [..., 4] as (w, x, y, z), Hamilton convention,
    COLMAP's on-disk order (qw qx qy qz);
  * a camera pose is Tcw: x_cam = R @ x_world + t (world -> camera).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12

# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_mul(a, b):
    """Hamilton product a*b, both [..., 4] (w,x,y,z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_rotmat(q):
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(R):
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w >= 0).

    Branch-free Shepperd: all four candidates, the best-conditioned one
    selected by the largest diagonal combination."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], dim=-1)
    scores = torch.stack(
        [1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(scores, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(case), 4(comp)]
    q = torch.gather(
        cand, -2, idx[..., None, None].expand(idx.shape + (1, 4))
    )[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------


def skew(v):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp_quat(w):
    """Rotation vector [..., 3] -> unit quaternion [..., 4]. Taylor-safe."""
    theta2 = (w * w).sum(dim=-1, keepdim=True)
    theta = torch.sqrt(theta2.clamp_min(_EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    sinc = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw, sinc * w], dim=-1)


def so3_log(q):
    """Unit quaternion [..., 4] -> rotation vector [..., 3]. Taylor-safe."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
    w = q[..., :1].clamp(-1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-8, 2.0 / w.clamp_min(0.5),
                        theta / vn.clamp_min(_EPS))
    return scale * v


def so3_exp_matrix(w):
    return quat_to_rotmat(so3_exp_quat(w))


# ---------------------------------------------------------------------------
# SE(3) poses as (quat [..., 4], t [..., 3]), Tcw convention
# ---------------------------------------------------------------------------


def pose_compose(qa, ta, qb, tb):
    """Ta*Tb: x -> Ra(Rb x + tb) + ta (reference Pose::mul, types.h:54)."""
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def pose_inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def pose_apply(q, t, x):
    """Apply Tcw to world points: x_cam = R x + t."""
    return quat_rotate(q, x) + t


def pose_center(q, t):
    """Camera center in world coordinates: -R^T t."""
    return -quat_rotate(quat_conj(q), t)


def pose_relative(q1, t1, q2, t2):
    """T12 = T1cw * T2cw^-1."""
    qi, ti = pose_inverse(q2, t2)
    return pose_compose(q1, t1, qi, ti)


def pose_retract(q, t, delta):
    """Right-multiplicative local update of the LM solver: delta [..., 6]
    = (dw, dt); q' = q * exp(dw), t' = t + dt (reference QuatParam,
    cost_factor_ceres.h:262-282)."""
    dq = so3_exp_quat(delta[..., :3])
    return quat_normalize(quat_mul(q, dq)), t + delta[..., 3:]


def angle_between_rays(d1, d2):
    """Angle (radians) between ray direction bundles [..., 3]."""
    n1 = torch.linalg.norm(d1, dim=-1)
    n2 = torch.linalg.norm(d2, dim=-1)
    cosang = (d1 * d2).sum(dim=-1) / (n1 * n2).clamp_min(_EPS)
    return torch.arccos(cosang.clamp(-1.0, 1.0))


# ---------------------------------------------------------------------------
# numpy twins (float64) for host bookkeeping
# ---------------------------------------------------------------------------


def quat_to_rotmat_np(q) -> np.ndarray:
    q = np.asarray(q, np.float64)
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def pose_center_np(q, t) -> np.ndarray:
    """-R^T t."""
    R = quat_to_rotmat_np(q)
    t = np.asarray(t, np.float64)
    return -np.einsum("...ji,...j->...i", R, t)


def quat_mul_np(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def pose_compose_np(qa, ta, qb, tb):
    """Ta*Tb."""
    Ra = quat_to_rotmat_np(qa)
    ta = np.asarray(ta, np.float64)
    tb = np.asarray(tb, np.float64)
    return quat_mul_np(qa, qb), np.einsum("...ij,...j->...i", Ra, tb) + ta


def pose_relative_np(q1, t1, q2, t2):
    """T1 * T2^-1."""
    qi = np.asarray(q2, np.float64) * np.array([1.0, -1.0, -1.0, -1.0])
    Ri = quat_to_rotmat_np(qi)
    ti = -np.einsum("...ij,...j->...i", Ri, np.asarray(t2, np.float64))
    return pose_compose_np(q1, t1, qi, ti)


def rotmat_to_quat_np(R) -> np.ndarray:
    """Branch-free Shepperd, as rotmat_to_quat."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = np.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = np.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = np.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = np.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], axis=-1)
    scores = np.stack(
        [1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22],
        axis=-1,
    )
    idx = np.argmax(scores, axis=-1)
    cand = np.stack([qw, qx, qy, qz], axis=-2)
    q = np.take_along_axis(cand, idx[..., None, None], axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)
