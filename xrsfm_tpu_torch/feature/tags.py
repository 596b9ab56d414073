"""AprilTag detection and metric scale estimation (port of
xrsfm_tpu/feature/tags.py; reference: src/tag/tag_extract.hpp:33-277 and
src/estimate_scale.cc: apriltag detection, RANSAC corner triangulation
(CreatePoint3dRAW), a per-tag similarity fit of the canonical tag square
with a global scale (TagCost, cost_factor_ceres.h:223-260), a joint
refinement with projection residuals, then every pose and point divided
by the scale).

Detection runs on the host through cv2.aruco's AprilTag 36h11
dictionary, imported inside `detect_tags` (the reference also treats
detection as host preprocessing, SURVEY.md §2.8).  Corner triangulation
(mapper/kernels.robust_triangulate) and the joint refinement (dense LM
with torch.func.jacfwd, fixed trip count, no host read in the loop) run on
an explicit device; the per-tag similarity is closed-form numpy
(ops/umeyama).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..base.map import SfMMap
from ..device import full_precision, resolve_device
from ..mapper import kernels
from ..ops import linalg
from ..ops.umeyama import umeyama
from ..utils import camera as Cam
from ..utils import geometry as G


def canonical_corners(tag_length: float) -> np.ndarray:
    """Corner layout of a tag of side `tag_length`, centered at the
    origin, in detection corner order (cv2.aruco: TL, TR, BR, BL)."""
    h = tag_length / 2.0
    return np.array(
        [[-h, h, 0.0], [h, h, 0.0], [h, -h, 0.0], [-h, -h, 0.0]], np.float64
    )


def detect_tags(image) -> Dict[int, np.ndarray]:
    """Detect AprilTag 36h11 markers.  Returns tag_id -> [4, 2] pixel
    corners (reference: tag_extract, tag_extract.hpp:33-57)."""
    import cv2

    img = np.asarray(image)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11)
    det = cv2.aruco.ArucoDetector(d, cv2.aruco.DetectorParameters())
    corners, ids, _ = det.detectMarkers(img)
    out = {}
    if ids is not None:
        for c, i in zip(corners, ids.flatten()):
            out[int(i)] = c.reshape(4, 2).astype(np.float64)
    return out


def _normalized(m: SfMMap, fids, px, dev) -> np.ndarray:
    """Undistorted normalized coordinates of pixels px [N, 2], each seen
    by frame fids[i], in one call on `dev` (float32, as the JAX package's
    per-observation calls)."""
    params = np.stack([np.asarray(m.cameras[int(m.cam_of_frame[f])],
                                  np.float32) for f in fids])
    with full_precision():
        uv = Cam.image_to_normalized(
            torch.from_numpy(params).to(dev),
            torch.from_numpy(np.asarray(px, np.float32)).to(dev))
    return uv.cpu().numpy()


def triangulate_tag_corners(
    m: SfMMap,
    detections: Dict[int, Dict[int, np.ndarray]],
    th_px: float = 8.0,
    *,
    device="cuda",
) -> Dict[int, np.ndarray]:
    """detections: frame_id -> {tag_id -> [4,2] pixels}.

    Triangulates each observed tag corner from the registered frames
    seeing it, the first 16 of them (reference: CreatePoint3dRAW,
    track_processor.cc:682-730), on `device`.  Returns tag_id -> [4, 3]
    triangulated corners (NaN rows where a corner could not be
    triangulated)."""
    dev = resolve_device(device)
    # observations per (tag, corner)
    obs: Dict[Tuple[int, int], List[Tuple[int, np.ndarray]]] = {}
    for fid, tags in detections.items():
        if not m.registered[fid]:
            continue
        for tag_id, corners in tags.items():
            for k in range(4):
                obs.setdefault((tag_id, k), []).append((fid, corners[k]))

    keys = [k for k, v in obs.items() if len(v) >= 2]
    if not keys:
        return {}
    V = min(max(max(len(obs[k]) for k in keys), 2), 16)
    B = len(keys)
    q = np.zeros((B, V, 4), np.float32)
    q[..., 0] = 1.0
    t = np.zeros((B, V, 3), np.float32)
    uv = np.zeros((B, V, 2), np.float32)
    mask = np.zeros((B, V), bool)
    slots = [(i, j, fid, px) for i, key in enumerate(keys)
             for j, (fid, px) in enumerate(obs[key][:V])]
    ii = np.array([s[0] for s in slots])
    jj = np.array([s[1] for s in slots])
    fids = np.array([s[2] for s in slots])
    uv[ii, jj] = _normalized(m, fids, np.stack([s[3] for s in slots]), dev)
    q[ii, jj] = m.q[fids]
    t[ii, jj] = m.t[fids]
    mask[ii, jj] = True
    focal = float(next(iter(m.cameras.values()))[0])
    xyz, _obs_ok, ok, _ang = kernels.on_device(
        kernels.robust_triangulate, q, t, uv, mask,
        th=(th_px / focal) ** 2, min_angle=0.0, device=dev)
    out: Dict[int, np.ndarray] = {}
    for i, (tag_id, k) in enumerate(keys):
        if tag_id not in out:
            out[tag_id] = np.full((4, 3), np.nan)
        if ok[i]:
            out[tag_id][k] = xyz[i]
    return out


def estimate_scale_from_corners(
    tag_corners: Dict[int, np.ndarray], tag_length: float
) -> Tuple[float, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """Fit per-tag similarity transforms of the canonical square to the
    triangulated corners; the shared scale s maps meters to
    reconstruction units.  Returns (s, {tag_id: (R, t)}).

    (The reference solves this jointly with Ceres, tag_extract.hpp:
    199-234; with the corners triangulated the per-tag Umeyama fit is the
    closed-form least squares of the same residual.)"""
    canon = canonical_corners(tag_length)
    scales = []
    poses = {}
    for tag_id, corners in tag_corners.items():
        good = ~np.isnan(corners[:, 0])
        if good.sum() < 3:
            continue
        s, R, t = umeyama(canon[good], corners[good], with_scale=True)
        if s <= 0:
            continue
        scales.append(s)
        poses[tag_id] = (R, t)
    if not scales:
        return 0.0, {}
    return float(np.median(scales)), poses


def _lm(residuals, x0: torch.Tensor, iters: int) -> torch.Tensor:
    """Dense LM on residuals(x) from x0: a fixed number of iterations,
    the accept test and damping update on the device, no host read."""
    from torch.func import jacfwd

    def cost(x):
        r = residuals(x)
        return (r * r).sum()

    x = x0
    lam = torch.tensor(1e-4, dtype=x0.dtype, device=x0.device)
    c = cost(x)
    eye = torch.eye(len(x0), dtype=x0.dtype, device=x0.device)
    for _ in range(iters):
        J = jacfwd(residuals)(x)
        r = residuals(x)
        H = J.T @ J
        g = J.T @ r
        A = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye
        x2 = x - linalg.solve(A, g)
        c2 = cost(x2)
        better = c2 < c
        x = torch.where(better, x2, x)
        lam = torch.where(better, lam * 0.5, lam * 4.0).clamp(1e-10, 1e8)
        c = torch.where(better, c2, c)
    return x


def joint_refine_scale(
    m: SfMMap,
    detections: Dict[int, Dict[int, np.ndarray]],
    tag_corners: Dict[int, np.ndarray],
    scale0: float,
    poses0: Dict[int, Tuple[np.ndarray, np.ndarray]],
    tag_length: float,
    iters: int = 40,
    *,
    device="cuda",
) -> float:
    """Joint refinement (reference: the second Ceres solve of tag_refine,
    tag_extract.hpp:237-265): with the camera poses fixed, optimize {per
    tag pose, global log-scale, tag corner world points} under (a) the
    reprojection of every corner observation and (b) the tag-shape
    residual corner - s*(R_tag c_k + t_tag), by dense LM in float32 on
    `device` (19 dofs a tag, plus one).  Returns the refined scale."""
    dev = resolve_device(device)
    tag_ids = [t for t in sorted(tag_corners) if t in poses0
               and not np.any(np.isnan(tag_corners[t]))]
    if not tag_ids:
        return scale0
    T = len(tag_ids)

    # observation table: corner world-point index, fixed pose, normalized
    # uv; one normalization call for every detection
    rows_f, rows_px, rows_pt = [], [], []
    for fid, tags in detections.items():
        if not m.registered[fid]:
            continue
        for ti, tag_id in enumerate(tag_ids):
            if tag_id not in tags:
                continue
            rows_f += [fid] * 4
            rows_px.append(np.asarray(tags[tag_id], np.float32))
            rows_pt += [ti * 4 + k for k in range(4)]
    if not rows_pt:
        return scale0
    fids = np.asarray(rows_f)
    obs_uv = _normalized(m, fids, np.concatenate(rows_px), dev)

    def dt(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    obs_q = dt(m.q[fids])
    obs_t = dt(m.t[fids])
    obs_uv = dt(obs_uv)
    obs_pt = torch.as_tensor(np.asarray(rows_pt, np.int64), device=dev)

    # initial state: corners from triangulation, tag poses from the
    # closed-form fit (R, t in world units; the shape residual maps the
    # canonical meters through s)
    x_pts0 = np.stack([tag_corners[t] for t in tag_ids]).reshape(-1, 3)
    q_tag0 = dt(np.stack([G.rotmat_to_quat_np(poses0[t][0])
                          for t in tag_ids]))
    t_tag0 = np.stack([poses0[t][1] for t in tag_ids]) / max(scale0, 1e-9)
    canon = dt(canonical_corners(tag_length))
    # the shape residual is world-unit sized and the reprojection
    # normalized-plane sized: weight the shape in tag-size units, and
    # strongly (tags are rigid, so the scale is driven by the
    # reprojections through a near-hard shape)
    w_shape = 10.0 / max(scale0 * tag_length, 1e-9)

    def residuals(x):
        # x = [T*4*3 points][T*3 rotation vectors][T*3 t][1 log_s]
        n1 = T * 12
        pts = x[:n1].reshape(T * 4, 3)
        w = x[n1: n1 + T * 3].reshape(T, 3)
        tt = x[n1 + T * 3: n1 + T * 6].reshape(T, 3)
        s = torch.exp(x[-1])
        pc = G.quat_rotate(obs_q, pts[obs_pt]) + obs_t
        z = torch.where(pc[:, 2].abs() < 1e-9, 1e-9, pc[:, 2])
        r_proj = pc[:, :2] / z[:, None] - obs_uv
        q_tag = G.quat_mul(q_tag0, G.so3_exp_quat(w))
        shape = s * (G.quat_rotate(q_tag[:, None], canon[None])
                     + tt[:, None]).reshape(T * 4, 3)
        r_shape = (pts - shape) * w_shape
        return torch.cat([r_proj.reshape(-1), r_shape.reshape(-1)])

    x0 = dt(np.concatenate([x_pts0.reshape(-1), np.zeros(T * 3),
                            t_tag0.reshape(-1), [np.log(max(scale0, 0.2))]]))
    with full_precision():
        x = _lm(residuals, x0, iters)
    log_s = float(x[-1])
    return float(np.exp(np.clip(log_s, np.log(0.2), 20.0)))


def apply_metric_scale(m: SfMMap, scale: float):
    """Divide every translation and point by the scale so that one unit
    is one meter (reference: tag_extract.hpp:269-276)."""
    m.t /= scale
    m.track_xyz[: m.num_tracks] /= scale
