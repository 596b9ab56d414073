"""2D debug visualization and 3D export, headless equivalents of the
reference's viewer utilities (host copy of xrsfm_tpu/utils/view.py: the
drawing functions import cv2 when called, and export_ply is numpy, writing
the JAX package's bytes).

Reference: src/utility/view.{h,cc}:21-110 (DrawFeature / DrawFeatureMatches /
DrawFeatureFlow over OpenCV windows) and the dormant Pangolin 3D viewer
(src/utility/viewer.{h,cc}; not built into the reference's library target,
CMakeLists.txt:99-130).  This environment is headless, so every function
renders to an image file instead of a window, and the 3D snapshot exports a
PLY point cloud with camera frusta that any viewer (MeshLab, COLMAP GUI,
rerun) opens directly.
"""

from __future__ import annotations

import numpy as np

_GREEN = (0, 255, 0)
_RED = (0, 0, 255)
_GRAY = (80, 80, 80)


def _cv2():
    import cv2

    return cv2


def draw_features(image, keypoints, out_path=None):
    """Draw keypoints as 1px green dots (reference DrawFeature,
    view.cc:51-58).  image: HxW[x3] uint8; keypoints: [N,>=2] pixel xy."""
    cv2 = _cv2()
    img = np.ascontiguousarray(np.atleast_3d(image).repeat(3, -1)
                               if image.ndim == 2 else image.copy())
    for xy in np.asarray(keypoints)[:, :2]:
        cv2.circle(img, (int(round(xy[0])), int(round(xy[1]))), 1, _GREEN, -1)
    if out_path is not None:
        cv2.imwrite(str(out_path), img)
    return img


def draw_matches(img1, img2, kps1, kps2, matches, mask=None, out_path=None):
    """Side-by-side match visualization (reference DrawFeatureMatches,
    view.cc:60-96): green lines for matches (inliers when mask given),
    red dots on masked-out matches.

    img1/img2: HxW[x3] uint8; kps1/kps2: [N,>=2]; matches: [M,2] int;
    mask: optional [M] bool."""
    cv2 = _cv2()

    def color(im):
        return (cv2.cvtColor(im, cv2.COLOR_GRAY2BGR)
                if im.ndim == 2 else im.copy())

    a, b = color(np.asarray(img1)), color(np.asarray(img2))
    h = max(a.shape[0], b.shape[0])
    w = a.shape[1] + b.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    kps1 = np.asarray(kps1)[:, :2]
    kps2 = np.asarray(kps2)[:, :2]
    matches = np.asarray(matches)
    if mask is None:
        mask = np.ones(len(matches), bool)
    mask = np.asarray(mask).astype(bool)
    for (i, j), ok in zip(matches, mask):
        p1 = (int(round(kps1[i, 0])), int(round(kps1[i, 1])))
        p2 = (int(round(kps2[j, 0] + off)), int(round(kps2[j, 1])))
        if ok:
            cv2.line(canvas, p1, p2, _GREEN, 1)
        else:
            cv2.circle(canvas, p1, 2, _RED, -1)
            cv2.circle(canvas, p2, 2, _RED, -1)
    if out_path is not None:
        cv2.imwrite(str(out_path), canvas)
    return canvas


def draw_feature_flow(img, kps1, kps2, matches, states=None, out_path=None):
    """Motion-vector view on one image (reference DrawFeatureFlow,
    view.cc:98-110): a line from each matched feature to its position in
    the other frame; green when state>0, gray otherwise."""
    cv2 = _cv2()
    canvas = (cv2.cvtColor(np.asarray(img), cv2.COLOR_GRAY2BGR)
              if np.asarray(img).ndim == 2 else np.asarray(img).copy())
    kps1 = np.asarray(kps1)[:, :2]
    kps2 = np.asarray(kps2)[:, :2]
    matches = np.asarray(matches)
    if states is None:
        states = np.ones(len(matches), np.int32)
    for (i, j), s in zip(matches, np.asarray(states)):
        p1 = (int(round(kps1[i, 0])), int(round(kps1[i, 1])))
        p2 = (int(round(kps2[j, 0])), int(round(kps2[j, 1])))
        cv2.line(canvas, p1, p2, _GREEN if s > 0 else _GRAY, 1)
        cv2.circle(canvas, p2, 1, _GREEN if s > 0 else _GRAY, -1)
    if out_path is not None:
        cv2.imwrite(str(out_path), canvas)
    return canvas


def _rotmat_f32(q) -> np.ndarray:
    """Rotation matrices of unit quaternions [C, 4] in float32 arithmetic,
    as the JAX package computes them (its device default is float32)."""
    w, x, y, z = np.moveaxis(np.asarray(q, np.float32), -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one, two = np.float32(1), np.float32(2)
    m = np.stack([
        one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
        two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
        two * (xz - wy), two * (yz + wx), one - two * (xx + yy),
    ], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def export_ply(path, points_xyz, points_rgb=None, cam_q=None, cam_t=None,
               frustum_scale: float = 0.25):
    """Write an ASCII PLY with the sparse cloud and, optionally, camera
    frusta as line-less vertex quads (5 vertices per camera: center + 4
    image-plane corners, colored red).  Covers the dormant Pangolin
    viewer's role (reference src/utility/viewer.cc:15-163) as a portable
    artifact instead of a window."""
    pts = np.asarray(points_xyz, np.float64).reshape(-1, 3)
    if points_rgb is None:
        rgb = np.full((len(pts), 3), 200, np.uint8)
    else:
        rgb = np.asarray(points_rgb, np.uint8).reshape(-1, 3)
    cam_rows = []
    if cam_q is not None and cam_t is not None:
        q = np.asarray(cam_q, np.float64).reshape(-1, 4)
        t = np.asarray(cam_t, np.float64).reshape(-1, 3)
        R = _rotmat_f32(q)  # [C,3,3] world->cam
        centers = -np.einsum("cij,ci->cj", R, t)  # -R^T t
        s = frustum_scale
        corners_c = np.array(
            [[0, 0, 0], [-s, -s, 2 * s], [s, -s, 2 * s],
             [s, s, 2 * s], [-s, s, 2 * s]]
        )
        for c in range(len(q)):
            world = centers[c] + corners_c @ R[c]  # R^T @ corner
            cam_rows.append(world)
    cam_pts = (np.concatenate(cam_rows, 0)
               if cam_rows else np.zeros((0, 3)))
    n = len(pts) + len(cam_pts)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(pts, rgb):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        for p in cam_pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 255 0 0\n")
