"""Synthetic data: the arc scene of scripts/synth_dataset.py, seeded
descriptor sets for the matcher's kernel checks, and the bundle-adjustment
benchmark problem of bench.make_ba_problem.

The arc scene ray-casts two textured Lambertian planes (a wall and a
floor) from an arc of cameras, so every pixel observes a fixed 3D point
and ground-truth poses are known.  numpy/scipy only, so it runs where
neither cv2 nor the JAX package is installed.

Dataset layout written by `write_arc_dataset`:
  <out>/images/frame%04d.png
  <out>/camera.txt          (reference single-camera format)
  <out>/gt_poses.txt        (name qw qx qy qz tx ty tz, Tcw)
  <out>/retrieval.txt       (ranked pairs, view-overlap order)
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

from . import image_io


def look_at_R(center, target, up=(0.0, -1.0, 0.0)):
    z = np.asarray(target, np.float64) - center
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0, 0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def make_texture(rng, res=1024, smooth=3):
    """Random smooth texture: Gaussian-blurred uniform noise in [0, 1]."""
    t = rng.uniform(0, 1, (res, res)).astype(np.float32)
    # mode "mirror" is cv2's default BORDER_REFLECT_101
    t = gaussian_filter(t, smooth, mode="mirror", truncate=4.0)
    t = (t - t.min()) / (t.max() - t.min() + 1e-9)
    return t


class Plane:
    """Textured finite plane: p0 + a*ex + b*ey, (a, b) in [0, 1]^2."""

    def __init__(self, p0, ex, ey, tex):
        self.p0 = np.asarray(p0, np.float64)
        self.ex = np.asarray(ex, np.float64)
        self.ey = np.asarray(ey, np.float64)
        self.n = np.cross(self.ex, self.ey)
        self.n /= np.linalg.norm(self.n)
        self.tex = tex


def render_scene(planes, R, t, f, cx, cy, w, h, near=0.2):
    """Ray-cast all planes, nearest hit wins.  Returns [h, w] uint8."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dirs_cam = np.stack(
        [(xx - cx) / f, (yy - cy) / f, np.ones_like(xx)], axis=-1
    )
    Rt = R.T
    dirs = dirs_cam @ Rt.T  # world ray directions
    origin = -Rt @ t

    img = np.zeros((h, w), np.float64)
    depth = np.full((h, w), np.inf)
    for pl in planes:
        dn = dirs @ pl.n
        safe = np.abs(dn) > 1e-9
        s = np.where(safe, (pl.p0 - origin) @ pl.n / np.where(safe, dn, 1.0),
                     -1.0)
        px = origin[None, None, :] + s[..., None] * dirs
        rel = px - pl.p0
        uu = (rel @ pl.ex) / (pl.ex @ pl.ex)
        vv = (rel @ pl.ey) / (pl.ey @ pl.ey)
        ok = (
            (s > near) & (s < depth)
            & (uu >= 0) & (uu < 1) & (vv >= 0) & (vv < 1)
        )
        res = pl.tex.shape[0]
        ui = np.clip((uu * (res - 1)).astype(np.int64), 0, res - 1)
        vi = np.clip((vv * (res - 1)).astype(np.int64), 0, res - 1)
        img = np.where(ok, pl.tex[vi, ui], img)
        depth = np.where(ok, s, depth)

    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def arc_scene(rng, n_cams):
    """Wall + floor viewed from an arc.  Returns (planes, poses [(R, t)]
    world-to-camera, retrieval ranks)."""
    ext = 8.0
    planes = [
        # wall z=6.8 spanning x,y in [-4, 4]
        Plane([-ext / 2, -ext / 2, 6.8], [ext, 0, 0], [0, ext, 0],
              make_texture(rng)),
        # floor y=1.8 spanning x in [-4, 4], z in [0, 8]
        Plane([-ext / 2, 1.8, 0.0], [ext, 0, 0], [0, 0, ext],
              make_texture(rng)),
    ]
    poses = []
    for i in range(n_cams):
        ang = (i / max(n_cams - 1, 1) - 0.5) * 0.9
        center = np.array(
            [3.5 * np.sin(ang), 0.25 * np.sin(2.2 * i), 3.5 * (1 - np.cos(ang))]
        )
        R = look_at_R(center, [0.0, 0.0, 6.5])
        poses.append((R, -R @ center))
    ranks = [
        [j for j in sorted(range(n_cams), key=lambda j: abs(i - j)) if j != i]
        for i in range(n_cams)
    ]
    return planes, poses, ranks


def rotmat_to_quat(R) -> np.ndarray:
    """Rotation matrix [..., 3, 3] -> unit quaternion (w, x, y, z), w >= 0
    (branch-free Shepperd)."""
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


def write_arc_dataset(out_dir, n_cams=8, seed=3, w=512, h=384, f=450.0,
                      ext=".png") -> Tuple[List[str], list, np.ndarray]:
    """Render the arc scene into out_dir (layout in the module docstring).
    Returns (image names, poses [(R, t)], intrinsics K [3, 3])."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    cx, cy = w / 2, h / 2
    planes, poses, ranks = arc_scene(rng, n_cams)
    names = []
    for i, (R, t) in enumerate(poses):
        img = render_scene(planes, R, t, f, cx, cy, w, h)
        name = f"frame{i:04d}{ext}"
        image_io.write_image(os.path.join(out_dir, "images", name), img)
        names.append(name)
    with open(os.path.join(out_dir, "camera.txt"), "w") as fh:
        fh.write(f"0 PINHOLE {w} {h} {f} {f} {cx} {cy}\n")
    with open(os.path.join(out_dir, "gt_poses.txt"), "w") as fh:
        for name, (R, t) in zip(names, poses):
            q = rotmat_to_quat(R)
            fh.write(
                f"{name} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]}\n"
            )
    with open(os.path.join(out_dir, "retrieval.txt"), "w") as fh:
        for i, name in enumerate(names):
            for j in ranks[i]:
                fh.write(f"{name} {names[j]}\n")
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    return names, poses, K


def fundamental_from_poses(K, pose1, pose2) -> np.ndarray:
    """Ground-truth F with x2^T F x1 = 0 for world-to-camera poses (R, t)
    of two views sharing intrinsics K."""
    R1, t1 = pose1
    R2, t2 = pose2
    R = R2 @ R1.T
    t = t2 - R @ t1
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ tx @ R @ Kinv
    return F / np.linalg.norm(F)


def descriptor_case(seed, B, N, M):
    """Seeded uint8 descriptor sets and masks for the matcher statistics:
    d1 [B,N,128], d2 [B,M,128], m1 [B,N], m2 [B,M].  Planted: true
    matches (rows of d1 copied into d2), duplicated columns and rows
    (exact ties in both directions), all-zero descriptors, masked entries
    (random and a ragged tail), and, for B >= 3, one pair with every
    column masked."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 256, (B, N, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (B, M, 128), dtype=np.uint8)
    d1[rng.random(d1.shape) < 0.5] = 0
    d2[rng.random(d2.shape) < 0.5] = 0
    for b in range(B):
        k = max(1, min(N, M) // 4)
        src = rng.choice(N, k, replace=False)
        dst = rng.choice(M, k, replace=False)
        d2[b, dst] = d1[b, src]
        t = max(1, M // 32)
        d2[b, rng.choice(M, t)] = d2[b, rng.choice(M, t)]
        t = max(1, N // 32)
        d1[b, rng.choice(N, t)] = d1[b, rng.choice(N, t)]
        d1[b, rng.choice(N, min(N, 2))] = 0
        d2[b, rng.choice(M, min(M, 2))] = 0
    m1 = rng.random((B, N)) > 0.05
    m2 = rng.random((B, M)) > 0.05
    m1[:, N - N // 16:] = False
    m2[:, M - M // 16:] = False
    if B >= 3:
        m2[B - 1] = False
    return d1, d2, m1, m2


def ba_problem(n_cams=200, n_pts=20000, obs_per_pt=7, seed=0):
    """bench.make_ba_problem's KITTI-scale BA problem, in numpy and in COO
    order (no camera-major packing): the same generator calls in the same
    order, so the same problem for the same seed.  Returns a dict of the
    optim.ba.BAProblem fields (seed 0 at the default size: 200 cameras,
    20,000 points, about 140k observations)."""
    rng = np.random.default_rng(seed)
    f, cx, cy = 718.0, 607.0, 185.0  # KITTI-like intrinsics
    # forward motion: cameras at identity rotation, Tcw t = -c
    centers = np.cumsum(
        rng.normal(scale=[0.15, 0.02, 0.05], size=(n_cams, 3)), axis=0
    )
    centers[:, 2] += np.arange(n_cams) * 1.0
    qs = np.zeros((n_cams, 4))
    qs[:, 0] = 1.0
    anchor = rng.integers(0, n_cams, n_pts)
    uv_n = rng.uniform(-0.4, 0.4, size=(n_pts, 2))
    depth = rng.uniform(5.0, 40.0, size=(n_pts, 1))
    xyz = centers[anchor] + depth * np.concatenate(
        [uv_n, np.ones((n_pts, 1))], axis=1
    )
    obs_cam = np.concatenate([
        np.clip(anchor - obs_per_pt // 2 + k, 0, n_cams - 1)
        for k in range(obs_per_pt)
    ]).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), obs_per_pt).astype(np.int32)
    pc = xyz[obs_pt] - centers[obs_cam]
    proj = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
    good = (pc[:, 2] > 1.0) & (np.abs(proj) < 0.6).all(axis=1)
    obs_cam, obs_pt, pc = obs_cam[good], obs_pt[good], pc[good]
    uv = pc[:, :2] / pc[:, 2:3] * f + np.array([cx, cy])
    uv += rng.normal(scale=0.5, size=uv.shape)
    fix_cam = np.zeros(n_cams, bool)
    fix_cam[0] = True
    fix_trans = np.zeros(n_cams, bool)
    fix_trans[1] = True
    return dict(
        cam_q=qs.astype(np.float32),
        cam_t=(-centers).astype(np.float32),
        cam_intri=np.tile(np.array([f, f, cx, cy, 0, 0, 0, 0], np.float32),
                          (n_cams, 1)),
        points=(xyz + rng.normal(scale=0.05, size=xyz.shape)).astype(np.float32),
        obs_uv=uv.astype(np.float32),
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_w=np.ones(len(obs_cam), np.float32),
        fix_cam=fix_cam,
        fix_trans=fix_trans,
        fix_pt=np.zeros(n_pts, bool),
    )
