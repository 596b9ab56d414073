"""Synthetic data: the arc scene of scripts/synth_dataset.py, the
kitti-class circuit workspace of scripts/synth_features.py, seeded
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
from . import io_features as IOF


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


def descriptor_tie_case():
    """`descriptor_case` at (3, 130, 300) with exact ties planted where the
    CUDA kernel's reduction splits its work: the best column of some rows
    duplicated across 128-column tiles, across the four lanes that share a
    row and within one lane, the same for rows, one pair with every row
    masked and (pair 2, by `descriptor_case`) one with every column
    masked."""
    d1, d2, m1, m2 = descriptor_case(77, 3, 130, 300)
    for b in range(3):
        d1[b, 7] = 255  # the largest dots there are: the copies tie
        d2[b, [5, 133, 262]] = d1[b, 7]   # three tiles
        d2[b, [10, 12]] = d1[b, 7]        # lanes 1 and 2 of one group
        d2[b, [16, 17]] = d1[b, 7]        # one lane, e = 0 and 1
        m2[b, [5, 10, 12, 16, 17, 133, 262]] = b != 2
        d1[b, [3, 129]] = d1[b, 7]        # tied rows in two tiles
        m1[b, [3, 7, 129]] = True
    m1[1] = False
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


# ---------------------------------------------------------------------------
# the kitti-class circuit (feature level, no images)
# ---------------------------------------------------------------------------

KITTI_FX = 500.0
KITTI_W, KITTI_H = 960, 720


def kitti_scene(rng, n_frames, step=0.5):
    """Square circuit of forward-looking cameras between walls of points.
    Returns (centers [F, 3], R [F, 3, 3] world-to-camera, points [P, 3])."""
    seg = n_frames // 4
    dirs = np.array([[1, 0, 0], [0, 0, 1], [-1, 0, 0], [0, 0, -1]], float)
    centers = np.zeros((n_frames, 3))
    for i in range(1, n_frames):
        centers[i] = centers[i - 1] + step * dirs[min((i - 1) // seg, 3)]
    # heading smoothed over +-4 frames: a vehicle turns gradually, and an
    # instantaneous corner would sever the covisibility chain
    R = np.zeros((n_frames, 3, 3))
    for i in range(n_frames):
        a = max(0, i - 4)
        b = min(n_frames - 1, i + 4)
        fwd = centers[b] - centers[a]
        if np.linalg.norm(fwd) < 1e-9:
            fwd = dirs[min(i // seg, 3)]
        R[i] = look_at_R(centers[i], centers[i] + fwd)
    # wall points flanking the path on both sides
    pts = []
    L = seg * step
    for side in (-3.0, 3.0):
        for wall in range(4):
            n_pts = int(L * 14)
            a = rng.uniform(0, L, n_pts)
            h = rng.uniform(-2.0, 2.0, n_pts)
            d = dirs[wall]
            perp = np.array([-d[2], 0, d[0]])
            base = centers[wall * seg] + a[:, None] * d + side * perp
            base[:, 1] = h
            pts.append(base)
    return centers, R, np.concatenate(pts)


def project_all(centers, R, pts, rng, max_kp=700, z_range=(1.0, 40.0),
                noise_px=0.4):
    """Visibility and projection for every frame (PINHOLE, KITTI_FX at the
    image center): per frame (point_ids, uv_px), at most max_kp keypoints,
    nearest first, with Gaussian pixel noise."""
    cx, cy = KITTI_W / 2.0, KITTI_H / 2.0
    out = []
    for i in range(len(centers)):
        pc = (pts - centers[i]) @ R[i].T
        z = pc[:, 2]
        ok = (z > z_range[0]) & (z < z_range[1])
        zz = np.where(ok, z, 1.0)
        x = pc[:, 0] / zz
        y = pc[:, 1] / zz
        u = KITTI_FX * x + cx
        v = KITTI_FX * y + cy
        ok &= (u > 8) & (u < KITTI_W - 8) & (v > 8) & (v < KITTI_H - 8)
        ids = np.nonzero(ok)[0]
        if len(ids) > max_kp:
            ids = ids[np.argsort(z[ids])[:max_kp]]
        uv = np.stack([u[ids], v[ids]], 1)
        uv = uv + rng.normal(scale=noise_px, size=uv.shape)
        out.append((ids.astype(np.int64), uv.astype(np.float32)))
    return out


def build_kitti_pairs(frames_obs, n_frames, rng, loop_centers, min_shared=30,
                      contamination=0.03):
    """Verified pairs of the circuit: every frame with its next 5, plus up
    to 3 loop-closure partners within 4 units that are more than 50 frames
    apart (every second frame); matches from shared point ids, with a
    `contamination` share rewired to wrong targets but kept as inliers."""
    cand = set()
    for i in range(n_frames):
        for k in range(1, 6):
            if i + k < n_frames:
                cand.add((i, i + k))
    c = loop_centers
    for i in range(0, n_frames, 2):
        d = np.linalg.norm(c - c[i], axis=1)
        close = np.nonzero((d < 4.0)
                           & (np.abs(np.arange(n_frames) - i) > 50))[0]
        for j in close[:3]:
            cand.add((i, int(j)) if i < j else (int(j), i))
    pairs = []
    for a, b in sorted(cand):
        ids_a, _ = frames_obs[a]
        ids_b, _ = frames_obs[b]
        pos_b = {int(p): k for k, p in enumerate(ids_b)}
        rows = [(k, pos_b[int(p)]) for k, p in enumerate(ids_a)
                if int(p) in pos_b]
        if len(rows) < min_shared:
            continue
        m = np.asarray(rows, np.int32)
        n_bad = int(contamination * len(m))
        if n_bad:
            sel = rng.choice(len(m), n_bad, replace=False)
            m[sel, 1] = rng.integers(0, len(ids_b), n_bad)
        pairs.append(IOF.FramePairData(
            id1=a, id2=b, matches=m, distances=np.zeros(len(m)), E=np.eye(3),
            inlier_num=len(m), inlier_mask=np.ones(len(m), bool)))
    return pairs


def write_kitti_workspace(out_dir, n_frames=1000, seed=0):
    """The kitti-class circuit workspace of scripts/synth_features.py
    (`--scene kitti`), byte for byte for the same n_frames and seed:
    ftr.bin (keypoints, zero descriptors), fp.bin (verified pairs with loop
    closures), camera.txt and gt_poses.txt (name qw qx qy qz tx ty tz,
    Tcw).  Returns the image names."""
    from .geometry import rotmat_to_quat_np

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    centers, R, pts = kitti_scene(rng, n_frames)
    frames_obs = project_all(centers, R, pts, rng)
    names = [f"img{i:05d}.png" for i in range(n_frames)]
    feats = []
    for i, (_ids, uv) in enumerate(frames_obs):
        kp = np.zeros((len(uv), 4), np.float32)
        kp[:, :2] = uv
        kp[:, 2] = 2.0
        feats.append(IOF.FrameFeatures(
            name=names[i], keypoints=kp,
            descriptors=np.zeros((len(uv), 128), np.uint8)))
    IOF.write_features(os.path.join(out_dir, "ftr.bin"), feats,
                       with_descs=True)
    pairs = build_kitti_pairs(frames_obs, n_frames, rng, centers)
    IOF.write_frame_pairs(os.path.join(out_dir, "fp.bin"), pairs)
    cx, cy = KITTI_W / 2.0, KITTI_H / 2.0
    with open(os.path.join(out_dir, "camera.txt"), "w") as f:
        f.write(f"0 PINHOLE {KITTI_W} {KITTI_H} {KITTI_FX} {KITTI_FX} "
                f"{cx} {cy}\n")
    with open(os.path.join(out_dir, "gt_poses.txt"), "w") as f:
        for i in range(n_frames):
            q = rotmat_to_quat_np(R[i])
            t = -R[i] @ centers[i]
            f.write(f"{names[i]} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
                    f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f}\n")
    return names
