"""Synthetic data: the image scenes of scripts/synth_dataset.py (arc,
loop, corridor), the feature-level workspaces of scripts/synth_features.py
(the kitti-class circuit, the unordered landmark ring and the street
tour), seeded descriptor sets for the matcher's kernel checks, the
bundle-adjustment benchmark problem of bench.make_ba_problem, and the blob
texture of the ORB and SIFT tests.

The image scenes ray-cast textured Lambertian planes, so every pixel
observes a fixed 3D point and ground-truth poses are known.  numpy/scipy
only, so it runs where neither cv2 nor the JAX package is installed.

Dataset layout written by `write_dataset`:
  <out>/images/frame%04d.png
  <out>/camera.txt          (reference single-camera format)
  <out>/gt_poses.txt        (name qw qx qy qz tx ty tz, Tcw)
  <out>/retrieval.txt       (ranked pairs, view-overlap order)
  <out>/times.txt           (corridor only: KITTI-style timestamps)
"""

from __future__ import annotations

import math
import os
from collections import Counter
from typing import List, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

from . import image_io
from . import io_features as IOF
from .geometry import rotmat_to_quat_np


def look_at_R(center, target, up=(0.0, -1.0, 0.0)):
    z = np.asarray(target, np.float64) - center
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0, 0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def _cv2_gaussian_kernel(n, sigma):
    """cv2.getGaussianKernel(n, sigma, CV_32F): OpenCV's bit-exact kernel
    (getGaussianKernelBitExact, evaluated in float64), cast to float32."""
    half = (n - 1) // 2
    scale = -0.125 / (sigma * sigma)
    vals = [math.exp(float(x * x) * scale) for x in range(1 - n, -1, 2)]
    total = 0.0
    for v in vals:  # summed in OpenCV's order
        total += v
    mul = 1.0 / (total * 2.0 + 1.0)
    k = np.empty(n)
    k[:half] = [v * mul for v in vals]
    k[half] = mul
    k[half + 1:] = k[:half][::-1]
    return k.astype(np.float32)


def gaussian_blur_cv2(t, sigma):
    """cv2.GaussianBlur(t, (0, 0), sigma) of a float32 image, bit for bit:
    the 4-sigma float32 kernel, BORDER_REFLECT_101, the row pass as fused
    multiply-adds over the taps in order, the column pass as the symmetric
    sum (the centre tap's product, then a fused multiply-add of each tap
    with the float32 sum of its two mirrored rows).  A float32 fused
    multiply-add is a float64 multiply-add rounded to float32: the product
    of two float32 is exact in float64."""
    n = int(round(sigma * 8 + 1)) | 1
    k = _cv2_gaussian_kernel(n, float(sigma)).astype(np.float64)
    r = n // 2
    h, w = t.shape
    p = np.pad(t, [(0, 0), (r, r)], mode="reflect")
    acc = np.zeros((h, w), np.float32)
    for j in range(n):
        acc = (acc + k[j] * p[:, j:j + w]).astype(np.float32)
    p = np.pad(acc, [(r, r), (0, 0)], mode="reflect")
    out = (np.float32(k[r]) * p[r:r + h]).astype(np.float32)
    for j in range(1, r + 1):
        pair = p[r + j:r + j + h] + p[r - j:r - j + h]  # float32 sum
        out = (out + k[r + j] * pair).astype(np.float32)
    return out


def make_texture(rng, res=1024, smooth=3, cv2_blur=True):
    """Random smooth texture: Gaussian-blurred uniform noise in [0, 1].
    cv2_blur: blur as cv2.GaussianBlur does (`gaussian_blur_cv2`), so the
    texture is scripts/synth_dataset.py's where cv2 is installed; False
    blurs with scipy's gaussian_filter, whose last float bits differ and
    flip a few pixels of a render by one grey level (the arc scene's,
    kept so that the recorded digests of its images and bins hold)."""
    t = rng.uniform(0, 1, (res, res)).astype(np.float32)
    if cv2_blur:
        t = gaussian_blur_cv2(t, smooth)
    else:
        # mode "mirror" is cv2's default BORDER_REFLECT_101
        t = gaussian_filter(t, smooth, mode="mirror", truncate=4.0)
    t = (t - t.min()) / (t.max() - t.min() + 1e-9)
    return t


def blob_texture(h=256, w=256, seed=0, n_blobs=120):
    """Random Gaussian-blob texture with well-defined interest points, in
    [0, 1], and the blob centers (the draws of tests/test_sift.py's
    make_texture, which the ORB and SIFT tests use)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    ys = rng.uniform(20, h - 20, n_blobs)
    xs = rng.uniform(20, w - 20, n_blobs)
    sg = rng.uniform(1.5, 4.0, n_blobs)
    amp = rng.uniform(0.4, 1.0, n_blobs) * rng.choice([-1, 1], n_blobs)
    yy, xx = np.mgrid[0:h, 0:w]
    for y, x, s, a in zip(ys, xs, sg, amp):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    img = (img - img.min()) / (img.max() - img.min())
    return img, np.stack([xs, ys], -1)


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
              make_texture(rng, cv2_blur=False)),
        # floor y=1.8 spanning x in [-4, 4], z in [0, 8]
        Plane([-ext / 2, 1.8, 0.0], [ext, 0, 0], [0, 0, ext],
              make_texture(rng, cv2_blur=False)),
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


def loop_scene(rng, n_cams, room=6.0, radius=2.5, height=3.6):
    """Square room (4 walls, floor, ceiling), cameras on a circle looking
    tangentially: the trajectory closes on itself after 360 degrees, so
    sequential mapping accumulates drift that only the loop-closure pairs
    (retrieval wraparound) can correct."""
    L = room
    hh = height / 2
    walls = []
    for (p0, ex) in [
        ([-L, -hh, L], [2 * L, 0, 0]),   # wall z=+L
        ([L, -hh, -L], [0, 0, 2 * L]),   # wall x=+L, ex along z
        ([L, -hh, -L], [-2 * L, 0, 0]),  # wall z=-L
        ([-L, -hh, L], [0, 0, -2 * L]),  # wall x=-L
    ]:
        walls.append(Plane(p0, ex, [0, height, 0], make_texture(rng)))
    floor = Plane([-L, hh, -L], [2 * L, 0, 0], [0, 0, 2 * L],
                  make_texture(rng))
    ceil = Plane([-L, -hh, -L], [2 * L, 0, 0], [0, 0, 2 * L],
                 make_texture(rng))
    planes = walls + [floor, ceil]
    poses = []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        center = np.array(
            [radius * np.cos(a), 0.12 * np.sin(3 * a), radius * np.sin(a)]
        )
        # forward along the circle, slightly outward
        fwd = np.array([-np.sin(a), 0.0, np.cos(a)])
        out = np.array([np.cos(a), 0.0, np.sin(a)])
        R = look_at_R(center, center + 4.0 * fwd + 1.2 * out)
        poses.append((R, -R @ center))

    def cdist(i, j):  # circular index distance: the true overlap order
        d = abs(i - j)
        return min(d, n_cams - d)

    ranks = [
        [j for j in sorted(range(n_cams), key=lambda j: cdist(i, j)) if j != i]
        for i in range(n_cams)
    ]
    return planes, poses, ranks


def corridor_scene(rng, n_cams, half_w=3.0, height=4.0, step=0.55):
    """KITTI-like forward motion: two side walls, a floor and an end
    wall."""
    length = n_cams * step + 14.0
    hh = height / 2
    planes = [
        Plane([-half_w, -hh, 0], [0, 0, length], [0, height, 0],
              make_texture(rng)),     # left wall x=-half_w
        Plane([half_w, -hh, 0], [0, 0, length], [0, height, 0],
              make_texture(rng)),     # right wall x=+half_w
        Plane([-half_w, hh, 0], [2 * half_w, 0, 0], [0, 0, length],
              make_texture(rng)),     # floor
        Plane([-half_w, -hh, length], [2 * half_w, 0, 0], [0, height, 0],
              make_texture(rng)),     # end wall
    ]
    poses = []
    for i in range(n_cams):
        center = np.array(
            [0.45 * np.sin(0.13 * i), 0.08 * np.sin(0.4 * i), i * step]
        )
        yaw = 0.06 * np.cos(0.13 * i)
        target = center + np.array([np.sin(yaw) * 4.0, 0.0, 4.0])
        R = look_at_R(center, target)
        poses.append((R, -R @ center))
    ranks = [
        [j for j in sorted(range(n_cams), key=lambda j: abs(i - j)) if j != i]
        for i in range(n_cams)
    ]
    return planes, poses, ranks


SCENES = {"arc": arc_scene, "loop": loop_scene, "corridor": corridor_scene}


def write_dataset(out_dir, n_cams=8, seed=3, w=512, h=384, f=450.0,
                  scene="arc", ext=".png") -> Tuple[List[str], list, np.ndarray]:
    """Render a scene of SCENES into out_dir (layout in the module
    docstring): scripts/synth_dataset.main's text files byte for byte and
    its pixels (the PNG encoder differs).  Returns (image names, poses
    [(R, t)], intrinsics K [3, 3])."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    cx, cy = w / 2, h / 2
    planes, poses, ranks = SCENES[scene](rng, n_cams)
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
            q = rotmat_to_quat_np(R)
            fh.write(
                f"{name} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]}\n"
            )
    with open(os.path.join(out_dir, "retrieval.txt"), "w") as fh:
        for i, name in enumerate(names):
            for j in ranks[i]:
                fh.write(f"{name} {names[j]}\n")
    if scene == "corridor":
        with open(os.path.join(out_dir, "times.txt"), "w") as fh:
            for i in range(n_cams):
                fh.write(f"{i * 0.1:.6e}\n")
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    return names, poses, K


def write_arc_dataset(out_dir, n_cams=8, seed=3, w=512, h=384, f=450.0,
                      ext=".png") -> Tuple[List[str], list, np.ndarray]:
    """`write_dataset` of the arc scene."""
    return write_dataset(out_dir, n_cams, seed, w, h, f, "arc", ext)


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
# feature-level workspaces of scripts/synth_features.py (no images): the
# kitti-class circuit and the unordered landmark scenes
# ---------------------------------------------------------------------------

WS_FX = 500.0
WS_W, WS_H = 960, 720
DISTRACTOR_PTS = 300  # points of each distractor's clutter cluster


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


def append_distractors(rng, centers, R, pts_all, n_distractors, half=14.0):
    """Append n_distractors unregistrable junk frames, each looking at its
    own private clutter cluster far out on a shell of 30 to 90 times the
    scene's half-size: no structure shared with the scene or with another
    distractor (real 1DSfM collections are mostly such frames)."""
    dc = np.zeros((n_distractors, 3))
    dR = np.zeros((n_distractors, 3, 3))
    dpts = []
    for i in range(n_distractors):
        th = rng.uniform(0, 2 * np.pi)
        el = rng.uniform(-1.0, 1.0)
        rad = half * rng.uniform(30.0, 90.0)
        dirv = np.array([np.cos(el) * np.cos(th), np.sin(el),
                         np.cos(el) * np.sin(th)])
        cluster = rad * dirv
        cam = cluster - dirv * rng.uniform(6.0, 12.0) + rng.normal(
            scale=0.5, size=3)
        dc[i] = cam
        dR[i] = look_at_R(cam, cluster)
        dpts.append(cluster + rng.normal(scale=1.5, size=(DISTRACTOR_PTS, 3)))
    return (np.concatenate([centers, dc]), np.concatenate([R, dR]),
            np.concatenate([pts_all] + dpts))


def tour_scene(rng, n_frames, n_distractors=0, frames_per_building=25,
               spacing=24.0):
    """A street of separate building facades walked past from the far
    sidewalk (sparse genuine graph: covisible pairs grow linearly with the
    frame count), with two wide overview shots per gap that bridge
    neighbouring facades; optional distractors."""
    n_buildings = max(2, int(np.ceil(n_frames / frames_per_building)))
    half_w = spacing / 3.0  # facade half-width
    street = 10.0  # facade plane z
    pts = []
    for b in range(n_buildings):
        bx = b * spacing
        npw = 2200
        a = rng.uniform(-half_w, half_w, npw)
        h = rng.uniform(-1.0, 6.0, npw)
        relief = rng.uniform(0.0, 1.2, npw)  # protrusions toward the street
        p = np.zeros((npw, 3))
        p[:, 0] = bx + a
        p[:, 1] = h
        p[:, 2] = street - relief
        pts.append(p)
        n_g = 500  # ground strip in front of the building
        g = np.zeros((n_g, 3))
        g[:, 0] = bx + rng.uniform(-half_w, half_w, n_g)
        g[:, 1] = rng.uniform(-1.2, -0.9, n_g)
        g[:, 2] = rng.uniform(4.0, street - 0.5, n_g)
        pts.append(g)
    pts_all = np.concatenate(pts)
    length = (n_buildings - 1) * spacing
    n_over = max(0, 2 * (n_buildings - 1))
    n_walk = max(2, n_frames - n_over)
    xs = np.sort(rng.uniform(-0.4 * spacing, length + 0.4 * spacing, n_walk))
    over_x = (np.arange(n_over) // 2 + 0.5) * spacing
    centers = np.zeros((n_walk + n_over, 3))
    centers[:n_walk, 0] = xs
    centers[:n_walk, 1] = rng.uniform(-0.2, 1.2, n_walk)
    centers[:n_walk, 2] = rng.uniform(-2.0, 2.0, n_walk)
    centers[n_walk:, 0] = over_x + rng.uniform(-2.0, 2.0, n_over)
    centers[n_walk:, 1] = rng.uniform(0.5, 2.0, n_over)
    centers[n_walk:, 2] = rng.uniform(-24.0, -19.0, n_over)
    R = np.zeros((n_walk + n_over, 3, 3))
    for i in range(n_walk):
        tgt = np.array([xs[i] + rng.uniform(-3.0, 3.0),
                        rng.uniform(0.5, 2.5), street])
        R[i] = look_at_R(centers[i], tgt)
    for i in range(n_over):
        tgt = np.array([over_x[i] + rng.uniform(-2.0, 2.0),
                        rng.uniform(1.0, 3.0), street])
        R[n_walk + i] = look_at_R(centers[n_walk + i], tgt)
    if n_distractors:
        centers, R, pts_all = append_distractors(
            rng, centers, R, pts_all, n_distractors, half=14.0)
    return centers, R, pts_all


def unordered_scene(rng, n_frames, half=14.0, n_distractors=0):
    """Landmark ring (internet photos of one central landmark): cameras on
    an annulus looking inward at a four-facade building with relief and
    ground points around it (dense covisibility, long tracks); optional
    distractors."""
    ang = rng.uniform(0, 2 * np.pi, n_frames)
    rad = rng.uniform(0.55 * half, 1.15 * half, n_frames)
    centers = np.zeros((n_frames, 3))
    centers[:, 0] = rad * np.cos(ang)
    centers[:, 2] = rad * np.sin(ang)
    centers[:, 1] = rng.uniform(-0.5, 1.5, n_frames)
    R = np.zeros((n_frames, 3, 3))
    for i in range(n_frames):
        tgt = np.array([rng.uniform(-2.0, 2.0), rng.uniform(-1.0, 2.0),
                        rng.uniform(-2.0, 2.0)])
        R[i] = look_at_R(centers[i], tgt)
    pts = []
    s = 0.3 * half
    npw = 5000
    for wall in range(4):
        a = rng.uniform(-s, s, npw)
        h = rng.uniform(-1.0, 6.0, npw)
        relief = rng.uniform(0.0, 1.2, npw)
        p = np.zeros((npw, 3))
        if wall == 0:
            p[:, 0], p[:, 2] = a, s - relief
        elif wall == 1:
            p[:, 0], p[:, 2] = a, -s + relief
        elif wall == 2:
            p[:, 0], p[:, 2] = s - relief, a
        else:
            p[:, 0], p[:, 2] = -s + relief, a
        p[:, 1] = h
        pts.append(p)
    n_ground = 4000
    gr = np.zeros((n_ground, 3))
    rr = rng.uniform(0.35 * half, 0.9 * half, n_ground)
    aa = rng.uniform(0, 2 * np.pi, n_ground)
    gr[:, 0] = rr * np.cos(aa)
    gr[:, 2] = rr * np.sin(aa)
    gr[:, 1] = rng.uniform(-1.2, -0.8, n_ground)
    pts.append(gr)
    pts_all = np.concatenate(pts)
    if n_distractors:
        centers, R, pts_all = append_distractors(
            rng, centers, R, pts_all, n_distractors, half=half)
    return centers, R, pts_all


def project_all(centers, R, pts, rng, max_kp=700, z_range=(1.0, 40.0),
                noise_px=0.4, focals=None, k1s=None):
    """Visibility and projection for every frame: per frame (point_ids,
    uv_px), at most max_kp keypoints, nearest first, with Gaussian pixel
    noise.  PINHOLE with WS_FX at the image center, or per-frame
    SIMPLE_RADIAL cameras (focals, k1s [F]): uv = f x (1 + k r^2) + c."""
    cx, cy = WS_W / 2.0, WS_H / 2.0
    out = []
    for i in range(len(centers)):
        f_i = WS_FX if focals is None else float(focals[i])
        k_i = 0.0 if k1s is None else float(k1s[i])
        pc = (pts - centers[i]) @ R[i].T
        z = pc[:, 2]
        ok = (z > z_range[0]) & (z < z_range[1])
        zz = np.where(ok, z, 1.0)
        x = pc[:, 0] / zz
        y = pc[:, 1] / zz
        d = 1.0 + k_i * (x * x + y * y)
        u = f_i * x * d + cx
        v = f_i * y * d + cy
        ok &= (u > 8) & (u < WS_W - 8) & (v > 8) & (v < WS_H - 8)
        ok &= d > 0.6  # the distortion stays monotone inside the view
        ids = np.nonzero(ok)[0]
        if len(ids) > max_kp:
            ids = ids[np.argsort(z[ids])[:max_kp]]
        uv = np.stack([u[ids], v[ids]], 1)
        uv = uv + rng.normal(scale=noise_px, size=uv.shape)
        out.append((ids.astype(np.int64), uv.astype(np.float32)))
    return out


def _pairs_from_shared_points(frames_obs, cand, rng, min_shared,
                              contamination):
    """Verified pairs for the candidate frame pairs: matches from shared
    point ids, at least min_shared of them, with a `contamination` share
    rewired to wrong targets but kept as inliers."""
    pairs = []
    for a, b in cand:
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


SEQ_WINDOW = 5  # the circuit's sequential pairs: each frame's next 5


def build_kitti_pairs(frames_obs, n_frames, rng, loop_centers, min_shared=30,
                      contamination=0.03):
    """Verified pairs of the circuit: every frame with its next SEQ_WINDOW,
    plus up to 3 loop-closure partners within 4 units that are more than 50
    frames apart (every second frame)."""
    cand = set()
    for i in range(n_frames):
        for k in range(1, SEQ_WINDOW + 1):
            if i + k < n_frames:
                cand.add((i, i + k))
    c = loop_centers
    for i in range(0, n_frames, 2):
        d = np.linalg.norm(c - c[i], axis=1)
        close = np.nonzero((d < 4.0)
                           & (np.abs(np.arange(n_frames) - i) > 50))[0]
        for j in close[:3]:
            cand.add((i, int(j)) if i < j else (int(j), i))
    return _pairs_from_shared_points(frames_obs, sorted(cand), rng,
                                     min_shared, contamination)


def build_covisibility_pairs(frames_obs, n_frames, rng, min_shared=30,
                             contamination=0.03, top_per_frame=25):
    """Verified pairs of an unordered scene: frame pairs that co-observe
    at least min_shared points (counted over at most 40 observers of each
    point, sampled), the top_per_frame most covisible of each frame."""
    pt_frames = {}
    for f, (ids, _) in enumerate(frames_obs):
        for k, pid in enumerate(ids):
            pt_frames.setdefault(int(pid), []).append((f, k))
    cnt = Counter()
    for pid, obs in pt_frames.items():
        if len(obs) > 40:
            obs = [obs[x] for x in rng.choice(len(obs), 40, replace=False)]
        fs = sorted(set(f for f, _ in obs))
        for a in range(len(fs)):
            for b in range(a + 1, len(fs)):
                cnt[(fs[a], fs[b])] += 1
    per_frame = [[] for _ in range(n_frames)]
    for (a, b), c_ in cnt.items():
        if c_ >= min_shared:
            per_frame[a].append((c_, a, b))
            per_frame[b].append((c_, a, b))
    cand = set()
    for lst in per_frame:
        lst.sort(reverse=True)
        for c_, a, b in lst[:top_per_frame]:
            cand.add((a, b))
    return _pairs_from_shared_points(frames_obs, sorted(cand), rng,
                                     min_shared, contamination)


def synth_descriptors(frames_obs, n_points, rng, noise=0.25, sparsity=0.65):
    """Matchable uint8 descriptors: per 3D point a sparse non-negative raw
    histogram, per observation multiplicative noise, L1-root normalized
    and scaled by 512 as the matcher's quantization expects."""
    raw = rng.exponential(1.0, size=(n_points, 128)).astype(np.float32)
    raw *= rng.random((n_points, 128)) > sparsity  # sparse support
    raw += 1e-6
    descs = []
    for ids, _uv in frames_obs:
        r = raw[ids] * (1.0 + rng.normal(scale=noise, size=(len(ids), 128))
                        ).clip(0.05)
        v = np.sqrt(r / r.sum(axis=1, keepdims=True))
        descs.append(np.clip(512.0 * v, 0, 255).astype(np.uint8))
    return descs


def write_features_workspace(out_dir, scene="kitti", n_frames=1000, seed=0,
                             per_image_cameras=False, focal_noise=0.08,
                             descriptors=False, distractors=0) -> dict:
    """scripts/synth_features.main, byte for byte for the same arguments:
    the kitti-class circuit ("kitti"), the landmark ring ("unordered") or
    the street tour ("tour"), with `distractors` junk frames after the
    n_frames genuine ones (not for "kitti").  Writes ftr.bin (keypoints at
    scale 2; descriptors matchable with `descriptors`, else zeros), fp.bin
    (the ground-truth pairs: the circuit's window and loop closures, or
    covisibility), gt_poses.txt, size.bin with `descriptors`, and either
    camera.txt (one PINHOLE camera) or, with `per_image_cameras`, per frame
    a SIMPLE_RADIAL camera (true focal U[430, 570], k1 U[-0.08, 0.04]):
    camera_info.txt with EXIF-grade focals (the true ones off by
    U[-focal_noise, +focal_noise], k = 0) and gt_cameras.txt (name focal
    k1).

    Returns a dict: names, ids (observed point ids per frame), n_points,
    n_scene_points (a point id below it is scene structure, so two frames'
    shared ids below it give their ground-truth covisibility), n_obs and
    n_pairs."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    if scene == "kitti":
        centers, R, pts = kitti_scene(rng, n_frames)
        distractors = 0
    else:
        make = tour_scene if scene == "tour" else unordered_scene
        centers, R, pts = make(rng, n_frames, n_distractors=distractors)
    n_total = len(centers)
    focals = k1s = None
    if per_image_cameras:
        focals = rng.uniform(430.0, 570.0, n_total)
        k1s = rng.uniform(-0.08, 0.04, n_total)
    frames_obs = project_all(centers, R, pts, rng, focals=focals, k1s=k1s)
    names = [f"img{i:05d}.png" for i in range(n_total)]
    descs = (synth_descriptors(frames_obs, len(pts), rng) if descriptors
             else None)
    feats = []
    for i, (_ids, uv) in enumerate(frames_obs):
        kp = np.zeros((len(uv), 4), np.float32)
        kp[:, :2] = uv
        kp[:, 2] = 2.0
        feats.append(IOF.FrameFeatures(
            name=names[i], keypoints=kp,
            descriptors=(descs[i] if descs is not None
                         else np.zeros((len(uv), 128), np.uint8))))
    IOF.write_features(os.path.join(out_dir, "ftr.bin"), feats,
                       with_descs=True)
    if descriptors:
        IOF.write_image_size(os.path.join(out_dir, "size.bin"),
                             np.tile(np.asarray([[WS_W, WS_H]], np.int32),
                                     (n_total, 1)))
    if scene == "kitti":
        pairs = build_kitti_pairs(frames_obs, n_total, rng, centers)
    else:
        pairs = build_covisibility_pairs(frames_obs, n_total, rng)
    IOF.write_frame_pairs(os.path.join(out_dir, "fp.bin"), pairs)
    cx, cy = WS_W / 2.0, WS_H / 2.0
    if per_image_cameras:
        noisy = focals * (1.0 + rng.uniform(-focal_noise, focal_noise,
                                            n_total))
        with open(os.path.join(out_dir, "camera_info.txt"), "w") as f:
            for i in range(n_total):
                f.write(f"{names[i]} SIMPLE_RADIAL {WS_W} {WS_H} "
                        f"{noisy[i]:.3f} {cx} {cy} 0.0\n")
        with open(os.path.join(out_dir, "gt_cameras.txt"), "w") as f:
            for i in range(n_total):
                f.write(f"{names[i]} {focals[i]:.6f} {k1s[i]:.8f}\n")
    else:
        with open(os.path.join(out_dir, "camera.txt"), "w") as f:
            f.write(f"0 PINHOLE {WS_W} {WS_H} {WS_FX} {WS_FX} {cx} {cy}\n")
    with open(os.path.join(out_dir, "gt_poses.txt"), "w") as f:
        for i in range(n_total):
            q = rotmat_to_quat_np(R[i])
            t = -R[i] @ centers[i]
            f.write(f"{names[i]} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
                    f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f}\n")
    return dict(names=names, ids=[ids for ids, _ in frames_obs],
                n_points=len(pts),
                n_scene_points=len(pts) - DISTRACTOR_PTS * distractors,
                n_obs=sum(len(uv) for _, uv in frames_obs),
                n_pairs=len(pairs))


def write_kitti_workspace(out_dir, n_frames=1000, seed=0):
    """`write_features_workspace` of the kitti-class circuit (scripts/
    synth_features.py --scene kitti): ftr.bin with zero descriptors,
    fp.bin with loop closures, camera.txt and gt_poses.txt.  Returns the
    image names."""
    return write_features_workspace(out_dir, "kitti", n_frames, seed)["names"]


def write_unordered_workspace(out_dir, scene="unordered", n_frames=80,
                              seed=0, distractors=0, focal_noise=0.08):
    """`write_features_workspace` of the 1DSfM regime (scripts/
    synth_features.py --per_image_cameras --descriptors): the landmark
    ring ("unordered") or the street tour ("tour") with per-image
    SIMPLE_RADIAL cameras and matchable descriptors.  Returns (names,
    observed point ids per frame, number of genuine scene points)."""
    w = write_features_workspace(out_dir, scene, n_frames, seed,
                                 per_image_cameras=True,
                                 focal_noise=focal_noise, descriptors=True,
                                 distractors=distractors)
    return w["names"], w["ids"], w["n_scene_points"]


def tag_detections(m, centers, tag_length, scale, seed=0, noise_px=0.5):
    """Square tags of side tag_length meters centered at `centers` [T, 3]
    of a map whose unit is 1/scale meters, facing the mean center of its
    registered cameras, in feature/tags.canonical_corners' corner order;
    their corners projected into every registered frame that sees all
    four (in front of the camera, inside the image), with Gaussian pixel
    noise.  Returns (detections {frame: {tag: [4, 2] pixels}}, corners
    {tag: [4, 3] world}), as feature/tags' functions take them."""
    import torch

    from . import camera as Cam
    from . import geometry as G

    rng = np.random.default_rng(seed)
    h = tag_length / 2.0
    canon = np.array([[-h, h, 0.0], [h, h, 0.0], [h, -h, 0.0],
                      [-h, -h, 0.0]])
    reg = np.nonzero(m.registered)[0]
    eye = np.mean([G.pose_center_np(m.q[f], m.t[f]) for f in reg], axis=0)
    corners = {}
    for tag, c in enumerate(np.asarray(centers, np.float64)):
        n = eye - c
        n /= np.linalg.norm(n)
        u = np.cross(n, rng.normal(size=3))
        u /= np.linalg.norm(u)
        R = np.stack([u, np.cross(n, u), n], axis=1)  # proper rotation
        corners[tag] = c + scale * canon @ R.T
    detections = {}
    for f in reg:
        cid = int(m.cam_of_frame[f])
        _, _, w, hgt = m.camera_models[cid]
        params = torch.as_tensor(np.asarray(m.cameras[cid], np.float64))
        seen = {}
        for tag, cw in corners.items():
            xy, z = Cam.project(params, torch.as_tensor(m.q[f]),
                                torch.as_tensor(m.t[f]), torch.as_tensor(cw))
            xy, z = xy.numpy(), z.numpy()
            if (z > 1e-3).all() and (xy >= 0).all() and \
                    (xy[:, 0] < w).all() and (xy[:, 1] < hgt).all():
                seen[tag] = xy + rng.normal(scale=noise_px, size=xy.shape)
        if seen:
            detections[int(f)] = seen
    return detections, corners
