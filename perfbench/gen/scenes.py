"""Image sequences of textured planes, rendered on the card from a seed.

The scenes are the port's synthetic image scenes (the geometry of
scripts/synth_dataset.py: planes, camera path, intrinsics), rendered here
with the benchmark's own code: each plane's texture is seeded uniform noise
blurred by a Gaussian of sigma 3 (a 25-tap kernel, reflected borders) and
stretched to [0, 1]; each pixel's ray takes the nearest plane it hits and
that plane's texel, as 8-bit gray.  Every pixel shows a known 3D point, so
the ground-truth poses and the planes themselves judge a reconstruction.

The textures are drawn by a torch.Generator on the device and rendering is
elementwise float64 arithmetic, so one seed gives the same images on every
run on one kind of device.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch


def look_at(center, target, up=(0.0, -1.0, 0.0)):
    """World-to-camera rotation of a camera at center looking at target."""
    z = np.asarray(target, np.float64) - center
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def corridor(n, half_w=3.0, height=4.0, step=0.55):
    """Forward motion down a corridor: two side walls, a floor and an end
    wall.  Returns (planes [(p0, ex, ey)], poses [(R, t)] world to
    camera)."""
    length = n * step + 14.0
    hh = height / 2
    planes = [([-half_w, -hh, 0], [0, 0, length], [0, height, 0]),
              ([half_w, -hh, 0], [0, 0, length], [0, height, 0]),
              ([-half_w, hh, 0], [2 * half_w, 0, 0], [0, 0, length]),
              ([-half_w, -hh, length], [2 * half_w, 0, 0], [0, height, 0])]
    poses = []
    for i in range(n):
        c = np.array([0.45 * np.sin(0.13 * i), 0.08 * np.sin(0.4 * i),
                      i * step])
        yaw = 0.06 * np.cos(0.13 * i)
        R = look_at(c, c + np.array([np.sin(yaw) * 4.0, 0.0, 4.0]))
        poses.append((R, -R @ c))
    return planes, poses


SCENES = {"corridor": corridor}


def _blur_kernel(sigma: float):
    n = int(round(sigma * 8 + 1)) | 1
    x = np.arange(n) - n // 2
    k = np.exp(-x * x / (2 * sigma * sigma))
    return k / k.sum()


def textures(n: int, res: int, sigma: float, seed: int, device):
    """n seeded [res, res] textures in [0, 1] (float32, on device)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    t = torch.rand((n, res, res), generator=g, device=device)
    k = _blur_kernel(sigma)
    r = len(k) // 2
    for dim in (2, 1):
        p = torch.nn.functional.pad(
            t[:, None], (r, r, 0, 0) if dim == 2 else (0, 0, r, r),
            mode="reflect")[:, 0]
        acc = torch.zeros_like(t)
        for j, w in enumerate(k):
            acc += float(w) * (p[:, :, j:j + res] if dim == 2
                               else p[:, j:j + res, :])
        t = acc
    lo = t.amin(dim=(1, 2), keepdim=True)
    hi = t.amax(dim=(1, 2), keepdim=True)
    return (t - lo) / (hi - lo + 1e-9)


def render(planes, texs, R, t, f, w, h, device, cx=None, cy=None,
           near=0.2):
    """[h, w] uint8 image of the planes from pose (R, t): nearest hit.
    The principal point (cx, cy) defaults to the image's centre."""
    cx = w / 2 if cx is None else cx
    cy = h / 2 if cy is None else cy
    f64 = torch.float64
    yy, xx = torch.meshgrid(torch.arange(h, dtype=f64, device=device),
                            torch.arange(w, dtype=f64, device=device),
                            indexing="ij")
    Rt = torch.as_tensor(R, dtype=f64, device=device).T
    d = torch.stack([(xx - cx) / f, (yy - cy) / f,
                     torch.ones_like(xx)], -1) @ Rt.T
    o = -Rt @ torch.as_tensor(t, dtype=f64, device=device)
    img = torch.zeros((h, w), dtype=f64, device=device)
    depth = torch.full((h, w), math.inf, dtype=f64, device=device)
    res = texs.shape[-1]
    for (p0, ex, ey), tex in zip(planes, texs):
        p0, ex, ey = (torch.as_tensor(v, dtype=f64, device=device)
                      for v in (p0, ex, ey))
        nrm = torch.linalg.cross(ex, ey)
        nrm = nrm / nrm.norm()
        dn = d @ nrm
        safe = dn.abs() > 1e-9
        s = torch.where(safe, ((p0 - o) @ nrm) / torch.where(safe, dn, 1.0),
                        -1.0)
        rel = o + s[..., None] * d - p0
        uu = (rel @ ex) / (ex @ ex)
        vv = (rel @ ey) / (ey @ ey)
        ok = (s > near) & (s < depth) & (uu >= 0) & (uu < 1) & (vv >= 0) \
            & (vv < 1)
        ui = (uu * (res - 1)).clamp(0, res - 1).long()
        vi = (vv * (res - 1)).clamp(0, res - 1).long()
        img = torch.where(ok, tex[vi, ui].double(), img)
        depth = torch.where(ok, s, depth)
    return (img.clamp(0, 1) * 255).to(torch.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """8-bit gray PNG, filter 0 on every row."""
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(chunk(b"IEND", b""))


def write_sequence(cfg: dict, seed: int, out_dir: str, device):
    """Render the configuration's scene into out_dir/images (frame%04d.png)
    and out_dir/camera.txt (one PINHOLE camera; the principal point is
    the configuration's cx, cy, or the image's centre).  Returns (image
    names, planes, poses)."""
    planes, poses = SCENES[cfg["scene"]](cfg["n_frames"])
    w, h, f = cfg["width"], cfg["height"], cfg["focal_px"]
    cx, cy = cfg.get("cx", w / 2), cfg.get("cy", h / 2)
    texs = textures(len(planes), cfg["texture_res"], cfg["texture_blur"],
                    seed, device)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    names = []
    for i, (R, t) in enumerate(poses):
        img = render(planes, texs, R, t, f, w, h, device, cx,
                     cy).cpu().numpy()
        name = f"frame{i:04d}.png"
        write_png(os.path.join(out_dir, "images", name), img)
        names.append(name)
    with open(os.path.join(out_dir, "camera.txt"), "w") as fh:
        fh.write(f"0 PINHOLE {w} {h} {f} {f} {cx} {cy}\n")
    return names, planes, poses
