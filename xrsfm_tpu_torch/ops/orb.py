"""ORB feature extraction in PyTorch ops (port of xrsfm_tpu/ops/orb.py;
reference: src/feature/feature_extraction.cc:21-56, ORB_SLAM2's
OrbExtractor with 2048 features, 8 pyramid levels, scale 1.2, FAST
thresholds 20/7; the Hamming matcher is ops/matching.
match_descriptors_hamming, reference OrbMatch
feature_processing.cc:156-219).

Per pyramid level, on the extractor's device:
  * FAST-9 on the 16-pixel Bresenham circle as 16 rolled comparisons and
    windowed ANDs over the circular axis (torch.roll wraps as jnp.roll
    does; the 19-pixel border mask hides the wrap);
  * 3x3 non-max suppression by max_pool2d (padded with -inf, as
    reduce_window is), keeping plateaus (score >= max);
  * a fixed pool of the level's best scores: a stable descending sort, so
    that equal scores go to the lower pixel index as jax.lax.top_k sends
    them (equal FAST scores are common on uint8 images);
  * orientation by the intensity centroid of a radius-15 disk;
  * steered BRIEF-256 from the same seeded Gaussian pattern as the JAX
    package (so both packages compare the same pixel pairs), through
    bilinear taps, packed to 32 uint8 bytes.
The pyramid resizes by bilinear interpolation with antialiasing, as
jax.image.resize does when it downscales, to the same rounded sizes.

Bits can differ from the JAX package's near a tie: a bilinear tap, atan2
or a `va < vb` comparison at the last float32 bit (tests/test_torch_orb.py
measures the share of equal bits).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class OrbOptions:
    num_features: int = 2048
    num_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0 / 255.0  # reference initTh on [0,255]
    fast_threshold_min: float = 7.0 / 255.0
    patch_size: int = 31
    border: int = 19


# 16-pixel Bresenham circle of radius 3 (standard FAST ordering), (dy, dx)
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3),
    ],
    np.int32,
)


def _fast_score(img: torch.Tensor, th: float):
    """FAST-9 corner mask and score of one image [H,W]: (corner [H,W]
    bool, score [H,W] = the sum of |diff| over the taps past the
    threshold)."""
    taps = torch.stack([torch.roll(img, (-int(dy), -int(dx)), (0, 1))
                        for dy, dx in _CIRCLE])  # [16,H,W]
    d = taps - img[None]
    bright = d > th
    dark = d < -th

    def arc9(b):
        # a contiguous run of >= 9 around the 16-cycle
        acc = b
        for k in range(1, 9):
            acc = acc & torch.roll(b, -k, 0)
        return acc.any(0)

    corner = arc9(bright) | arc9(dark)
    score = (d.abs() * (bright | dark)).sum(0)
    return corner, score


def _nms3(score: torch.Tensor) -> torch.Tensor:
    m = F.max_pool2d(score[None, None], 3, 1, 1)[0, 0]
    return score >= m


def _brief_pattern(n_pairs: int = 256, patch: int = 31, seed: int = 7):
    """Gaussian point-pair pattern (the original BRIEF construction), the
    JAX package's seeded numpy draw."""
    rng = np.random.default_rng(seed)
    s = patch / 5.0
    a = np.clip(rng.normal(scale=s, size=(n_pairs, 2)), -(patch // 2),
                patch // 2)
    b = np.clip(rng.normal(scale=s, size=(n_pairs, 2)), -(patch // 2),
                patch // 2)
    return a.astype(np.float32), b.astype(np.float32)


_PAT_A, _PAT_B = _brief_pattern()


def _bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Bilinear samples of img [H,W] at (ys, xs) of any shape; taps
    outside the image read 0."""
    H, W = img.shape
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    fy = ys - y0
    fx = xs - x0

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        return torch.where(ok, v, 0.0)

    return (tap(y0, x0) * (1 - fy) * (1 - fx)
            + tap(y0, x0 + 1) * (1 - fy) * fx
            + tap(y0 + 1, x0) * fy * (1 - fx)
            + tap(y0 + 1, x0 + 1) * fy * fx)


def _orientation(img, ys, xs, radius: int = 15):
    """Intensity-centroid orientation (ORB's m10/m01 moments), [K]."""
    off = torch.arange(-radius, radius + 1, dtype=torch.float32,
                       device=img.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    disk = (oy ** 2 + ox ** 2 <= radius ** 2).to(torch.float32)
    v = _bilinear(img, ys[:, None, None] + oy, xs[:, None, None] + ox) * disk
    m10 = (v * ox).sum((1, 2))
    m01 = (v * oy).sum((1, 2))
    return torch.atan2(m01, m10)


def _descriptors(img, ys, xs, thetas):
    """Steered BRIEF-256 -> [K, 32] uint8."""
    pa = torch.from_numpy(_PAT_A).to(img.device)  # [256,2] (y, x)
    pb = torch.from_numpy(_PAT_B).to(img.device)
    ct = torch.cos(thetas)[:, None]
    st = torch.sin(thetas)[:, None]
    ay = ct * pa[:, 0] + st * pa[:, 1]
    ax = -st * pa[:, 0] + ct * pa[:, 1]
    by = ct * pb[:, 0] + st * pb[:, 1]
    bx = -st * pb[:, 0] + ct * pb[:, 1]
    va = _bilinear(img, ys[:, None] + ay, xs[:, None] + ax)
    vb = _bilinear(img, ys[:, None] + by, xs[:, None] + bx)
    bits = (va < vb).to(torch.int32).reshape(-1, 32, 8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=img.device)
    return (bits * weights).sum(2).to(torch.uint8)


def _top_k(x: torch.Tensor, k: int):
    """The k largest values of a 1-D tensor and their indices; equal
    values in ascending index order (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _extract_level(img: torch.Tensor, th: float, opts: OrbOptions,
                   k_pool: int):
    """One pyramid level [h,w]: (xs, ys, thetas, scores, descriptors
    [k_pool,32], valid [k_pool]) of the level's k_pool best corners."""
    h, w = img.shape
    corner, score = _fast_score(img, th)
    b = opts.border
    mask = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    mask[b:-b, b:-b] = True
    sc = torch.where(corner & _nms3(score) & mask, score, 0.0)
    vals, idx = _top_k(sc.reshape(-1), k_pool)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    valid = vals > 0
    thetas = _orientation(img, ys, xs)
    descs = _descriptors(img, ys, xs, thetas)
    return xs, ys, thetas, vals, descs, valid


def _downscale(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize with antialiasing (jax.image.resize "bilinear")."""
    return F.interpolate(img[None, None], size=(h, w), mode="bilinear",
                         antialias=True, align_corners=False)[0, 0]


class OrbExtractor:
    """The host side: the pyramid loop, one extraction per level on an
    explicit device."""

    def __init__(self, opts: OrbOptions = OrbOptions(), device="cuda"):
        self.opts = opts
        self.device = resolve_device(device)

    def extract(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """image [H,W] float32 in [0,1] (or uint8).

        Returns (keypoints [N,4]: x, y, scale, angle in full-resolution
        pixels; descriptors [N,32] uint8)."""
        o = self.opts
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        per_level = max(o.num_features // o.num_levels, 1)
        kxs, kys, kth, ksc, kd, klvl = [], [], [], [], [], []
        cur = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        scale = 1.0
        for _lvl in range(o.num_levels):
            h, w = cur.shape
            if min(h, w) < 2 * o.border + 8:
                break
            for th in (o.fast_threshold, o.fast_threshold_min):
                xs, ys, thetas, vals, descs, valid = _extract_level(
                    cur, th, o, per_level)
                # one host read a level and threshold: the retry rule
                n_ok = int(valid.sum())
                if n_ok >= per_level // 2 or th == o.fast_threshold_min:
                    break
            v = valid.cpu().numpy()
            kxs.append(xs.cpu().numpy()[v] * scale)
            kys.append(ys.cpu().numpy()[v] * scale)
            kth.append(thetas.cpu().numpy()[v])
            ksc.append(vals.cpu().numpy()[v])
            kd.append(descs.cpu().numpy()[v])
            klvl.append(np.full(int(v.sum()), scale, np.float32))
            cur = _downscale(cur, int(round(h / o.scale_factor)),
                             int(round(w / o.scale_factor)))
            scale *= o.scale_factor
        if not kxs:
            return np.zeros((0, 4), np.float32), np.zeros((0, 32), np.uint8)
        xs = np.concatenate(kxs)
        ys = np.concatenate(kys)
        thetas = np.concatenate(kth)
        scores = np.concatenate(ksc)
        descs = np.concatenate(kd)
        scales = np.concatenate(klvl)
        order = np.argsort(-scores)[: o.num_features]
        kps = np.stack([xs[order], ys[order], scales[order], thetas[order]],
                       axis=1).astype(np.float32)
        return kps, descs[order]
