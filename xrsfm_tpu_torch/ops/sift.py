"""Batched SIFT feature extraction (port of xrsfm_tpu/ops/sift.py).

Replacement for SiftGPU (reference: 3rdparty/SiftGPU — Gaussian pyramid
FilterH/FilterV ProgramCU.cu:123-233, DoG :521-590, keypoint detection
ComputeKEY_Kernel :592-756, orientation :758-1052, descriptor
ComputeDescriptor_Kernel :1054-1202; driven through
src/feature/sift_extractor.cc:11-150 with options: first octave -1 (2x
upsample), 3 DoG levels/octave, peak threshold 0.02/3, edge threshold 10,
one orientation per keypoint, L1-root normalization and 512*v uint8
quantization, max 8192 features).

Plain PyTorch ops over a leading image dimension:
  * the pyramid is separable float32 conv2d with zero padding, run under
    `full_precision` so cuDNN does not use TF32;
  * extrema are 3x3 max pools (min as -max(-x)) across DoG levels, the
    edge test uses torch.roll; subpixel refinement solves the 3x3
    quadratic fit (x, y, scale) in closed form for every candidate;
  * a fixed-size keypoint pool per octave (top |DoG|) is re-ranked into
    the global max_features pool; both rankings use a stable descending
    sort, so equal scores keep the lower index first, as lax.top_k does;
  * orientation histograms and the 4x4x8 descriptor come from one
    gathered patch per keypoint and soft binning written as batched
    matmuls with one-hot-like weight matrices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import full_precision, resolve_device


@dataclasses.dataclass(frozen=True)
class SiftOptions:
    num_octaves: int = 5
    levels_per_octave: int = 3  # DoG levels searched per octave
    sigma0: float = 1.6  # base blur of level 0
    init_sigma: float = 0.5  # assumed blur of the input image
    first_octave: int = -1  # -1 = 2x upsample first (SiftGPU -fo -1)
    peak_threshold: float = 0.02 / 3.0  # SiftGPU dog threshold
    edge_threshold: float = 10.0
    max_features: int = 8192
    # top-|DoG| candidate pool of octave 0; higher octaves shrink with
    # their area (pool >> o, floor 128): detections drop ~4x per octave,
    # and orientation+descriptor work is proportional to pool slots
    features_per_octave: int = 4096
    pool_floor: int = 128
    descriptor_patch: int = 16  # gradient samples per side
    ori_bins: int = 36


# side of the orientation pass's sample grid, as shipped by the JAX
# package (xrsfm_tpu/ops/sift.py:334); see ROADMAP.md on 14 versus 16
_ORI_PATCH = 14


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1)
    k = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _sep_blur(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """img [B,H,W] -> separable gaussian blur with zero (SAME) padding."""
    kt = torch.from_numpy(k).to(img.device)
    r = len(k) // 2
    x = img[:, None]
    x = F.conv2d(x, kt.view(1, 1, 1, -1), padding=(0, r))
    x = F.conv2d(x, kt.view(1, 1, -1, 1), padding=(r, 0))
    return x[:, 0]


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    return img[:, ::2, ::2]


def _upsample2(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample [B,H,W] -> [B,2H,2W] (half-pixel centres, as
    jax.image.resize)."""
    B, H, W = img.shape
    return F.interpolate(img[:, None], size=(2 * H, 2 * W), mode="bilinear",
                         align_corners=False)[:, 0]


def _local_extrema(dog: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dog [B,L,H,W] -> (is_max, is_min) for interior levels [B,L-2,H,W]."""
    mx = F.max_pool2d(dog, 3, 1, 1)  # 3x3 in-plane max per level
    mn = -F.max_pool2d(-dog, 3, 1, 1)
    c = dog[:, 1:-1]
    up_mx, dn_mx = mx[:, 2:], mx[:, :-2]
    up_mn, dn_mn = mn[:, 2:], mn[:, :-2]
    same_mx, same_mn = mx[:, 1:-1], mn[:, 1:-1]
    is_max = (c >= same_mx) & (c > up_mx) & (c > dn_mx)
    is_min = (c <= same_mn) & (c < up_mn) & (c < dn_mn)
    return is_max, is_min


def _edge_response_ok(dog_c: torch.Tensor, edge_th: float) -> torch.Tensor:
    """2x2 Hessian edge test on the center level [..., H, W]."""
    r_ = torch.roll
    dxx = r_(dog_c, -1, -1) + r_(dog_c, 1, -1) - 2 * dog_c
    dyy = r_(dog_c, -1, -2) + r_(dog_c, 1, -2) - 2 * dog_c
    dxy = 0.25 * (
        r_(r_(dog_c, -1, -1), -1, -2)
        + r_(r_(dog_c, 1, -1), 1, -2)
        - r_(r_(dog_c, -1, -1), 1, -2)
        - r_(r_(dog_c, 1, -1), -1, -2)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_th
    return (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)


def _top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dim in
    descending order; equal values keep the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _extract_octave(dogs, octave_scale, opts: SiftOptions, k_pool: int):
    """One octave: dogs [B,L+2,H,W].

    Returns per image: xy [B,K,2] (full-res pixels), sigma [B,K],
    score [B,K], level_idx [B,K], valid [B,K]."""
    B, Lp2, H, W = dogs.shape
    is_max, is_min = _local_extrema(dogs)  # [B, L, H, W]
    c = dogs[:, 1:-1]
    peak_ok = c.abs() > opts.peak_threshold
    edge_ok = _edge_response_ok(c, opts.edge_threshold)
    cand = (is_max | is_min) & peak_ok & edge_ok
    border = 8
    inner = torch.zeros((H, W), dtype=torch.bool, device=dogs.device)
    inner[border:-border, border:-border] = True
    cand = cand & inner

    score = torch.where(cand, c.abs(), 0.0)  # [B, L, H, W]
    vals, idx = _top_k_stable(score.reshape(B, -1), k_pool)  # [B, K]
    lvl = idx // (H * W)
    rem = idx % (H * W)
    ys = (rem // W).to(torch.float32)
    xs = (rem % W).to(torch.float32)
    valid = vals > 0

    # subpixel refinement via the full 3D quadratic fit over (x, y, scale)
    # (reference: SiftGPU refines all three axes)
    bi = torch.arange(B, device=dogs.device)[:, None]
    l_i = lvl + 1
    y_i = rem // W
    x_i = rem % W

    def g(dl, dy, dx):
        return dogs[bi, l_i + dl, (y_i + dy).clamp(0, H - 1),
                    (x_i + dx).clamp(0, W - 1)]

    gx = 0.5 * (g(0, 0, 1) - g(0, 0, -1))
    gy = 0.5 * (g(0, 1, 0) - g(0, -1, 0))
    gl = 0.5 * (g(1, 0, 0) - g(-1, 0, 0))
    c0 = g(0, 0, 0)
    hxx = g(0, 0, 1) + g(0, 0, -1) - 2 * c0
    hyy = g(0, 1, 0) + g(0, -1, 0) - 2 * c0
    hll = g(1, 0, 0) + g(-1, 0, 0) - 2 * c0
    hxy = 0.25 * (g(0, 1, 1) + g(0, -1, -1) - g(0, 1, -1) - g(0, -1, 1))
    hxl = 0.25 * (g(1, 0, 1) + g(-1, 0, -1) - g(1, 0, -1) - g(-1, 0, 1))
    hyl = 0.25 * (g(1, 1, 0) + g(-1, -1, 0) - g(1, -1, 0) - g(-1, 1, 0))
    # closed-form 3x3 solve H @ o = -grad via the adjugate
    A = hyy * hll - hyl * hyl
    Bm = -(hxy * hll - hyl * hxl)
    C = hxy * hyl - hyy * hxl
    det = hxx * A + hxy * Bm + hxl * C
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    ox = -(A * gx + Bm * gy + C * gl) / det
    oy = -(
        Bm * gx + (hxx * hll - hxl * hxl) * gy
        - (hxx * hyl - hxy * hxl) * gl
    ) / det
    ol = -(
        C * gx - (hxx * hyl - hxy * hxl) * gy
        + (hxx * hyy - hxy * hxy) * gl
    ) / det
    ox = ox.clamp(-0.5, 0.5)
    oy = oy.clamp(-0.5, 0.5)
    ol = ol.clamp(-0.5, 0.5)
    xr, yr = xs + ox, ys + oy

    sigma = opts.sigma0 * torch.pow(
        2.0, (lvl + 1 + ol) / opts.levels_per_octave
    )
    xy_full = torch.stack([xr, yr], -1) * octave_scale
    return xy_full, sigma * octave_scale, vals, lvl, valid


def _soft_onehot(vals: torch.Tensor, n: int, wrap: bool) -> torch.Tensor:
    """vals [...] continuous bin coords -> [..., n] linear soft assignment."""
    i = torch.arange(n, dtype=vals.dtype, device=vals.device)
    d = vals[..., None] - i
    if wrap:
        d = d - n * torch.round(d / n)
    return (1.0 - d.abs()).clamp_min(0.0)


def _patch_gradients(v: torch.Tensor):
    """Central-difference gradients of a [..., P, P] patch, zero on the
    border rows/columns."""
    gx = 0.5 * (torch.roll(v, -1, -1) - torch.roll(v, 1, -1))
    gy = 0.5 * (torch.roll(v, -1, -2) - torch.roll(v, 1, -2))
    P = v.shape[-1]
    edge = torch.ones(P, dtype=v.dtype, device=v.device)
    edge[0] = 0.0
    edge[-1] = 0.0
    return gx * edge[None, :], gy * edge[:, None]


def _level_index(gstack, lvls):
    """Flat offsets of each keypoint's level plane in gstack [B,L,H,W]."""
    B, L, H, W = gstack.shape
    b = torch.arange(B, device=gstack.device)[:, None]
    return ((b * L + lvls) * (H * W))[..., None, None]  # [B,K,1,1]


def _bilinear_gather_lvl(gstack, lvls, ys, xs):
    """gstack [B,L,H,W]; lvls [B,K] per-keypoint level; ys, xs [B,K,P,P];
    zero outside the image."""
    B, L, H, W = gstack.shape
    flat = gstack.reshape(-1)
    base = _level_index(gstack, lvls)
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    fy = ys - y0f
    fx = xs - x0f
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = flat[base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)]
        return torch.where(ok, v, 0.0)

    return (
        tap(y0, x0) * (1 - fy) * (1 - fx)
        + tap(y0, x0 + 1) * (1 - fy) * fx
        + tap(y0 + 1, x0) * fy * (1 - fx)
        + tap(y0 + 1, x0 + 1) * fy * fx
    )


def _nn_gather_lvl(gstack, lvls, ys, xs):
    """Nearest-neighbour tap (1 gather instead of bilinear's 4), for the
    descriptor pass only: its soft spatial/angular binning absorbs the
    half-pixel sample placement.  The orientation pass keeps bilinear
    taps: quantized gradient directions there jitter the dominant
    orientation and move the descriptor grid with viewpoint."""
    B, L, H, W = gstack.shape
    yy = torch.round(ys).to(torch.int64)
    xx = torch.round(xs).to(torch.int64)
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    v = gstack.reshape(-1)[_level_index(gstack, lvls)
                           + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)]
    return torch.where(ok, v, 0.0)


def _grid(P: int, dev):
    offs = torch.arange(P, device=dev) - (P - 1) / 2.0
    return torch.meshgrid(offs, offs, indexing="ij")  # oy, ox [P,P]


def _orientation_and_descriptor(gstack, lvls, xs, ys, sigma,
                                opts: SiftOptions):
    """Dominant orientation + 128-d descriptor for the keypoints of one
    octave.  gstack [B,Lg,H,W] gaussian levels; lvls [B,K] level index
    into gstack; xs, ys [B,K]; sigma [B,K] in octave coordinates.

    Returns (angle [B,K], desc [B,K,128])."""
    dev = gstack.device
    P = opts.descriptor_patch
    nb = opts.ori_bins
    sp = (0.75 * sigma)[..., None, None]  # [B,K,1,1]
    x = xs[..., None, None]
    y = ys[..., None, None]

    # orientation: Lowe's window sigma_w = 1.5 sigma_kp = 2 grid cells at
    # 0.75-sigma spacing, sampled on its own _ORI_PATCH^2 grid
    oy_o, ox_o = _grid(_ORI_PATCH, dev)
    wgt_ori = torch.exp(-(ox_o**2 + oy_o**2) / (2 * 2.0**2))
    v = _bilinear_gather_lvl(gstack, lvls, y + oy_o * sp, x + ox_o * sp)
    gx, gy = _patch_gradients(v)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-18)
    ang = torch.atan2(gy, gx)  # [-pi, pi]
    bins = (ang + math.pi) / (2 * math.pi) * nb
    oh = _soft_onehot(bins.flatten(-2), nb, wrap=True)  # [B,K,S,nb]
    w = (mag * wgt_ori).flatten(-2)  # [B,K,S]
    hist = (w[..., None, :] @ oh)[..., 0, :]  # [B,K,nb]
    # Lowe smooths the orientation histogram 6x
    for _ in range(6):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1, keepdim=True)  # first maximum
    l_ = torch.gather(hist, -1, (peak - 1) % nb)[..., 0]
    c_ = torch.gather(hist, -1, peak)[..., 0]
    r_ = torch.gather(hist, -1, (peak + 1) % nb)[..., 0]
    denom = l_ - 2 * c_ + r_
    off = torch.where(denom.abs() > 1e-12, 0.5 * (l_ - r_) / denom, 0.0)
    theta = ((peak[..., 0] + off + 0.5) / nb) * 2 * math.pi - math.pi

    # descriptor on the patch grid rotated by theta
    oy, ox = _grid(P, dev)
    wgt = torch.exp(-(ox**2 + oy**2) / (2 * (P / 2.0) ** 2))
    ct = torch.cos(theta)[..., None, None]
    st = torch.sin(theta)[..., None, None]
    rx = ct * ox - st * oy
    ry = st * ox + ct * oy
    v = _nn_gather_lvl(gstack, lvls, y + ry * sp, x + rx * sp)
    gx, gy = _patch_gradients(v)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-18)
    # the patch is sampled on the rotated grid, so finite differences
    # along the patch axes are already descriptor-frame gradients
    ang = torch.atan2(gy, gx)
    w = (mag * wgt).flatten(-2)  # [B,K,S]
    # spatial soft bins: 4x4 grid over the (unrotated) patch coords
    bx = (ox + (P - 1) / 2.0) / (P / 4.0) - 0.5
    by = (oy + (P - 1) / 2.0) / (P / 4.0) - 0.5
    ohx = _soft_onehot(bx.reshape(-1), 4, wrap=False)  # [S,4]
    ohy = _soft_onehot(by.reshape(-1), 4, wrap=False)  # [S,4]
    spatial = (ohy[:, :, None] * ohx[:, None, :]).reshape(-1, 16)  # [S,16]
    ob = ((ang + math.pi) / (2 * math.pi) * 8.0).flatten(-2)
    oho = _soft_onehot(ob, 8, wrap=True)  # [B,K,S,8]
    desc = spatial.t() @ (w[..., None] * oho)  # [B,K,16,8]
    desc = desc.flatten(-2)  # [B,K,128], spatial-major
    desc = desc / torch.linalg.norm(desc, dim=-1, keepdim=True).clamp_min(
        1e-12)
    desc = desc.clamp_max(0.2)
    desc = desc / torch.linalg.norm(desc, dim=-1, keepdim=True).clamp_min(
        1e-12)
    return theta, desc


def l1_root_normalize(desc: torch.Tensor) -> torch.Tensor:
    """L1-root normalization (reference: L1RootNormalize,
    sift_extractor.cc:100-110)."""
    l1 = desc.abs().sum(dim=-1, keepdim=True)
    return torch.sqrt(desc / l1.clamp_min(1e-12))


def descs_to_uint8(desc: torch.Tensor) -> torch.Tensor:
    """512*v truncation (reference: FeatureDescriptorsToUnsignedByte,
    sift_extractor.h:22-34)."""
    return (512.0 * desc).clamp(0, 255).to(torch.uint8)


def _extract(img: torch.Tensor, opts: SiftOptions):
    """img [B, H, W] float32 in [0,1] or uint8, on the extraction device.

    Returns (xy [B,K,2], sigma [B,K], angle [B,K], desc_u8 [B,K,128],
    score [B,K], valid [B,K]) with K = min(max_features, pool slots)."""
    B = img.shape[0]
    L = opts.levels_per_octave

    if img.dtype == torch.uint8:
        img = img.to(torch.float32) * (1.0 / 255.0)
    base = img
    octave_scale = 1.0
    if opts.first_octave == -1:
        base = _upsample2(img)
        octave_scale = 0.5
    # bring base to sigma0
    s_extra = math.sqrt(
        max(opts.sigma0**2 - (opts.init_sigma / octave_scale) ** 2, 0.01)
    )
    base = _sep_blur(base, _gauss_kernel1d(s_extra))
    lvl_sigmas = torch.tensor(
        [opts.sigma0 * (2.0 ** ((li + 1) / L)) for li in range(L)],
        dtype=torch.float32, device=img.device,
    )

    all_out = []
    cur = base
    for o in range(opts.num_octaves):
        Hc, Wc = cur.shape[1], cur.shape[2]
        if min(Hc, Wc) < 32:
            break
        # L+3 gaussian levels
        levels = [cur]
        sig_prev = opts.sigma0
        for li in range(1, L + 3):
            sig_next = opts.sigma0 * (2.0 ** (li / L))
            dsig = math.sqrt(max(sig_next**2 - sig_prev**2, 1e-6))
            levels.append(_sep_blur(levels[-1], _gauss_kernel1d(dsig)))
            sig_prev = sig_next
        gauss = torch.stack(levels, dim=1)  # [B, L+3, H, W]
        dogs = gauss[:, 1:] - gauss[:, :-1]  # [B, L+2, H, W]
        k_pool = min(
            max(opts.features_per_octave >> o, opts.pool_floor),
            Hc * Wc // 16,
        )
        xy, sigma, score, lvl, valid = _extract_octave(
            dogs, octave_scale, opts, k_pool
        )
        # orientation + descriptor on each keypoint's own gaussian level
        # (lvl+1, the level below the DoG's upper image)
        xs_all = xy[..., 0] / octave_scale
        ys_all = xy[..., 1] / octave_scale
        ang, desc = _orientation_and_descriptor(
            gauss, lvl + 1, xs_all, ys_all, lvl_sigmas[lvl], opts
        )
        all_out.append((xy, sigma, ang, desc, score, valid))
        cur = _downsample2(gauss[:, L])  # image with 2*sigma0 blur
        octave_scale *= 2.0

    xy, sigma, ang, desc, score, valid = (
        torch.cat([a[i] for a in all_out], dim=1) for i in range(6)
    )

    # global top max_features by score
    sc = torch.where(valid, score, -1.0)
    take = min(opts.max_features, sc.shape[1])
    top_sc, top_i = _top_k_stable(sc, take)
    xy = torch.gather(xy, 1, top_i[..., None].expand(-1, -1, 2))
    sigma = torch.gather(sigma, 1, top_i)
    ang = torch.gather(ang, 1, top_i)
    desc = torch.gather(desc, 1, top_i[..., None].expand(-1, -1, 128))
    valid = top_sc > 0

    desc_u8 = descs_to_uint8(l1_root_normalize(desc))
    return xy, sigma, ang, desc_u8, top_sc, valid


def _run(buf: np.ndarray, opts: SiftOptions, dev):
    with torch.inference_mode(), full_precision():
        res = _extract(torch.from_numpy(buf).to(dev), opts)
        return [t.cpu().numpy() for t in res]


class SiftExtractor:
    """Host-facing extractor (reference: SiftExtractor,
    src/feature/sift_extractor.cc) running on an explicit device."""

    def __init__(self, opts: SiftOptions = SiftOptions(), device="cuda"):
        self.opts = opts
        self.device = resolve_device(device)

    def extract(self, image: np.ndarray):
        """image [H,W] uint8/float grayscale -> (keypoints [N,4]
        (x, y, size, angle), descriptors [N,128] uint8)."""
        img = np.asarray(image)
        if img.ndim == 3:
            img = img.mean(axis=2)
        img = img.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        h, w = img.shape
        # pad to multiples of 32, as the JAX package does
        H = (h + 31) // 32 * 32
        W = (w + 31) // 32 * 32
        buf = np.zeros((1, H, W), np.float32)
        buf[0, :h, :w] = img
        xy, sigma, ang, desc, _score, valid = _run(buf, self.opts,
                                                   self.device)
        v = valid[0]
        xy = xy[0][v]
        inb = (xy[:, 0] < w) & (xy[:, 1] < h)
        kps = np.zeros((int(inb.sum()), 4), np.float32)
        kps[:, :2] = xy[inb]
        kps[:, 2] = sigma[0][v][inb]
        kps[:, 3] = ang[0][v][inb]
        return kps, desc[0][v][inb]

    def extract_batch(self, images, batch: int = 8) -> List[tuple]:
        """Extract many images, `batch` images of one padded size per
        device call.  uint8 images go to the device as uint8.  Returns a
        list of (keypoints [N,4], descriptors [N,128]) in input order."""
        prepped = []
        for image in images:
            img = np.asarray(image)
            if img.ndim == 3:
                img = img.mean(axis=2)
            if img.dtype != np.uint8:
                img = img.astype(np.float32)
                if img.size and img.max() > 1.5:
                    img = img / 255.0
            prepped.append(img)
        groups = {}
        for i, img in enumerate(prepped):
            h, w = img.shape
            H = (h + 31) // 32 * 32
            W = (w + 31) // 32 * 32
            groups.setdefault((H, W, img.dtype == np.uint8), []).append(i)
        out = [None] * len(prepped)
        for (H, W, is_u8), idxs in groups.items():
            for s in range(0, len(idxs), batch):
                grp = idxs[s: s + batch]
                buf = np.zeros((len(grp), H, W),
                               np.uint8 if is_u8 else np.float32)
                for bi, i in enumerate(grp):
                    h, w = prepped[i].shape
                    buf[bi, :h, :w] = prepped[i]
                xy, sigma, ang, desc, _score, valid = _run(buf, self.opts,
                                                           self.device)
                for bi, i in enumerate(grp):
                    h, w = prepped[i].shape
                    v = valid[bi]
                    xyi = xy[bi][v]
                    inb = (xyi[:, 0] < w) & (xyi[:, 1] < h)
                    kps = np.zeros((int(inb.sum()), 4), np.float32)
                    kps[:, :2] = xyi[inb]
                    kps[:, 2] = sigma[bi][v][inb]
                    kps[:, 3] = ang[bi][v][inb]
                    out[i] = (kps, desc[bi][v][inb])
        return out
