"""Batched SIFT descriptor matching and ORB Hamming matching (port of
xrsfm_tpu/ops/matching.py).

All-pairs descriptor dot products per image pair, then row best / second
best and column best for the mutual check, accepted by the reference's
uint8 rule: angular distance < dist_th, best/second ratio < ratio_th,
mutual best (reference: src/feature/feature_processing.cc:118-154).

Descriptors are L1-root normalized and quantized to uint8 as 512*v, so
cos(angle) = <d1, d2> / 512^2.

The statistics pass is `topstats`: on a CUDA tensor it launches the
hand-written kernel in ``csrc/topstats.cu``; on a CPU tensor it runs the
plain PyTorch version `topstats_reference`, which has the same semantics
bit for bit.  There is no fallback between the two.

ORB descriptors (32 bytes) match by Hamming distance through a {0,1}
matmul (`match_descriptors_hamming`), which the JAX package runs as an
XLA product outside any Pallas kernel: plain PyTorch ops here too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import full_precision, resolve_device

_QUANT = 512.0
_BIG = 1e9  # > any raw uint8 descriptor dot product (<= 255^2 * 128)

# launches by route; the kernel wrapper and the plain version each count
# their own, so a run can show which one its matcher went through; the
# kernel's launches also by device ("cuda:0": n), for sharded matching
LAUNCHES = {"topstats_cuda": 0, "topstats_plain": 0}
LAUNCHES_BY_DEVICE = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_DEVICE.clear()


def topstats_reference(d1, d2, m1, m2):
    """Plain PyTorch matcher statistics.  d1 [B,N,D] uint8, d2 [B,M,D]
    uint8, masks [B,N] / [B,M] bool.  Returns (best [B,N] f32, second
    [B,N] f32, best_j [B,N] int32, col_arg [B,M] int32) with raw dots.

    The dot products are float32 products of integers < 2^8 with sums
    < 2^24, exact in any order (TF32 is off in `full_precision`).  The
    sentinel adds round like the TPU kernel's: invalid columns become
    sim - 1e9 in f32, and invalid rows are pushed down once more for the
    column statistics.  Ties go to the lowest index."""
    LAUNCHES["topstats_plain"] += 1
    B, N, _ = d1.shape
    M = d2.shape[1]
    with full_precision():
        sim = torch.bmm(d1.float(), d2.float().transpose(1, 2))  # [B,N,M]
    pen2 = (m2.float() - 1.0) * _BIG
    pen1 = (m1.float() - 1.0) * _BIG
    simr = sim + pen2[:, None, :]
    col_ids = torch.arange(M, device=d1.device, dtype=torch.int32)
    rmax = simr.amax(dim=2, keepdim=True)
    bestj = torch.where(simr >= rmax, col_ids, M).amin(dim=2, keepdim=True)
    sec = torch.where(col_ids == bestj, -_BIG, simr).amax(dim=2)
    simc = simr + pen1[:, :, None]
    cmax = simc.amax(dim=1, keepdim=True)
    row_ids = torch.arange(N, device=d1.device, dtype=torch.int32)[:, None]
    carg = torch.where(simc >= cmax, row_ids, 1 << 30).amin(dim=1)
    return rmax[..., 0], sec, bestj[..., 0], carg


_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p
]


def topstats_cuda(d1, d2, m1, m2):
    """The CUDA kernel ``csrc/topstats.cu`` (u8 wgmma dots fed by TMA): same
    contract as `topstats_reference`, for contiguous CUDA tensors with
    D = 128.  Builds the kernel on first use; raises on a bad input, a
    failed build or a refused launch."""
    if d1.dim() != 3 or d2.dim() != 3:
        raise ValueError("d1, d2 must be [B, N, 128] and [B, M, 128]")
    B, N, D = d1.shape
    M = d2.shape[1]
    if D != 128 or d2.shape[0] != B or d2.shape[2] != 128:
        raise ValueError(f"descriptor shapes {tuple(d1.shape)} and "
                         f"{tuple(d2.shape)}: need [B, N, 128], [B, M, 128]")
    if tuple(m1.shape) != (B, N) or tuple(m2.shape) != (B, M):
        raise ValueError(f"mask shapes {tuple(m1.shape)}, {tuple(m2.shape)}")
    if min(B, N, M) < 1 or max(B, N, M) >= 1 << 24:
        raise ValueError(f"unsupported sizes B={B} N={N} M={M}")
    for name, t, dt in (("d1", d1, torch.uint8), ("d2", d2, torch.uint8),
                        ("m1", m1, torch.bool), ("m2", m2, torch.bool)):
        if t.device.type != "cuda" or t.device != d1.device:
            raise ValueError(f"{name} must lie on {d1.device}, a CUDA device")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("descriptor tensors must be 16-byte aligned")

    from ..kernels import build

    fn = build.load("topstats.cu").topstats_launch
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    dev = d1.device
    best = torch.empty((B, N), dtype=torch.float32, device=dev)
    sec = torch.empty((B, N), dtype=torch.float32, device=dev)
    bestj = torch.empty((B, N), dtype=torch.int32, device=dev)
    carg = torch.empty((B, M), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(d1.data_ptr(), d2.data_ptr(), m1.data_ptr(), m2.data_ptr(),
                 best.data_ptr(), sec.data_ptr(), bestj.data_ptr(),
                 carg.data_ptr(), B, N, M, stream)
    if err != 0:
        # csrc/topstats.cu: a cudaError_t, or 100000 + the CUresult of a
        # refused cuTensorMapEncodeTiled
        raise RuntimeError(f"topstats kernel launch failed: error {err}")
    LAUNCHES["topstats_cuda"] += 1
    LAUNCHES_BY_DEVICE[str(dev)] = LAUNCHES_BY_DEVICE.get(str(dev), 0) + 1
    return best, sec, bestj, carg


def topstats(d1, d2, m1, m2):
    """Fused matcher statistics: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (port of _topstats_pallas)."""
    if d1.device.type == "cuda":
        return topstats_cuda(d1, d2, m1, m2)
    if d1.device.type == "cpu":
        return topstats_reference(d1, d2, m1, m2)
    raise ValueError(f"unsupported device {d1.device}")


def _pallas_ok(n: int, m: int, d: int) -> bool:
    """The shapes the JAX package sends to its fused kernel; the port
    routes the same shapes to `topstats`, so both packages take the same
    path for every input."""
    return d == 128 and m <= 8192 and n % 128 == 0 and m % 128 == 0


def _first_argmax(x, dim: int):
    """Index of the first maximum along `dim` (jnp.argmax's tie rule)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ids = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(x >= x.amax(dim=dim, keepdim=True), ids, n).amin(dim)


def _accept_compact(cos_best, cos_second, best_j, col_arg, mask1,
                    dist_th, ratio_th, max_matches: int):
    """Accept rule (distance + ratio + mutual, reference
    feature_processing.cc:118-154) and compaction to the first max_matches
    accepted rows, over a leading pair dimension: inputs [B, N] / col_arg
    [B, M].  Returns (matches [B, mm, 2] int32 padded with -1,
    counts [B], distances [B, mm])."""
    B, N = cos_best.shape
    neg = -2.0
    dist_best = torch.arccos(cos_best.clamp(-1.0, 1.0))
    dist_second = torch.arccos(cos_second.clamp(-1.0, 1.0))
    ar = torch.arange(N, device=cos_best.device)
    mutual = torch.gather(col_arg.long(), 1, best_j.long()) == ar
    ok = (
        mask1
        & (cos_best > neg + 1)
        & (dist_best < dist_th)
        & (dist_best < ratio_th * dist_second)
        & mutual
    )
    # accepted rows first, in row order (stable sort of the reject flag)
    order = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)
    rows = order[:, :max_matches]
    valid = torch.gather(ok, 1, rows)
    neg1 = torch.full_like(rows, -1)
    matches = torch.stack(
        [
            torch.where(valid, rows, neg1),
            torch.where(valid, torch.gather(best_j.long(), 1, rows), neg1),
        ],
        dim=-1,
    ).to(torch.int32)
    dist = torch.where(valid, torch.gather(dist_best, 1, rows), 0.0)
    return matches, ok.sum(dim=1), dist


def _match_batch_fused(d1, d2, mask1, mask2, dist_th, ratio_th,
                       max_matches: int):
    best, sec, bestj, colarg = topstats(d1, d2, mask1, mask2)
    q2 = _QUANT * _QUANT
    cb = torch.where(mask1, best / q2, -2.0)
    cs = (sec / q2).clamp(-2.0, 1.0)
    return _accept_compact(cb, cs, bestj, colarg, mask1, dist_th, ratio_th,
                           max_matches)


def _match_batch_plain(d1, d2, mask1, mask2, dist_th=0.7, ratio_th=0.8,
                       max_matches: int = 4096):
    """Port of the JAX package's non-fused matcher (_match_descriptors_xla,
    vmapped), for shapes `_pallas_ok` rejects.  It keeps that path's
    semantics: the similarity matrix is rounded to bf16 before the row and
    column argmax, so near-ties can resolve differently from the fused
    path.  Inputs carry a leading pair dimension."""
    B, N, _ = d1.shape
    with full_precision():
        sim32 = torch.bmm(d1.float(), d2.float().transpose(1, 2)) / (
            _QUANT * _QUANT
        )
    neg = -2.0
    valid2d = mask1[:, :, None] & mask2[:, None, :]
    sim = torch.where(valid2d, sim32, neg).to(torch.bfloat16)
    best_j = _first_argmax(sim, 2)  # [B, N]
    cos_best = torch.gather(sim32, 2, best_j[..., None])[..., 0]
    cos_best = torch.where(mask1, cos_best, neg)
    masked = sim.scatter(2, best_j[..., None],
                         torch.full_like(sim[..., :1], neg))
    cos_second = masked.amax(dim=2).float()
    col_best_i = _first_argmax(sim, 1)  # [B, M]
    return _accept_compact(cos_best, cos_second, best_j, col_best_i, mask1,
                           dist_th, ratio_th, max_matches)


def match_descriptors_batch(d1, d2, mask1, mask2, dist_th=0.7, ratio_th=0.8,
                            max_matches: int = 4096):
    """Batched pair matching: d1, d2 [B, K, 128] uint8; masks [B, K] bool,
    all on one device.  Routes to `topstats` whenever `_pallas_ok`, else to
    the plain bf16 path.  Returns (matches [B, mm, 2] int32 padded with -1,
    counts [B], distances [B, mm])."""
    B, N, D = d1.shape
    M = d2.shape[1]
    if _pallas_ok(N, M, D):
        return _match_batch_fused(d1, d2, mask1, mask2, dist_th, ratio_th,
                                  max_matches)
    return _match_batch_plain(d1, d2, mask1, mask2, dist_th, ratio_th,
                              max_matches)


def match_descriptors(d1, d2, mask1, mask2, dist_th: float = 0.7,
                      ratio_th: float = 0.8, max_matches: int = 4096):
    """Match two uint8 descriptor sets: d1 [N,128], d2 [M,128], mask1 [N],
    mask2 [M].  Returns (matches [max_matches, 2] int32 padded with -1,
    num_matches, distances [max_matches])."""
    m, c, dd = match_descriptors_batch(
        d1[None], d2[None], mask1[None], mask2[None], dist_th, ratio_th,
        max_matches,
    )
    return m[0], c[0], dd[0]


def match_pair_host(feats1, feats2, dist_th=0.7, ratio_th=0.8,
                    device="cuda"):
    """Host wrapper on [N,128] uint8 descriptor arrays: pads both to one
    power-of-two size (>= 64), matches on `device`, returns (matches [n, 2]
    int32, distances [n]) as numpy."""
    dev = resolve_device(device)
    n, m_ = len(feats1), len(feats2)
    k = 1
    while k < max(n, m_, 64):
        k *= 2
    d1 = np.zeros((k, 128), np.uint8)
    d2 = np.zeros((k, 128), np.uint8)
    d1[:n] = feats1
    d2[:m_] = feats2
    m1 = np.zeros(k, bool)
    m1[:n] = True
    m2 = np.zeros(k, bool)
    m2[:m_] = True
    matches, cnt, dists = match_descriptors(
        torch.from_numpy(d1).to(dev), torch.from_numpy(d2).to(dev),
        torch.from_numpy(m1).to(dev), torch.from_numpy(m2).to(dev),
        dist_th, ratio_th, min(k, 4096),
    )
    cnt = int(cnt)
    out = matches.cpu().numpy()
    out = out[out[:, 0] >= 0][:cnt]
    return out.astype(np.int32), dists.cpu().numpy()[: len(out)]


def match_descriptors_hamming(d1, d2, mask1, mask2, dist_th: int = 80,
                              ratio_th: float = 0.9,
                              max_matches: int = 4096):
    """Match two 256-bit ORB descriptor sets by Hamming distance (port of
    xrsfm_tpu/ops/matching.match_descriptors_hamming; reference OrbMatch,
    src/feature/feature_processing.cc:156-219: accept when best <= 80,
    best <= 0.9 * second best, and mutual best).

    The descriptors are unpacked to 256 {0,1} bits and hamming(a, b) =
    |a| + |b| - 2 a.b, so the distance matrix is one float32 matmul in
    full precision (exact: every value is a small integer).  Ties go to
    the lower index (argmin) on rows and columns.

    d1 [N,32] uint8, d2 [M,32] uint8, mask1 [N], mask2 [M] validity.
    Returns (matches [max_matches, 2] int32 padded with -1, num_matches,
    distances [max_matches] in bits)."""
    dev = d1.device
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    b1 = ((d1[:, :, None] >> shifts) & 1).reshape(d1.shape[0], 256)
    b2 = ((d2[:, :, None] >> shifts) & 1).reshape(d2.shape[0], 256)
    b1 = b1.to(torch.float32)
    b2 = b2.to(torch.float32)
    with full_precision():
        dot = b1 @ b2.T  # [N,M]
    dist = b1.sum(1)[:, None] + b2.sum(1)[None, :] - 2.0 * dot
    big = 1024.0  # > any 256-bit Hamming distance
    dist = torch.where(mask1[:, None] & mask2[None, :], dist, big)

    rows_all = torch.arange(dist.shape[0], device=dev)
    best_j = torch.argmin(dist, dim=1)  # [N], first of equal minima
    d_best = dist[rows_all, best_j]
    masked = dist.clone()
    masked[rows_all, best_j] = big
    d_second = masked.min(dim=1).values
    col_best_i = torch.argmin(dist, dim=0)  # [M]
    mutual = col_best_i[best_j] == rows_all

    ok = (mask1 & (d_best < big) & (d_best <= dist_th)
          & (d_best <= ratio_th * d_second) & mutual)
    # accepted rows first, in index order (a stable sort of ~ok)
    order = torch.sort((~ok).to(torch.uint8), stable=True).indices
    rows = order[:max_matches]
    valid = ok[rows]
    matches = torch.stack([
        torch.where(valid, rows, -1),
        torch.where(valid, best_j[rows], -1),
    ], dim=-1).to(torch.int32)
    return matches, ok.sum(), torch.where(valid, d_best[rows], 0.0)


def match_pair_host_hamming(descs1, descs2, dist_th=80, ratio_th=0.9,
                            device="cuda"):
    """Host wrapper for ORB matching on [N,32] uint8 descriptor arrays:
    pads both to one power-of-two size k (>= 64), matches on `device` with
    at most min(k, 4096) matches, returns (matches [n, 2] int32,
    distances [n]) as numpy."""
    dev = resolve_device(device)
    n, m_ = len(descs1), len(descs2)
    k = 1
    while k < max(n, m_, 64):
        k *= 2
    d1 = np.zeros((k, 32), np.uint8)
    d2 = np.zeros((k, 32), np.uint8)
    d1[:n] = descs1
    d2[:m_] = descs2
    m1 = np.zeros(k, bool)
    m1[:n] = True
    m2 = np.zeros(k, bool)
    m2[:m_] = True
    matches, cnt, dists = match_descriptors_hamming(
        torch.from_numpy(d1).to(dev), torch.from_numpy(d2).to(dev),
        torch.from_numpy(m1).to(dev), torch.from_numpy(m2).to(dev),
        dist_th, ratio_th, min(k, 4096),
    )
    cnt = int(cnt)
    out = matches.cpu().numpy()
    out = out[out[:, 0] >= 0][:cnt]
    return out.astype(np.int32), dists.cpu().numpy()[: len(out)]
