"""Matching stage: pair selection + descriptor matching + F verification
(port of xrsfm_tpu/feature/matching.py).

(reference: src/feature/feature_processing.cc:222-308 FeatureMatching,
src/run_matching.cc pair strategies — sequential :125-151, retrieval
:66-90; geometric verification via LORANSAC<F7pt, F8pt> at 4px,
src/geometry/epipolar_geometry.hpp:10-27)

Descriptors of all frames stay on the device in one padded pool.  Pairs
are matched in 16-pair groups (one `topstats` launch each) and verified in
16-pair groups sorted by match-count bucket.  Over a device mesh a chunk
holds one group per shard, each matched and verified on its shard's
device (a pool on every device); on one device a chunk is one group.
Each chunk is dispatched before the previous chunk's results are read:
its outputs are copied to the host asynchronously behind a CUDA event, so
the host's bookkeeping of chunk k overlaps the device's work on chunk
k+1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import full_precision, resolve_device
from ..ops import epipolar, matching as dmatch, ransac
from ..utils.io_features import FrameFeatures, FramePairData, bucket


@dataclasses.dataclass
class MatchingOptions:
    # reference: uint8 matcher thresholds (feature_processing.cc:121-123)
    dist_th: float = 0.7
    ratio_th: float = 0.8
    # reference: SolveFundamnetalCOLMAP 4px, keep if inliers >=
    # max(15, 0.25 * num_matches) (feature_processing.cc:284-289)
    f_ransac_px: float = 4.0
    min_inliers: int = 15
    min_inlier_ratio: float = 0.25
    num_hypotheses: int = 256
    # sequential strategy (run_matching.cc:125-151)
    seq_window: int = 20
    seq_loop_stride: int = 5
    # retrieval strategy (run_matching.cc:66-90)
    retrieval_topk: int = 25


def _match_chunk_resident(descs, masks, idx, dist_th, ratio_th, mm: int):
    """Match the pairs idx [B, 2] of the resident pool descs [F, K, 128],
    masks [F, K]."""
    i1, i2 = idx[:, 0], idx[:, 1]
    return dmatch.match_descriptors_batch(
        descs[i1], descs[i2], masks[i1], masks[i2], dist_th, ratio_th, mm
    )


def pair_seed(i: int, j: int) -> int:
    """Per-pair RANSAC seed (the JAX package's PRNGKey argument)."""
    return (i * 32768 + j) & 0x7FFFFFFF


def _fundamental_ransac_batch(x1, x2, mask, threshold, generators=None,
                              sample_idx=None):
    """LO-RANSAC fundamental over B pairs: 7pt hypotheses + 8pt refit on
    inliers.  x1, x2 [B, N, 2]; mask [B, N]; one generator per pair or
    sample_idx [B, 256, 7].  Returns (F [B,3,3], inliers [B,N],
    num_inliers [B], success [B])."""

    def estimate(sampled, sample_valid):
        a, b = sampled
        return epipolar.fundamental_7pt(a, b, sample_valid)

    def residual(F, data):
        a, b = data
        return epipolar.sampson_error(F, a[:, None], b[:, None])

    def refit(data, inl):
        a, b = data
        return epipolar.fundamental_8pt(a, b, inl)

    with full_precision():
        res = ransac.ransac(
            data=(x1, x2),
            mask=mask,
            estimate_fn=estimate,
            residual_fn=residual,
            sample_size=7,
            threshold=threshold,
            num_hypotheses=256,
            refit_fn=refit,
            lo_iters=2,
            generators=generators,
            sample_idx=sample_idx,
        )
    return res.model, res.inliers, res.num_inliers, res.success


def sequential_pairs(num_frames: int, opts: MatchingOptions) -> List[Tuple[int, int]]:
    """Adjacent window (reference: MatchingSeq, run_matching.cc:125-151)."""
    pairs = []
    for i in range(num_frames):
        for k in range(1, opts.seq_window):
            j = i + k
            if j < num_frames:
                pairs.append((i, j))
    return sorted(set(pairs))


def retrieval_pairs(
    id2rank: Dict[int, List[int]], topk: int
) -> List[Tuple[int, int]]:
    """Top-k retrieval neighbors per image, deduplicated
    (reference: ExtractNearestImagePairs, run_matching.cc:66-90)."""
    seen = set()
    out = []
    for i, ranked in id2rank.items():
        for j in ranked[:topk]:
            a, b = (i, j) if i < j else (j, i)
            if a != b and (a, b) not in seen:
                seen.add((a, b))
                out.append((a, b))
    return sorted(out)


def _to_host(tensors):
    """Start copying device tensors to the host; returns (host tensors,
    event to wait on, or None when they already lie on the host)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return tensors, None
    host = tuple(t.to("cpu", non_blocking=True) for t in tensors)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return host, ev


def _wait_host(futs):
    """numpy arrays of the groups' outputs, concatenated in group order."""
    parts = []
    for host, ev in futs:
        if ev is not None:
            ev.synchronize()
        parts.append([t.numpy() for t in host])
    return [np.concatenate(a) for a in zip(*parts)]


GROUP = 16  # pairs a launch


def match_and_verify_pairs(
    features: Sequence[FrameFeatures],
    pair_ids: Sequence[Tuple[int, int]],
    opts: MatchingOptions = MatchingOptions(),
    verbose: bool = True,
    device="cuda",
    mesh=None,
) -> List[FramePairData]:
    """Full matching stage over candidate pairs on `device`.  Returns the
    verified pairs with inlier masks (pairs failing the inlier rule are
    dropped).

    mesh (parallel.mesh.Mesh, optional; its devices replace `device`):
    chunks of 16 pairs a shard, matching and verification both split over
    the shards.  The 16-pair groups and each pair's RANSAC generator are
    those of one device, so on one device type the result is the
    single-device run's bit for bit."""
    devs = list(mesh.devices) if mesh is not None else [resolve_device(device)]
    out: List[FramePairData] = []

    # device-resident descriptor pool, padded per frame to a shared bucket
    kmax = max((len(f.keypoints) for f in features), default=0)
    K = bucket(kmax, lo=256)
    n_f = len(features)
    descs = np.zeros((n_f, K, 128), np.uint8)
    masks = np.zeros((n_f, K), bool)
    kps = np.zeros((n_f, K, 2), np.float32)
    for i, f in enumerate(features):
        n = len(f.keypoints)
        descs[i, :n] = f.descriptors
        masks[i, :n] = True
        kps[i, :n] = f.keypoints[:, :2]
    pools = {}
    for d in devs:
        if d not in pools:
            pools[d] = (torch.from_numpy(descs).to(d),
                        torch.from_numpy(masks).to(d))

    # pass 1: descriptor matching, pairs batched into fixed-size chunks
    cand = []  # (i, j, matches [M,2], dists [M])
    mm = min(K, 4096)
    B = GROUP * len(devs)

    def _dispatch_match(s):
        grp = list(pair_ids[s: s + B])
        pad = B - len(grp)
        idx = np.asarray(grp + [grp[-1]] * pad, np.int64)  # keep groups full
        futs = []
        for k, d in enumerate(devs[:-(-len(grp) // GROUP)]):
            descs_d, masks_d = pools[d]
            futs.append(_to_host(_match_chunk_resident(
                descs_d, masks_d,
                torch.from_numpy(idx[k * GROUP:(k + 1) * GROUP]).to(d),
                opts.dist_th, opts.ratio_th, mm)))
        return grp, futs

    def _harvest_match(grp, futs):
        m_np, c_np, d_np = _wait_host(futs)
        for k, (i, j) in enumerate(grp):
            n_m = int(c_np[k])
            if n_m < max(8, opts.min_inliers):
                continue
            mnp = m_np[k]
            mnp = mnp[mnp[:, 0] >= 0][:n_m]
            cand.append((i, j, mnp, d_np[k][: len(mnp)]))

    pending = None
    for ci, s in enumerate(range(0, len(pair_ids), B)):
        nxt = _dispatch_match(s)
        if pending is not None:
            _harvest_match(*pending)
        pending = nxt
        if verbose and (ci % 16 == 0):
            print(
                f"[matching] matched {min(s + B, len(pair_ids))}"
                f"/{len(pair_ids)}",
                flush=True,
            )
    if pending is not None:
        _harvest_match(*pending)

    # pass 2: geometric verification in bucket-grouped chunks
    by_bucket = {}
    for k, (i, j, mnp, d) in enumerate(cand):
        by_bucket.setdefault(bucket(len(mnp)), []).append(k)
    th = float(np.float32(opts.f_ransac_px**2))
    CHUNK = GROUP * len(devs)

    def _dispatch_verify(b, grp):
        x1 = np.zeros((CHUNK, b, 2), np.float32)
        x2 = np.zeros((CHUNK, b, 2), np.float32)
        vm = np.zeros((CHUNK, b), bool)
        seeds = [0] * CHUNK
        for g, k in enumerate(grp):
            i, j, mnp, _ = cand[k]
            n_m = len(mnp)
            x1[g, :n_m] = kps[i][mnp[:, 0]]
            x2[g, :n_m] = kps[j][mnp[:, 1]]
            vm[g, :n_m] = True
            seeds[g] = pair_seed(i, j)
        futs = []
        for k, d in enumerate(devs[:-(-len(grp) // GROUP)]):
            sl = slice(k * GROUP, (k + 1) * GROUP)
            gens = [torch.Generator(device=d).manual_seed(s)
                    for s in seeds[sl]]
            futs.append(_to_host(_fundamental_ransac_batch(
                torch.from_numpy(x1[sl]).to(d), torch.from_numpy(x2[sl]).to(d),
                torch.from_numpy(vm[sl]).to(d), th, generators=gens)))
        return grp, futs

    def _harvest_verify(grp, futs):
        F_b, inl_b, n_inl_b, ok_b = _wait_host(futs)
        for g, k in enumerate(grp):
            i, j, mnp, d = cand[k]
            n_m = len(mnp)
            n_inl = int(n_inl_b[g])
            if not bool(ok_b[g]) or n_inl < max(
                opts.min_inliers, int(opts.min_inlier_ratio * n_m)
            ):
                continue
            out.append(
                FramePairData(
                    id1=i,
                    id2=j,
                    matches=mnp,
                    distances=d.astype(np.float64),
                    E=np.asarray(F_b[g], np.float64),
                    inlier_num=n_inl,
                    inlier_mask=inl_b[g][:n_m],
                )
            )

    pending = None
    for b, idxs in sorted(by_bucket.items()):
        for s in range(0, len(idxs), CHUNK):
            nxt = _dispatch_verify(b, idxs[s: s + CHUNK])
            if pending is not None:
                _harvest_verify(*pending)
            pending = nxt
    if pending is not None:
        _harvest_verify(*pending)
    if verbose:
        print(
            f"[matching] verified {len(out)}/{len(cand)} candidate pairs",
            flush=True,
        )
    return out
