"""Matching stage pipeline (port of xrsfm_tpu/pipelines/run_matching.py;
reference: src/run_matching.cc:153-258).

Usage: python -m xrsfm_tpu_torch.cli run_matching <images_dir>
       <retrieval_path> <matching_type> <output_dir> [--device cuda]

matching_type: sequential | retrieval | covisibility.  Writes ftr.bin /
size.bin / fp.bin (and fp_init.bin, the covisibility seeds) in the
reference's formats and reuses a cached ftr.bin / size.bin / fp_init.bin
when it covers every image (run_matching.cc:25-31,57-59).  Without a
retrieval.txt, retrieval and covisibility matching rank the images by
VLAD themselves (feature/retrieval) and cache the ranks as retrieval.txt.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..feature import matching as fmatch
from ..feature import retrieval as RET
from ..feature.expansion import covisibility_matching
from ..ops.sift import SiftExtractor, SiftOptions
from ..utils import image_io
from ..utils import io_features as IOF


# moderate default against the reference's 8192-feature upsampled config
# (sift_extractor.h:36-107); callers can pass the full config explicitly
DEFAULT_SIFT = SiftOptions(
    num_octaves=4, features_per_octave=1024, max_features=4096, first_octave=0
)


def _read_gray(path: str) -> Optional[np.ndarray]:
    """Grayscale image, or None when the file is not a readable PNG/PGM
    (as cv2.imread returns None)."""
    try:
        return image_io.read_gray(path)
    except (OSError, ValueError):
        return None


def get_features(
    images_dir: str, ftr_path: str, image_names: List[str], verbose=True,
    sift_opts: SiftOptions = DEFAULT_SIFT, feature_type: str = "sift",
    device="cuda",
) -> List[IOF.FrameFeatures]:
    """Extract (or load cached) SIFT features (reference: GetFeatures
    run_matching.cc:15-33).  Images are extracted in 16-image batches."""
    if os.path.exists(ftr_path):
        feats = IOF.read_features(ftr_path)
        if len(feats) == len(image_names):
            return feats
    if feature_type != "sift":
        raise NotImplementedError(
            f"feature_type {feature_type!r}: the ORB extractor and Hamming "
            "matcher are not ported yet (ROADMAP.md queue 1, item 10)"
        )
    t0 = time.time()
    feats = []
    ex = SiftExtractor(sift_opts, device=device)
    CHUNK = 16
    for s in range(0, len(image_names), CHUNK):
        grp = image_names[s: s + CHUNK]
        imgs, ok = [], []
        for name in grp:
            img = _read_gray(os.path.join(images_dir, name))
            ok.append(img is not None)
            imgs.append(img if img is not None else np.zeros((32, 32), np.uint8))
        results = ex.extract_batch(imgs, batch=CHUNK)
        for name, good, (kps, descs) in zip(grp, ok, results):
            if not good:
                feats.append(IOF.FrameFeatures(
                    name, np.zeros((0, 4), np.float32),
                    np.zeros((0, 128), np.uint8),
                ))
            else:
                feats.append(IOF.FrameFeatures(name, kps, descs))
        if verbose:
            print(f"[extract] {min(s + CHUNK, len(image_names))}"
                  f"/{len(image_names)}", flush=True)
    if verbose:
        print(f"[extract] total {time.time() - t0:.1f}s", flush=True)
    IOF.write_features(ftr_path, feats)
    return feats


def get_image_sizes(images_dir, size_path, image_names):
    if os.path.exists(size_path):
        sizes = IOF.read_image_size(size_path)
        if len(sizes) == len(image_names):
            return sizes
    sizes = np.zeros((len(image_names), 2), np.int32)
    for i, name in enumerate(image_names):
        img = _read_gray(os.path.join(images_dir, name))
        if img is not None:
            sizes[i] = [img.shape[1], img.shape[0]]
    IOF.write_image_size(size_path, sizes)
    return sizes


def main(
    images_dir: str,
    retrieval_path: str,
    matching_type: str,
    output_dir: str,
    opts: Optional[fmatch.MatchingOptions] = None,
    stats: Optional[dict] = None,
    device="cuda",
):
    """Run the matching stage on `device` ("cuda" raises without a GPU).

    stats (optional dict) receives pairs_proposed (the number of candidate
    pairs matched and verified), extract_s and match_verify_s (host-clock
    seconds of the two phases, each ending in a device-to-host copy),
    retrieval_s when it ranked the images itself, and for covisibility
    matching the split of match_verify_s into search_s (the expansion's
    host search) and match_s (matching and verification)."""
    opts = opts or fmatch.MatchingOptions()
    resolve_device(device)
    if matching_type not in ("sequential", "retrieval", "covisibility"):
        raise ValueError(f"unknown matching type {matching_type}")
    os.makedirs(output_dir, exist_ok=True)
    image_names = IOF.load_image_names(images_dir)
    name_to_id = {n: i for i, n in enumerate(image_names)}

    t_ex = time.time()
    feats = get_features(images_dir, os.path.join(output_dir, "ftr.bin"),
                         image_names, device=device)
    get_image_sizes(images_dir, os.path.join(output_dir, "size.bin"),
                    image_names)
    if stats is not None:
        stats["extract_s"] = time.time() - t_ex

    id2rank = {}
    if retrieval_path and os.path.exists(retrieval_path):
        id2rank = IOF.load_retrieval_rank(retrieval_path, name_to_id)
    elif matching_type in ("retrieval", "covisibility"):
        # the reference needs an external retrieval.txt here
        # (run_matching.cc:193-207); the ranks come from VLAD over the
        # extracted descriptors instead, cached in the reference's format
        cache = os.path.join(output_dir, "retrieval.txt")
        if os.path.exists(cache):
            id2rank = IOF.load_retrieval_rank(cache, name_to_id)
        else:
            t_r = time.time()
            ranks, _ = RET.build_retrieval(
                [f.descriptors for f in feats], topk=opts.retrieval_topk,
                device=device)
            RET.write_retrieval_text(cache, image_names, ranks)
            id2rank = RET.ranks_to_id2rank(ranks)
            if stats is not None:
                stats["retrieval_s"] = time.time() - t_r
            print(f"[retrieval] built in {time.time() - t_r:.1f}s -> {cache}",
                  flush=True)

    t0 = time.time()
    if matching_type == "sequential":
        pairs = fmatch.sequential_pairs(len(image_names), opts)
        # loop-closure probes every Nth frame against retrieval neighbors
        # (reference: MatchingSeq, run_matching.cc:125-151)
        for i in range(0, len(image_names), opts.seq_loop_stride):
            for j in id2rank.get(i, [])[: opts.retrieval_topk]:
                if abs(i - j) >= opts.seq_window:
                    pairs.append((min(i, j), max(i, j)))
        pairs = sorted(set(pairs))
    elif matching_type == "retrieval":
        pairs = fmatch.retrieval_pairs(id2rank, opts.retrieval_topk)
    if matching_type == "covisibility":
        verified = covisibility_matching(
            feats, id2rank, opts,
            init_pairs_path=os.path.join(output_dir, "fp_init.bin"),
            stats=stats, device=device)
    else:
        if stats is not None:
            stats["pairs_proposed"] = len(pairs)
        verified = fmatch.match_and_verify_pairs(feats, pairs, opts,
                                                 device=device)
    if stats is not None:
        stats["match_verify_s"] = time.time() - t0

    IOF.write_frame_pairs(os.path.join(output_dir, "fp.bin"), verified)
    print(
        f"[matching] {matching_type}: {len(verified)} verified pairs "
        f"in {time.time() - t0:.1f}s -> {output_dir}/fp.bin",
        flush=True,
    )
    return verified
