"""Matching stage pipeline (port of xrsfm_tpu/pipelines/run_matching.py;
reference: src/run_matching.cc:153-258).

Usage: python -m xrsfm_tpu_torch.cli run_matching <images_dir>
       <retrieval_path> <matching_type> <output_dir> [--n_devices N]
       [--device cuda]

matching_type: sequential | retrieval | covisibility.  Writes ftr.bin /
size.bin / fp.bin (and fp_init.bin, the covisibility seeds) in the
reference's formats and reuses a cached ftr.bin / size.bin / fp_init.bin
when it covers every image (run_matching.cc:25-31,57-59).  Without a
retrieval.txt, retrieval and covisibility matching rank the images by
VLAD themselves (feature/retrieval) and cache the ranks as retrieval.txt.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..feature import matching as fmatch
from ..feature import retrieval as RET
from ..feature.expansion import covisibility_matching
from ..ops.orb import OrbExtractor
from ..ops.sift import SiftExtractor, SiftOptions
from ..parallel.mesh import make_mesh
from ..utils import image_io
from ..utils import io_features as IOF
from ..utils.profiling import span


# moderate default against the reference's 8192-feature upsampled config
# (sift_extractor.h:36-107); callers can pass the full config explicitly
DEFAULT_SIFT = SiftOptions(
    num_octaves=4, features_per_octave=1024, max_features=4096, first_octave=0
)


def get_features(
    images_dir: str, ftr_path: str, image_names: List[str], verbose=True,
    sift_opts: SiftOptions = DEFAULT_SIFT, feature_type: str = "sift",
    device="cuda",
) -> List[IOF.FrameFeatures]:
    """Extract (or load cached) features on `device`.  feature_type
    "sift" (default; 16-image batches) or "orb" (reference: GetFeatures
    run_matching.cc:15-33; the USE_ORB compile-time path of
    feature_extraction.cc:21-56 is a runtime option here).  ORB's 32
    descriptor bytes are stored padded to ftr.bin's 128-byte rows; the
    Hamming matcher (ops/matching.match_pair_host_hamming) takes
    [:, :32].  A span xrsfm.extract."""
    with span("xrsfm.extract") as sp:
        feats, fresh = _load_or_extract(images_dir, ftr_path, image_names,
                                        verbose, sift_opts, feature_type,
                                        device)
    if fresh and verbose:
        print(f"[extract] total {sp.seconds:.1f}s", flush=True)
    return feats


def _load_or_extract(images_dir, ftr_path, image_names, verbose, sift_opts,
                     feature_type, device):
    """get_features' work: (features, whether they were extracted)."""
    if os.path.exists(ftr_path):
        feats = IOF.read_features(ftr_path)
        if len(feats) == len(image_names):
            return feats, False
    if feature_type == "orb":
        feats = _orb_features(images_dir, image_names, verbose, device)
    else:
        feats = _sift_features(images_dir, image_names, verbose, sift_opts,
                               device)
    IOF.write_features(ftr_path, feats)
    return feats, True


def _no_features(name: str) -> IOF.FrameFeatures:
    """The entry of an image that cannot be read."""
    return IOF.FrameFeatures(name, np.zeros((0, 4), np.float32),
                             np.zeros((0, 128), np.uint8))


def _orb_features(images_dir, image_names, verbose, device):
    ex = OrbExtractor(device=device)
    feats = []
    for i, name in enumerate(image_names):
        img = image_io.read_gray_or_none(os.path.join(images_dir, name))
        if img is None:
            feats.append(_no_features(name))
            continue
        kps, descs = ex.extract(img)
        feats.append(IOF.FrameFeatures(name, kps,
                                       np.pad(descs, ((0, 0), (0, 96)))))
        if verbose:
            print(f"[extract] {i + 1}/{len(image_names)} {name}: "
                  f"{len(kps)} features", flush=True)
    return feats


def _sift_features(images_dir, image_names, verbose, sift_opts, device):
    feats = []
    ex = SiftExtractor(sift_opts, device=device)
    CHUNK = 16
    for s in range(0, len(image_names), CHUNK):
        grp = image_names[s: s + CHUNK]
        imgs, ok = [], []
        for name in grp:
            img = image_io.read_gray_or_none(os.path.join(images_dir, name))
            ok.append(img is not None)
            imgs.append(img if img is not None else np.zeros((32, 32), np.uint8))
        results = ex.extract_batch(imgs, batch=CHUNK)
        for name, good, (kps, descs) in zip(grp, ok, results):
            feats.append(IOF.FrameFeatures(name, kps, descs) if good
                         else _no_features(name))
        if verbose:
            print(f"[extract] {min(s + CHUNK, len(image_names))}"
                  f"/{len(image_names)}", flush=True)
    return feats


def get_image_sizes(images_dir, size_path, image_names):
    if os.path.exists(size_path):
        sizes = IOF.read_image_size(size_path)
        if len(sizes) == len(image_names):
            return sizes
    sizes = np.zeros((len(image_names), 2), np.int32)
    for i, name in enumerate(image_names):
        img = image_io.read_gray_or_none(os.path.join(images_dir, name))
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
    n_devices: int = 1,
    stats: Optional[dict] = None,
    device="cuda",
):
    """Run the matching stage on `device` ("cuda" raises without a GPU).
    n_devices > 1 shards descriptor matching and verification over a
    "pairs" mesh of that many devices (parallel/mesh.make_mesh: the first
    n GPUs, which must exist; n virtual shards on the CPU); extraction and
    retrieval stay on `device`.

    stats (optional dict) receives pairs_proposed (the number of candidate
    pairs matched and verified), extract_s and match_verify_s (host
    seconds of the spans xrsfm.extract, features extracted or loaded and
    the image sizes, and xrsfm.match, pair selection to fp.bin written;
    each ends in a device-to-host copy), retrieval_s (the span
    xrsfm.retrieval) when it ranked the images itself, and for
    covisibility matching the split of the matching into search_s (the
    expansion's host search) and match_s (matching and verification)."""
    opts = opts or fmatch.MatchingOptions()
    resolve_device(device)
    mesh = make_mesh(n_devices, device, axis="pairs") if n_devices > 1 \
        else None
    if matching_type not in ("sequential", "retrieval", "covisibility"):
        raise ValueError(f"unknown matching type {matching_type}")
    os.makedirs(output_dir, exist_ok=True)
    image_names = IOF.load_image_names(images_dir)
    name_to_id = {n: i for i, n in enumerate(image_names)}

    with span("xrsfm.extract") as ex:
        feats, fresh = _load_or_extract(
            images_dir, os.path.join(output_dir, "ftr.bin"), image_names,
            True, DEFAULT_SIFT, "sift", device)
        get_image_sizes(images_dir, os.path.join(output_dir, "size.bin"),
                        image_names)
    if fresh:
        print(f"[extract] total {ex.seconds:.1f}s", flush=True)
    if stats is not None:
        stats["extract_s"] = ex.seconds

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
            with span("xrsfm.retrieval") as rt:
                ranks, _ = RET.build_retrieval(
                    [f.descriptors for f in feats],
                    topk=opts.retrieval_topk, device=device)
                RET.write_retrieval_text(cache, image_names, ranks)
                id2rank = RET.ranks_to_id2rank(ranks)
            if stats is not None:
                stats["retrieval_s"] = rt.seconds
            print(f"[retrieval] built in {rt.seconds:.1f}s -> {cache}",
                  flush=True)

    with span("xrsfm.match") as mt:
        verified = _match(feats, id2rank, matching_type, opts, output_dir,
                          stats, device, mesh)
    if stats is not None:
        stats["match_verify_s"] = mt.seconds
    print(
        f"[matching] {matching_type}: {len(verified)} verified pairs "
        f"in {mt.seconds:.1f}s -> {output_dir}/fp.bin",
        flush=True,
    )
    return verified


def _match(feats, id2rank, matching_type, opts, output_dir, stats, device,
           mesh):
    """main's pairs, matching and verification, and fp.bin."""
    n = len(feats)
    if matching_type == "sequential":
        pairs = fmatch.sequential_pairs(n, opts)
        # loop-closure probes every Nth frame against retrieval neighbors
        # (reference: MatchingSeq, run_matching.cc:125-151)
        for i in range(0, n, opts.seq_loop_stride):
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
            stats=stats, device=device, mesh=mesh)
    else:
        if stats is not None:
            stats["pairs_proposed"] = len(pairs)
        verified = fmatch.match_and_verify_pairs(feats, pairs, opts,
                                                 device=device, mesh=mesh)
    IOF.write_frame_pairs(os.path.join(output_dir, "fp.bin"), verified)
    return verified
