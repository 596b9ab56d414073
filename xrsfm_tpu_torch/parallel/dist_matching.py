"""Sharded descriptor matching over a device mesh (port of
xrsfm_tpu/parallel/dist_matching.py).

Matching is independent per image pair (the reference runs pairs one
after another through one SiftMatchGPU, feature_processing.cc:222-308).
A batch of pairs is padded to a multiple of the shard count and split
into one contiguous slice per shard; each slice goes through
ops/matching.match_descriptors_batch on its shard's device, which on a
CUDA device is one launch of the `topstats` kernel.  Every pair's result
is the one a single device gives it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops import matching as dmatch
from .mesh import Mesh


def match_pairs_sharded(mesh: Mesh, descs: np.ndarray, masks: np.ndarray,
                        pair_ids: Sequence[Tuple[int, int]],
                        dist_th: float = 0.7, ratio_th: float = 0.8,
                        max_matches: int = 4096, axis: str = "pairs"):
    """Match all pairs of descs [F, K, 128] uint8 (padded per frame) with
    masks [F, K] bool, sharded over the mesh's `axis` (this process's
    devices).  Returns per pair (matches [B, max_matches, 2] int32 padded
    with -1, counts [B], distances [B, max_matches]) as numpy arrays."""
    n_dev = mesh.shape[axis]
    if n_dev != len(mesh.devices):
        raise ValueError(f"pairs shard over one process's devices; {mesh} "
                         f"has {n_dev} shards on axis {axis!r}")
    B = len(pair_ids)
    pad = (-B) % n_dev
    ids = np.asarray(list(pair_ids) + [pair_ids[0]] * pad, np.int64)
    per = len(ids) // n_dev
    outs = []
    for k, dev in enumerate(mesh.devices):
        sl = ids[k * per:(k + 1) * per]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        outs.append(dmatch.match_descriptors_batch(
            put(descs[sl[:, 0]]), put(descs[sl[:, 1]]),
            put(masks[sl[:, 0]]), put(masks[sl[:, 1]]),
            dist_th, ratio_th, max_matches))
    matches, counts, dists = (
        np.concatenate([o[i].cpu().numpy() for o in outs])[:B]
        for i in range(3))
    return matches, counts, dists
