"""Image retrieval: VLAD over RootSIFT descriptors (port of
xrsfm_tpu/feature/retrieval.py).

The reference ships no retrieval method: its run_matching reads a
retrieval.txt from an external tool (src/run_matching.cc:193-207,
LoadRetrievalRank in src/utility/io_feature.hpp:180-212).  As in the JAX
package, retrieval is a stage of its own, in PyTorch ops on the device:

  * vocabulary: k-means over a descriptor sample; assignment is one
    [N, 128] x [128, K] product and an argmin, the update a per-word sum
    (optim/ba.segment_sum, in a fixed order on every run);
  * VLAD: residuals to the assigned word summed per image and word, then
    intra-normalization, signed square root and global L2, with a sqrt-BoW
    occupancy block appended: one [K * 129] vector per image;
  * ranking: one [B, F] similarity product per chunk of queries, ranked
    by a stable descending sort, so that ties go to the lower image index
    (jax.lax.top_k's order; torch.topk promises none among ties).

Descriptors are the matcher's uint8 quantization of L1-root normalized
SIFT (512 v), so x / 512 is unit-L2 and dots are cosines.  Products run
inside `device.full_precision()`: TF32 would reorder near-equal cosines.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import full_precision, resolve_device
from ..optim.ba import segment_sum

# calls by the device they ran on: shows that a run's retrieval ran there
COUNTS = {"vlad_cuda": 0, "vlad_cpu": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _kmeans(descs, init_centers, iters: int):
    """Lloyd iterations on descs [N, 128] from init_centers [K, 128]; an
    all-zero row is padding and takes no part.  Assignment is the argmin
    of ||c||^2 - 2 x.c (the first index among equals); a word that
    receives nothing keeps its center.  Returns (centers, mean squared
    quantization error)."""
    with full_precision():
        valid = (descs != 0.0).any(dim=1).to(descs.dtype)
        K = init_centers.shape[0]
        centers = init_centers
        for _ in range(iters):
            d2 = (centers * centers).sum(dim=1)[None, :] - 2.0 * (
                descs @ centers.T)
            assign = torch.argmin(d2, dim=1)
            sums = segment_sum(descs * valid[:, None], assign, K)
            counts = segment_sum(valid, assign, K)
            new = sums / counts.clamp_min(1.0)[:, None]
            centers = torch.where(counts[:, None] > 0, new, centers)
        d2 = (centers * centers).sum(dim=1)[None, :] - 2.0 * (descs @ centers.T)
        n = valid.sum().clamp_min(1.0)
        err = ((d2.min(dim=1).values * valid).sum() / n
               + (descs * descs * valid[:, None]).sum() / n)
    return centers, err


def train_vocabulary(
    desc_sets: Sequence[np.ndarray],
    num_words: int = 64,
    iters: int = 15,
    max_samples: int = 65536,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """A visual vocabulary [num_words, 128] float32 (unit-RootSIFT scale)
    from per-image uint8 descriptor arrays: host numpy sampling and init
    (the JAX package's draws from default_rng(seed)), Lloyd on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pool = [d for d in desc_sets if len(d)]
    if not pool:
        return np.zeros((num_words, 128), np.float32)
    alld = np.concatenate(pool, axis=0).astype(np.float32) / 512.0
    if len(alld) > max_samples:
        alld = alld[rng.choice(len(alld), size=max_samples, replace=False)]
    n = len(alld)
    # random distinct picks; duplicated with a little noise for tiny samples
    init_idx = rng.choice(n, size=min(num_words, n), replace=False)
    init = np.zeros((num_words, 128), np.float32)
    init[: len(init_idx)] = alld[init_idx]
    if len(init_idx) < num_words:
        extra = rng.choice(len(init_idx), num_words - len(init_idx))
        init[len(init_idx):] = alld[init_idx[extra]] + rng.normal(
            scale=1e-3, size=(num_words - len(init_idx), 128)
        ).astype(np.float32)
    centers, _ = _kmeans(torch.from_numpy(alld).to(dev),
                         torch.from_numpy(init).to(dev), iters)
    return centers.cpu().numpy()


def _vlad_batch(descs, valid, vocab):
    """descs [B, N, 128], valid [B, N], vocab [K, 128] -> [B, K * 129].

    Hard-assignment VLAD with intra-normalization, signed square root and
    global L2, and a sqrt-BoW occupancy block (which words an image
    occupies carries the scene when the vocabulary is trained on the
    indexed images themselves); the two unit blocks are concatenated and
    renormalized.  An image with no descriptor stays zero."""
    B, N, _ = descs.shape
    K = vocab.shape[0]
    with full_precision():
        d2 = (vocab * vocab).sum(dim=1)[None, None, :] - 2.0 * torch.einsum(
            "bnd,kd->bnk", descs, vocab)
    assign = torch.argmin(d2, dim=2)  # [B, N]
    seg = (torch.arange(B, device=descs.device)[:, None] * K
           + assign).reshape(-1)
    w = valid.reshape(-1)
    sums = segment_sum(descs.reshape(-1, 128) * w[:, None], seg, B * K)
    counts = segment_sum(w, seg, B * K).reshape(B, K)
    v = sums.reshape(B, K, 128) - counts[..., None] * vocab[None]
    v = v / (torch.linalg.vector_norm(v, dim=2, keepdim=True) + 1e-12)
    v = v.reshape(B, -1)
    v = torch.sign(v) * torch.sqrt(v.abs())
    v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
    bow = torch.sqrt(counts)
    bow = bow / (torch.linalg.vector_norm(bow, dim=1, keepdim=True) + 1e-12)
    out = torch.cat([v, bow], dim=1) / np.float32(np.sqrt(2.0))
    return torch.where((valid > 0).any(dim=1)[:, None], out, 0.0)


def encode_vlad(
    desc_sets: Sequence[np.ndarray],
    vocab: np.ndarray,
    batch_size: int = 16,
    device="cuda",
) -> np.ndarray:
    """VLAD vectors [F, K * 129] float32 of every image's uint8
    descriptors (zero rows for images without any), in batches of images
    of similar descriptor counts padded to the batch's largest (padding
    does not change a vector)."""
    dev = resolve_device(device)
    F = len(desc_sets)
    K = vocab.shape[0]
    out = np.zeros((F, K * 129), np.float32)
    vocab_t = torch.from_numpy(np.asarray(vocab, np.float32)).to(dev)
    order = np.argsort([len(d) for d in desc_sets], kind="stable")
    for s in range(0, F, batch_size):
        ids = order[s: s + batch_size]
        maxn = max(int(len(desc_sets[i])) for i in ids)
        if maxn == 0:
            continue
        db = np.zeros((len(ids), maxn, 128), np.float32)
        vb = np.zeros((len(ids), maxn), np.float32)
        for r, i in enumerate(ids):
            d = desc_sets[i]
            db[r, : len(d)] = d.astype(np.float32) / 512.0
            vb[r, : len(d)] = 1.0
        enc = _vlad_batch(torch.from_numpy(db).to(dev),
                          torch.from_numpy(vb).to(dev), vocab_t)
        out[ids] = enc.cpu().numpy()
    return out


def _topk_sim(q, db, qids, topk: int):
    """Top-k similar rows of db for each query row of q (itself masked
    out): (values, indices), ties to the lower index."""
    with full_precision():
        sim = q @ db.T  # [Bq, F]
    col = torch.arange(db.shape[0], device=db.device)
    sim = torch.where(col[None, :] == qids[:, None], -torch.inf, sim)
    vals, idx = torch.sort(sim, dim=1, descending=True, stable=True)
    k = min(topk, db.shape[0])
    return vals[:, :k], idx[:, :k]


def rank_images(vlads: np.ndarray, topk: int = 25, chunk: int = 256,
                device="cuda") -> np.ndarray:
    """Top-k most similar image ids per image by VLAD cosine, [F, k] with
    k = min(topk, F - 1) (at least 1)."""
    dev = resolve_device(device)
    F = len(vlads)
    k = min(topk, max(F - 1, 1))
    out = np.zeros((F, k), np.int32)
    db = torch.from_numpy(np.asarray(vlads, np.float32)).to(dev)
    for s in range(0, F, chunk):
        e = min(s + chunk, F)
        _, idx = _topk_sim(db[s:e], db, torch.arange(s, e, device=dev), k)
        out[s:e] = idx[:, :k].cpu().numpy()
    return out


def ranks_to_id2rank(ranks: np.ndarray) -> Dict[int, List[int]]:
    """[F, topk] ranks -> the id -> ranked ids dict of load_retrieval_rank."""
    return {i: [int(j) for j in row] for i, row in enumerate(ranks)}


def write_retrieval_text(path: str, image_names: Sequence[str],
                         ranks: np.ndarray) -> None:
    """`query match` lines, grouped by query in rank order: the format the
    reference's LoadRetrievalRank reads (io_feature.hpp:180-212)."""
    with open(path, "w") as f:
        for i, row in enumerate(ranks):
            for j in row:
                f.write(f"{image_names[i]} {image_names[int(j)]}\n")


def build_retrieval(
    desc_sets: Sequence[np.ndarray],
    num_words: int = 64,
    topk: int = 25,
    seed: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Vocabulary, VLAD and ranks on `device`.  Returns (ranks, vlads)."""
    dev = resolve_device(device)
    COUNTS[f"vlad_{dev.type}"] += 1
    vocab = train_vocabulary(desc_sets, num_words=num_words, seed=seed,
                             device=dev)
    vlads = encode_vlad(desc_sets, vocab, device=dev)
    return rank_images(vlads, topk=topk, device=dev), vlads
