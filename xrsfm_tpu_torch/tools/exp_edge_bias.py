"""Per-edge two-view rotation bias on the kitti-class circuit: the twin of
scripts/exp_edge_bias.py.

The circuit is feature-level synthetic (utils/synth, `synth_features.py
--scene kitti`): keypoints are ground-truth projections with isotropic
0.4 px noise, so keypoint-covariance weighting is a no-op here.  What can
own a per-edge rotation bias:
  (a) the 3% match contamination that the workspace marks as inliers,
      surviving the truncated IRLS;
  (b) the estimator's geometry (Sampson truncation under forward motion).
This tool separates them.  It measures each pair's relative rotation by
the production path of optim/rot_avg.measure_pair_rotations (essential
LO-RANSAC, pose recovery, manifold IRLS) on
  1. the stored match lists as they are (raw),
  2. the same lists with the contamination removed by ground-truth point
     identity (clean; pairs with at least 30 genuine matches),
  3. variant refinement settings on the raw lists (--th_scale, --iters,
     --irls_scale, --anneal).
If (2) is about (1), the bias is the estimator's geometry; if (2) is well
below (1), contamination owns it.

Pairs with at least 60 matches are measured, 512 matches at most (strided
down), in batches of 256 pairs padded to the batch's longest list; pair
k's RANSAC generator is seeded with k (the script's PRNGKey(k)).
--seq_only keeps the circuit's sequential pairs (each frame with its next
5, utils/synth.build_kitti_pairs) and drops the loop closures.

Prints the script's progress lines and JSON line (pairs, th_scale,
irls_scale, anneal, iters, contamination_mean, raw/clean median and p90
errors in degrees).

Usage: python -m xrsfm_tpu_torch.tools.exp_edge_bias <ws> [--n_frames 250]
       [--seed 3] [--th_scale 1.0] [--iters 10] [--seq_only]
       [--irls_scale 1.0] [--anneal] [--device cuda]
"""

import argparse
import json
import os

import numpy as np

from ..device import resolve_device
from ..mapper import kernels as K
from ..ops import epipolar
from ..pipelines.run_reconstruction import build_map
from ..utils import geometry as G
from ..utils import synth

MIN_MATCHES = 60
MAX_PTS = 512
MIN_CLEAN = 30
CHUNK = 256


def _measure_batch(u1, u2, mask, th, generators, iters, irls_scale, anneal):
    """Relative rotations [B, 4] of B padded match lists: essential
    LO-RANSAC, the cheirality-best decomposition, then the manifold IRLS
    (first at th with anneal, then at th * irls_scale)."""
    E, inl, _, _ = K.essential_ransac(u1, u2, mask, th,
                                      generators=generators)
    q, t, _, _ = epipolar.recover_pose_from_essential(E, u1, u2, inl)
    if anneal:
        q, t = epipolar.refine_essential_manifold(q, t, u1, u2, mask, th,
                                                  iters=iters)
    q, t = epipolar.refine_essential_manifold(q, t, u1, u2, mask,
                                              th * irls_scale, iters=iters)
    return (q,)


def measure(tables, keys, th, iters, irls_scale, anneal, device):
    """Rotations [P, 4] of the match tables [(u1, u2)], pair k's generator
    seeded with keys[k]; one batched call a chunk of CHUNK pairs."""
    import torch

    out = []
    for c0 in range(0, len(tables), CHUNK):
        chunk = range(c0, min(len(tables), c0 + CHUNK))
        nb = max(len(tables[k][0]) for k in chunk)
        u1 = np.zeros((len(chunk), nb, 2), np.float32)
        u2 = np.zeros((len(chunk), nb, 2), np.float32)
        mask = np.zeros((len(chunk), nb), bool)
        for r, k in enumerate(chunk):
            a, b = tables[k]
            u1[r, :len(a)], u2[r, :len(b)] = a, b
            mask[r, :len(a)] = True
        gens = [torch.Generator(device=device).manual_seed(int(keys[k]))
                for k in chunk]
        out.append(K.on_device(
            _measure_batch, u1, u2, mask,
            np.full(len(chunk), th, np.float32), generators=gens,
            iters=iters, irls_scale=irls_scale, anneal=anneal,
            device=device)[0])
    return np.concatenate(out) if out else np.zeros((0, 4), np.float32)


def _rot_err_deg(q_meas, q_gt, i, j):
    """Angle of the measured x_j = R x_i + t rotation against R_j R_i^T."""
    conj = np.array([1.0, -1.0, -1.0, -1.0])
    q_rel = G.quat_mul_np(q_gt[j], q_gt[i] * conj)
    d = G.quat_mul_np(np.asarray(q_meas, np.float64), q_rel * conj)
    return float(np.degrees(
        2.0 * np.arcsin(np.clip(np.linalg.norm(d[1:]), -1.0, 1.0))))


def run(ws, n_frames=250, seed=3, th_scale=1.0, iters=10, seq_only=False,
        irls_scale=1.0, anneal=False, device="cuda"):
    """Measure every pair; prints and returns the JSON line's dict, with
    the per-pair errors (`errs_raw`, `errs_clean`), the pairs (`edges`),
    and the pairs and match counts of the clean lists (`clean_edges`,
    `clean_sizes`) beside it."""
    if not os.path.exists(os.path.join(ws, "fp.bin")):
        synth.write_kitti_workspace(ws, n_frames, seed)
    # the generation mirrored for each keypoint's ground-truth point id
    rng = np.random.default_rng(seed)
    centers, R, pts = synth.kitti_scene(rng, n_frames)
    ids = [i for i, _ in synth.project_all(centers, R, pts, rng)]

    m = build_map(ws, os.path.join(ws, "camera.txt"))
    gt = {}
    for line in open(os.path.join(ws, "gt_poses.txt")):
        p = line.split()
        gt[p[0]] = np.array(list(map(float, p[1:5])))
    q_gt = np.stack([gt[n] for n in m.names])
    th = (2.0 / float(m.cameras[0][0])) ** 2 * th_scale

    pairs = [(i, j, mt) for i, j, mt in m.pairs
             if len(mt) >= MIN_MATCHES
             and (not seq_only or abs(j - i) <= synth.SEQ_WINDOW)]
    raw, clean, clean_k = [], [], []
    for k, (i, j, mt) in enumerate(pairs):
        sel = (mt if len(mt) <= MAX_PTS
               else mt[:: len(mt) // MAX_PTS + 1][:MAX_PTS])
        u1 = m.kps_norm[i][sel[:, 0]]
        u2 = m.kps_norm[j][sel[:, 1]]
        raw.append((u1, u2))
        good = ids[i][sel[:, 0]] == ids[j][sel[:, 1]]
        if good.sum() >= MIN_CLEAN:
            clean.append((u1[good], u2[good]))
            clean_k.append(k)
    keys = np.arange(len(pairs))
    q_raw = []
    for c0 in range(0, len(raw), CHUNK):
        q_raw.append(measure(raw[c0:c0 + CHUNK], keys[c0:c0 + CHUNK], th,
                             iters, irls_scale, anneal, device))
        done = min(len(raw), c0 + CHUNK)
        for n in range((c0 // 100 + 1) * 100, done + 1, 100):
            print(f"  {n}/{len(pairs)} pairs", flush=True)
    q_raw = np.concatenate(q_raw) if q_raw else np.zeros((0, 4))
    q_clean = measure(clean, np.asarray(clean_k), th, iters, irls_scale,
                      anneal, device)
    errs_raw = np.array([_rot_err_deg(q, q_gt, i, j)
                         for q, (i, j, _) in zip(q_raw, pairs)])
    errs_clean = np.array([_rot_err_deg(q, q_gt, pairs[k][0], pairs[k][1])
                           for q, k in zip(q_clean, clean_k)])
    contam = [1.0 - np.mean(ids[i][mt[:, 0]] == ids[j][mt[:, 1]])
              for i, j, mt in pairs]
    res = {
        "pairs": len(pairs),
        "th_scale": th_scale,
        "irls_scale": irls_scale,
        "anneal": anneal,
        "iters": iters,
        "contamination_mean": round(float(np.mean(contam)), 4),
        "raw_med_deg": round(float(np.median(errs_raw)), 4),
        "raw_p90_deg": round(float(np.percentile(errs_raw, 90)), 4),
        "clean_med_deg": round(float(np.median(errs_clean)), 4),
        "clean_p90_deg": round(float(np.percentile(errs_clean, 90)), 4),
    }
    print(json.dumps(res), flush=True)
    return dict(res, errs_raw=errs_raw, errs_clean=errs_clean,
                edges=[(i, j) for i, j, _ in pairs],
                clean_edges=[pairs[k][:2] for k in clean_k],
                clean_sizes=[len(a) for a, _ in clean])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ws")
    ap.add_argument("--n_frames", type=int, default=250)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--th_scale", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seq_only", action="store_true",
                    help="only the sequential pairs, no loop closures")
    # scale only the manifold IRLS's truncation knee (RANSAC keeps the
    # production 2 px gate)
    ap.add_argument("--irls_scale", type=float, default=1.0)
    # graduated: refine at th first (wide basin), then at th * irls_scale
    ap.add_argument("--anneal", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(a.ws, a.n_frames, a.seed, a.th_scale, a.iters, a.seq_only,
               a.irls_scale, a.anneal, resolve_device(a.device))


if __name__ == "__main__":
    main()
