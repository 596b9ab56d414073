"""1DSfM-regime end-to-end benchmark on the synthetic landmark scenes: the
twin of scripts/run_unordered_bench.py.

Measures the reference's headline comparison (docs/en/benchmark.md:98-114
of the reference): matching cost of retrieval top-k against covisibility
expansion on the same matcher, at equal verified-pair quality, then
reconstruction quality through rec_1dsfm (per-image SIMPLE_RADIAL with
EXIF-grade focal noise, intrinsics-refining BA, multi-focal registration,
rotation-averaging polish).

Prints one JSON line, the script's keys:
  {"frames": N, "distractors": D, "gt_pairs": G, "workspace_s": s,
   "matching": {arm: {pairs_proposed, verified_pairs, precision, recall,
                      wall_s, retrieval_s, search_s, match_s,
                      topstats_launches}},
   "expansion_speedup": r (--matching_only, both arms),
   "reconstruction": {registered, registerable, ate_pct_span,
                      focal_med_err, focal_mean_err, wall_s, frames_per_s}}
workspace_s is the host's time to write the workspace and count the
ground truth; retrieval_s (VLAD), search_s (the expansion's host search; 0
for retrieval) and match_s (matching and verification) split an arm's
wall_s beyond the workspace copy; topstats_launches counts the matcher
kernel's launches by route in that arm.  These keys are the port's
additions.

Usage: python -m xrsfm_tpu_torch.tools.run_unordered_bench
       [--scene unordered|tour] [--n_frames 80] [--distractors 0]
       [--seed 1] [--matching_only] [--rec_only]
       [--strategies both|retrieval|covisibility] [--workdir DIR]
       [--device cuda]
"""

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..device import resolve_device
from ..ops import matching as TM
from ..utils import synth

GT_COVIS_POINTS = 30  # ground-truth covisible: >= 30 shared scene points


def gt_covisibility(ids, n_scene_points):
    """[F, F] co-observation counts of scene points as one Gram product of
    the visibility matrix.  Distractor clutter is private to its frame, so
    only the scene columns can co-occur: V stays [F, scene points] rather
    than [F, all points] (7 GB at 2,000 junk frames)."""
    V = np.zeros((len(ids), n_scene_points), np.float32)
    for f, fid in enumerate(ids):
        fid = np.asarray(fid, np.int64)
        V[f, fid[fid < n_scene_points]] = 1.0
    Cm = V @ V.T
    np.fill_diagonal(Cm, 0)
    return Cm


def _run_arm(ws, d, n_total, mtype, device):
    """Match the workspace's features with one strategy in directory d;
    returns (verified pairs, wall seconds, run_matching stats, topstats
    launches of this arm by route)."""
    from ..pipelines import run_matching as RM

    os.makedirs(os.path.join(d, "images"), exist_ok=True)
    shutil.copy(os.path.join(ws, "ftr.bin"), d)
    shutil.copy(os.path.join(ws, "size.bin"), d)
    for i in range(n_total):
        open(os.path.join(d, "images", f"img{i:05d}.png"), "w").close()
    before = dict(TM.LAUNCHES)
    t0 = time.time()
    st = {}
    verified = RM.main(os.path.join(d, "images"), "", mtype, d, stats=st,
                       device=device)
    dt = time.time() - t0
    launches = {k: v - before[k] for k, v in TM.LAUNCHES.items()}
    return verified, dt, st, launches


def _reconstruction(ws, cov, n_frames, device):
    """rec_1dsfm on the covisibility arm's pairs: registered frames, ATE
    as % of the span, focal errors against the truth, seconds."""
    from ..ops.umeyama import ate_rmse
    from ..pipelines.rec_1dsfm import main as rec_main
    from ..utils import geometry as G

    t0 = time.time()
    m = rec_main(cov, os.path.join(ws, "camera_info.txt"),
                 os.path.join(cov, "model"), device=device)
    rec_s = time.time() - t0
    if m is None:
        return {"registered": 0, "registerable": n_frames,
                "wall_s": round(rec_s, 1)}
    reg = np.asarray(m.registered)
    gtf = {}
    with open(os.path.join(ws, "gt_cameras.txt")) as f:
        for line in f:
            p = line.split()
            gtf[p[0]] = float(p[1])
    errs = np.array([
        abs(float(m.cameras[int(m.cam_of_frame[i])][0]) - gtf[m.names[i]])
        / gtf[m.names[i]]
        for i in range(m.num_frames) if reg[i]])
    gtp = {}
    with open(os.path.join(ws, "gt_poses.txt")) as f:
        for line in f:
            p = line.split()
            gtp[p[0]] = (np.array(list(map(float, p[1:5]))),
                         np.array(list(map(float, p[5:8]))))
    est_c = np.array([G.pose_center_np(np.asarray(m.q[i]), np.asarray(m.t[i]))
                      for i in range(m.num_frames) if reg[i]])
    gt_c = np.array([G.pose_center_np(*gtp[m.names[i]])
                     for i in range(m.num_frames) if reg[i]])
    ate = ate_rmse(gt_c, est_c)
    span = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    return {
        "registered": int(reg.sum()),
        "registerable": n_frames,  # genuine frames (junk excluded)
        "ate_pct_span": round(100.0 * ate / span, 3),
        "focal_med_err": round(float(np.median(errs)), 4),
        "focal_mean_err": round(float(errs.mean()), 4),
        "wall_s": round(rec_s, 1),
        "frames_per_s": round(int(reg.sum()) / rec_s, 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_frames", type=int, default=80)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "unordered_bench"))
    # the expansion-vs-retrieval cost curve only, no reconstruction
    ap.add_argument("--matching_only", action="store_true")
    # unregistrable junk frames after the genuine ones: retrieval top-k
    # still spends its k verifications on each, the expansion's
    # simulated-SfM gate drops them
    ap.add_argument("--distractors", type=int, default=0)
    # reuse the workdir's scene and the covisibility arm's pairs and run
    # only the reconstruction and its evaluation
    ap.add_argument("--rec_only", action="store_true")
    # "unordered": landmark ring (dense genuine graph); "tour": a street
    # of separate facades (sparse band graph, real 1DSfM topology)
    ap.add_argument("--scene", default="unordered",
                    choices=["unordered", "tour"])
    ap.add_argument("--strategies", default="both")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)

    ws = os.path.join(a.workdir, "ws")
    n_total = a.n_frames + a.distractors
    n_gt = -1
    t0 = time.time()
    if not a.rec_only:
        shutil.rmtree(a.workdir, ignore_errors=True)
        w = synth.write_features_workspace(
            ws, a.scene, a.n_frames, a.seed, per_image_cameras=True,
            descriptors=True, distractors=a.distractors)
        Cm = gt_covisibility(w["ids"], w["n_scene_points"])
        n_gt = int(np.count_nonzero(np.triu(Cm >= GT_COVIS_POINTS, k=1)))

    result = {"frames": a.n_frames, "distractors": a.distractors,
              "gt_pairs": n_gt, "workspace_s": round(time.time() - t0, 3),
              "matching": {}}
    if a.rec_only:
        strategies = ()
    elif a.strategies == "both":
        strategies = ("retrieval", "covisibility")
    else:
        strategies = tuple(a.strategies.split(","))
    for mtype in strategies:
        verified, dt, st, launches = _run_arm(
            ws, os.path.join(a.workdir, mtype), n_total, mtype, device)
        good = sum(1 for p in verified
                   if Cm[p.id1, p.id2] >= GT_COVIS_POINTS)
        result["matching"][mtype] = {
            "pairs_proposed": st.get("pairs_proposed", -1),
            "verified_pairs": len(verified),
            "precision": round(good / max(len(verified), 1), 4),
            "recall": round(good / max(n_gt, 1), 4),
            "wall_s": round(dt, 1),
            "retrieval_s": round(st.get("retrieval_s", 0.0), 3),
            "search_s": round(st.get("search_s", 0.0), 3),
            "match_s": round(st.get("match_s", st["match_verify_s"]), 3),
            "topstats_launches": launches,
        }

    if a.matching_only:
        mm = result["matching"]
        if "retrieval" in mm and "covisibility" in mm:
            result["expansion_speedup"] = round(
                mm["retrieval"]["wall_s"]
                / max(mm["covisibility"]["wall_s"], 1e-9), 2)
        print(json.dumps(result), flush=True)
        return result

    result["reconstruction"] = _reconstruction(
        ws, os.path.join(a.workdir, "covisibility"), a.n_frames, device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
