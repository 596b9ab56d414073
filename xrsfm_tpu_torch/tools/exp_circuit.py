"""Circuit drift-basin experiment harness: the twin of scripts/exp_circuit.py.

Decouples global-polish experiments from the full pipeline run:

  prep:      write the 250-frame kitti-class circuit (utils/synth, the
             bytes of `synth_features.py --scene kitti --seed 3`) unless
             the workspace holds one, run the incremental mapper with loop
             correction and WITHOUT the global polish (the drifted basin),
             snapshot the final map as drifted.npz (base/snapshot: the JAX
             package's npz keys).
  exp:       load the snapshot, run a polish variant (rotation averaging +
             translation recovery + retriangulate + GBA rounds; with
             --rot_freeze a rotation-frozen GBA settles translations and
             structure first), print ATE and GBA cost after every stage.
  decompose: per-frame ATE decomposition along the circuit.
  gt_settle: the settled cost from the pipeline's basin against a settle
             from ground-truth poses on the same observations.
  sweep:     cost along the straight path from the settled state to the
             aligned ground truth, poses frozen, points free.

Each phase prints the script's lines and returns its figures.

Usage:
  python -m xrsfm_tpu_torch.tools.exp_circuit prep <ws> [--device cuda]
  python -m xrsfm_tpu_torch.tools.exp_circuit exp <ws> [--rounds N]
         [--parallax {off,lin,sq}] [--rot_freeze] [--device cuda]
  python -m xrsfm_tpu_torch.tools.exp_circuit {decompose,gt_settle,sweep}
         <ws> [--snap drifted.npz] [--device cuda]
"""

import argparse
import dataclasses
import os
import time

import numpy as np

from ..base import snapshot as SNAP
from ..device import resolve_device
from ..mapper import ba_glue, triangulate
from ..mapper.incremental import IncrementalMapper, MapperOptions
from ..ops.umeyama import ate_rmse, umeyama
from ..optim import global_pose
from ..optim.ba import BAOptions
from ..pipelines.run_reconstruction import build_map
from ..utils import geometry as G
from ..utils import synth


def _load_gt(ws):
    gt = {}
    for line in open(os.path.join(ws, "gt_poses.txt")):
        p = line.split()
        gt[p[0]] = (np.array(list(map(float, p[1:5]))),
                    np.array(list(map(float, p[5:8]))))
    return gt


def _ate(m, ws):
    """(sim(3)-aligned ATE RMSE, ground-truth span, frames) of the
    registered frames."""
    gt = _load_gt(ws)
    est_c, gt_c = [], []
    for i in range(m.num_frames):
        if not m.registered[i] or m.names[i] not in gt:
            continue
        est_c.append(G.pose_center_np(np.asarray(m.q[i]), np.asarray(m.t[i])))
        gt_c.append(G.pose_center_np(*gt[m.names[i]]))
    est_c, gt_c = np.asarray(est_c), np.asarray(gt_c)
    span = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    return float(ate_rmse(gt_c, est_c)), span, len(est_c)


def _load(ws, snap):
    m = build_map(ws, os.path.join(ws, "camera.txt"))
    if snap:
        SNAP.restore_into(m, os.path.join(ws, snap))
    return m


def decompose(ws, snap="drifted.npz"):
    """Per-frame ATE decomposition: where along the circuit the error
    lives and in which direction (sim(3) alignment, then the error's
    longitudinal / lateral / vertical split per frame block and the
    per-frame rotation error against ground truth).  Writes
    decompose.npz; returns the ATE in % of the span."""
    m = _load(ws, snap)
    gt = _load_gt(ws)
    idx, est_c, gt_c, rot_err = [], [], [], []
    for i in range(m.num_frames):
        if not m.registered[i] or m.names[i] not in gt:
            continue
        idx.append(i)
        est_c.append(G.pose_center_np(np.asarray(m.q[i]), np.asarray(m.t[i])))
        qg, tg = gt[m.names[i]]
        gt_c.append(G.pose_center_np(qg, tg))
        rot_err.append((G.quat_to_rotmat_np(np.asarray(m.q[i], np.float64)),
                        G.quat_to_rotmat_np(np.asarray(qg, np.float64))))
    est_c, gt_c = np.asarray(est_c), np.asarray(gt_c)
    s, R, t = umeyama(est_c, gt_c)
    aligned = s * est_c @ R.T + t
    err = aligned - gt_c
    emag = np.linalg.norm(err, axis=1)
    span = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    # rotation errors in the aligned gauge: x_w' = R x_w => R_cam' = R_cam R^T
    rerr = np.asarray([
        np.degrees(np.arccos(np.clip(
            (np.trace((Re @ R.T) @ Rg.T) - 1) / 2, -1, 1)))
        for Re, Rg in rot_err])
    # longitudinal = along the direction of travel; lateral = horizontal
    # perpendicular; vertical = ground-truth y
    d_trav = np.gradient(gt_c, axis=0)
    d_trav /= np.maximum(np.linalg.norm(d_trav, axis=1, keepdims=True), 1e-9)
    lat = np.cross(np.array([0.0, 1.0, 0.0]), d_trav)
    lat /= np.maximum(np.linalg.norm(lat, axis=1, keepdims=True), 1e-9)
    e_long = np.abs(np.sum(err * d_trav, axis=1))
    e_lat = np.abs(np.sum(err * lat, axis=1))
    e_vert = np.abs(err[:, 1])
    ate = float(np.sqrt(np.mean(emag**2)))
    print(f"ATE {ate:.4f} ({100 * ate / span:.3f}% of span), "
          f"scale {s:.5f}, frames {len(idx)}")
    print(f"rot err: mean {rerr.mean():.3f} deg, max {rerr.max():.3f}")
    print(f"components rms: long {np.sqrt(np.mean(e_long**2)):.4f} "
          f"lat {np.sqrt(np.mean(e_lat**2)):.4f} "
          f"vert {np.sqrt(np.mean(e_vert**2)):.4f}")
    step = max(1, len(idx) // 10)
    print("frame-block | err_rms  long  lat  vert | rot_deg")
    for b in range(0, len(idx), step):
        sl = slice(b, min(b + step, len(idx)))
        print(f"  {idx[sl.start]:4d}-{idx[sl.stop - 1]:4d} | "
              f"{np.sqrt(np.mean(emag[sl]**2)):.4f}  "
              f"{np.sqrt(np.mean(e_long[sl]**2)):.4f} "
              f"{np.sqrt(np.mean(e_lat[sl]**2)):.4f} "
              f"{np.sqrt(np.mean(e_vert[sl]**2)):.4f} | "
              f"{rerr[sl].mean():.3f}")
    np.savez(os.path.join(ws, "decompose.npz"), idx=np.asarray(idx),
             err=err, emag=emag, rerr=rerr, aligned=aligned, gt=gt_c)
    return 100 * ate / span


def _settle(m, device, rounds=3, iters=40):
    """Settle the current pose and track state: full retriangulation, then
    precise GBA rounds.  Returns (final cost, observations)."""
    o = MapperOptions()
    triangulate.retriangulate(
        m, np.nonzero(m.track_valid[: m.num_tracks])[0], o.tri, device=device)
    reg_frames = list(np.nonzero(m.registered)[0])
    res = None
    for _ in range(rounds):
        res = ba_glue.run_ba(
            m, reg_frames, BAOptions(max_iters=iters, huber_px=4.0,
                                     precise=True), device=device)
    return res.final_cost, res.n_obs


def gt_settle(ws, snap="drifted.npz", device="cuda"):
    """The cost floor: on the same observations and tracks, the cost a
    settle reaches from the pipeline's basin and from ground-truth poses.
    Equal costs at ATEs 100x apart mean the error is a near-null valley
    of the cost surface; a clearly lower ground-truth cost means signal
    is left.  Returns ((cost, ATE %) as loaded, (cost, ATE %) from GT)."""
    m = _load(ws, snap)
    out = []
    for label in ("as-loaded settle:", "GT-start settle: "):
        if out:  # the second settle starts from the ground-truth poses
            gt = _load_gt(ws)
            for i in range(m.num_frames):
                if m.registered[i] and m.names[i] in gt:
                    m.q[i], m.t[i] = gt[m.names[i]]
        c, n = _settle(m, device)
        ate, span, _ = _ate(m, ws)
        print(f"{label} cost {c:.1f} over {n} obs "
              f"({c / max(n, 1):.4f}/obs), ATE {100 * ate / span:.3f}%")
        out.append((c, 100 * ate / span))
    return tuple(out)


def _rot_interp(R0, Rt, a):
    """R0 moved by the fraction a of the rotation from R0 to Rt."""
    dR = Rt @ R0.T
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    if ang <= 1e-9:
        return R0
    axis = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                     dR[1, 0] - dR[0, 1]]) / (2 * np.sin(ang))
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    aa = a * ang
    return (np.eye(3) + np.sin(aa) * K + (1 - np.cos(aa)) * K @ K) @ R0


def sweep(ws, snap="drifted.npz", alphas=(0.0, 0.25, 0.5, 0.75, 1.0),
          device="cuda"):
    """cost(alpha) along the straight path from the settled state to the
    gauge-aligned ground truth: interpolate poses, retriangulate, settle
    the points with the poses frozen.  A flat curve: the error lives in a
    near-null valley; a barrier: a genuine basin wall.  Returns [(alpha,
    cost, ATE %)]."""
    m = _load(ws, snap)
    _settle(m, device)
    gt = _load_gt(ws)
    reg = np.nonzero(np.asarray(m.registered))[0]
    q0 = np.array(m.q)
    t0 = np.array(m.t)
    # ground truth into the map's gauge (sim(3) on the centers; the
    # rotation applied to the ground-truth rotations as well)
    est_c = np.array([G.pose_center_np(q0[i], t0[i]) for i in reg])
    gt_c = np.array([G.pose_center_np(*gt[m.names[i]]) for i in reg])
    s, R, t = umeyama(gt_c, est_c)
    o = MapperOptions()
    out = []
    for a in alphas:
        for i in reg:
            qg, tg = gt[m.names[i]]
            Rg = G.quat_to_rotmat_np(np.asarray(qg, np.float64))
            cg = s * R @ G.pose_center_np(qg, tg) + t
            R0 = G.quat_to_rotmat_np(np.asarray(q0[i], np.float64))
            Ri = _rot_interp(R0, Rg @ R.T, a)
            ci = (1 - a) * G.pose_center_np(q0[i], t0[i]) + a * cg
            m.q[i] = G.rotmat_to_quat_np(Ri)
            m.t[i] = -Ri @ ci
        triangulate.retriangulate(
            m, np.nonzero(m.track_valid[: m.num_tracks])[0], o.tri,
            device=device)
        # the structure's cost at these poses: two point-only rounds
        res = None
        for _ in range(2):
            res = ba_glue.run_ba(
                m, list(reg), BAOptions(max_iters=25, huber_px=4.0,
                                        precise=True),
                fix_all_poses=True, device=device)
        ate, span, _ = _ate(m, ws)
        print(f"alpha {a:.2f}: cost {res.final_cost:.1f} "
              f"({res.final_cost / max(res.n_obs, 1):.4f}/obs, "
              f"{res.n_obs} obs), ATE {100 * ate / span:.3f}%")
        out.append((a, res.final_cost, 100 * ate / span))
    return out


def prep(ws, device="cuda"):
    """The drifted basin: the mapper with loop correction, no global
    polish.  Writes ws/drifted.npz; returns (registered, ATE % of span,
    seconds)."""
    if not os.path.exists(os.path.join(ws, "fp.bin")):
        synth.write_kitti_workspace(ws, 250, 3)
    m = build_map(ws, os.path.join(ws, "camera.txt"))
    opts = MapperOptions()
    opts.correct_pose = True
    opts.global_polish = False
    opts.rot_avg_polish = False
    t0 = time.time()
    IncrementalMapper(opts, device=device).reconstruct(m)
    dt = time.time() - t0
    ate, span, n = _ate(m, ws)
    print(f"prep: {n} reg, ATE {ate:.3f} ({100 * ate / span:.2f}% of span), "
          f"{dt:.0f}s")
    SNAP.save_snapshot(m, os.path.join(ws, "drifted.npz"))
    return n, 100 * ate / span, dt


def exp(ws, rounds, parallax, rot_freeze=False, device="cuda"):
    """Polish rounds from the snapshot.  Returns one dict a round: the
    ATE % after the polish (`polish_ate`, with `rewrote`), and when the
    polish rewrote the map: the rotation-frozen GBA's costs, the ATE % after
    it and whether every quaternion of the map stayed bit for bit
    (`rot_frozen`: initial, final, ate, q_kept; with --rot_freeze), the two
    free GBAs' and the final GBA's (initial, final) costs, and the ATE % at
    the end (`ate`)."""
    m = _load(ws, "drifted.npz")
    o = MapperOptions()
    ate, span, n = _ate(m, ws)
    print(f"start: {n} reg, ATE {100 * ate / span:.3f}%")

    def log(s):
        print("  " + s)

    out = []
    for r in range(rounds):
        t0 = time.time()
        rotated = global_pose.global_pose_polish(m, log=log,
                                                 parallax=parallax,
                                                 device=device)
        ate, span, n = _ate(m, ws)
        print(f"round {r}: polish rewrote={rotated}, ATE "
              f"{100 * ate / span:.3f}% ({time.time() - t0:.0f}s)")
        rec = {"rewrote": bool(rotated), "polish_ate": 100 * ate / span}
        out.append(rec)
        if not rotated:
            break
        triangulate.retriangulate(
            m, np.nonzero(m.track_valid[: m.num_tracks])[0], o.tri,
            device=device)
        polish = BAOptions(max_iters=2 * o.gba_iters, huber_px=4.0,
                           precise=True)
        reg_frames = list(np.nonzero(m.registered)[0])
        if rot_freeze:
            # settle translations and structure under the averaged
            # rotations first: a free GBA from rewritten poses can slide
            # back into the drift basin through the rotation directions
            q_before = m.q.copy()
            res = ba_glue.run_ba(m, reg_frames, polish,
                                 freeze_rotations=True, device=device)
            print(f"  GBA rot-frozen: {res.initial_cost:.1f} -> "
                  f"{res.final_cost:.1f}")
            ate, span, n = _ate(m, ws)
            print(f"  after rot-frozen settle: ATE {100 * ate / span:.3f}%")
            rec["rot_frozen"] = {
                "initial": res.initial_cost, "final": res.final_cost,
                "ate": 100 * ate / span,
                "q_kept": bool(np.array_equal(m.q, q_before))}
        rec["gba"] = []
        for _g in range(2):
            res = ba_glue.run_ba(m, reg_frames, polish, device=device)
            print(f"  GBA: {res.initial_cost:.1f} -> {res.final_cost:.1f}")
            rec["gba"].append((res.initial_cost, res.final_cost))
        tight = dataclasses.replace(o.tri, filter_px=o.tri.polish_px)
        triangulate.filter_tracks(m, None, tight, device=device)
        triangulate.merge_all_tracks(m, None, o.tri, device=device)
        triangulate.retriangulate(m, None, o.tri, device=device)
        res = ba_glue.run_ba(m, reg_frames,
                             BAOptions(max_iters=o.gba_iters, huber_px=2.0),
                             device=device)
        print(f"  GBA final: {res.initial_cost:.1f} -> {res.final_cost:.1f}")
        rec["gba_final"] = (res.initial_cost, res.final_cost)
        ate, span, n = _ate(m, ws)
        print(f"round {r}: after GBA, ATE {100 * ate / span:.3f}% "
              f"({time.time() - t0:.0f}s total)")
        rec["ate"] = 100 * ate / span
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("phase",
                    choices=["prep", "exp", "decompose", "gt_settle",
                             "sweep"])
    ap.add_argument("ws")
    ap.add_argument("--snap", default="drifted.npz",
                    help="snapshot for decompose ('' = the ws model as-is)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parallax", default="off", choices=["off", "lin", "sq"])
    ap.add_argument("--rot_freeze", action="store_true",
                    help="settle translations/structure under the "
                         "averaged rotations before the free GBA rounds")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    if a.phase == "prep":
        return prep(a.ws, dev)
    if a.phase == "decompose":
        return decompose(a.ws, a.snap)
    if a.phase == "gt_settle":
        return gt_settle(a.ws, a.snap, dev)
    if a.phase == "sweep":
        return sweep(a.ws, a.snap, device=dev)
    return exp(a.ws, a.rounds, a.parallax, rot_freeze=a.rot_freeze,
               device=dev)


if __name__ == "__main__":
    main()
