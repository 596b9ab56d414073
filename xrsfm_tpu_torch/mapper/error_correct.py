"""Drift/loop error detection and correction (port of
xrsfm_tpu/mapper/error_correct.py; reference: ErrorDetector,
src/geometry/error_detector.cc:5-159, ErrorCorrector,
src/geometry/error_corrector.cc:18-246).

For a newly registered frame (CheckAndCorrectPose):
  1. detect: test each registered pair of the frame against the current
     relative pose (a 2-degree ray band, >= 80% inliers is good; pure
     rotations skipped);
  2. TryLocate 2-view: essential RANSAC, cheirality and map-depth scale
     against the strongest pair of the inconsistent camp (PnP relocation
     falls into the coplanar mirror branch on wall-dominated camps), the
     hypothesis checked epipolarly against its own camp;
  3. if the hypotheses are farther apart than the gate (relative to the
     median covisible baseline), spread the junction Sim(3) mismatch over
     the loop and refine with the full-pose scale pose graph
     (optim/pose_graph); reject a solution whose cost stays high;
  4. fuse duplicate tracks across the loop (keypoint identity at the
     junction, then the verified matches of every epipolar-inconsistent
     pair) and retriangulate every track;
  5. two rounds of full GBA, a global merge sweep, two more rounds.
With XRSFM_DUMP_CORRECTION_SNAPSHOT set to a path prefix, a correction
saves the map before it (<prefix>.pre.frame<N>.npz, base/snapshot), the
alternative pose (<prefix>.alt.frame<N>.npz) and the map after the fusion
(<prefix>.frame<N>.npz), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from . import kernels, triangulate
from .register import RegisterOptions
from ..base import snapshot as SNAP
from ..base.map import SfMMap
from ..ops import epipolar
from ..optim import pose_graph as PG
from ..optim.ba import BAOptions
from ..utils import geometry as G


@dataclasses.dataclass
class ErrorCorrectOptions:
    angle_band_deg: float = 2.0  # reference: sin 2 deg band
    min_good_ratio: float = 0.8  # reference: >= 80% inliers = good pair
    pure_rotation_th: float = 0.01
    # loop-correction gate: the reference's absolute 1.5 m hypothesis
    # distance (error_corrector.cc:219) as a cap, and otherwise a multiple
    # of the median baseline between the frame and its covisible
    # neighbours, so that scenes a few units across are gated too
    hypothesis_dist_th: float = 1.5  # absolute cap (scene units)
    hypothesis_dist_rel: float = 2.0  # x median covisible baseline
    # TryLocate relocates against one loop pair's tracks, where loops
    # announce themselves first with few matches
    loop_min_correspondences: int = 12
    # the pose-graph solve must cut the initial cost to this ratio, or
    # land below this residual per edge
    max_graph_cost_ratio: float = 0.35
    max_graph_cost_per_edge: float = 0.08
    min_covis_engage: int = 10  # engage detection when covis obs < 10
    loop_edge_weight: float = 4.0
    covis_min_shared: int = 10


def _rel_pose_stats(q1, t1, q2, t2, uv1, uv2, mask, th):
    """Relative-pose consistency of P pairs: relative pose -> essential ->
    Sampson -> (good, total, baseline) [P, 3]."""
    qr, tr = G.pose_relative(q2, t2, q1, t1)  # T21: x2 = R x1 + t
    baseline = torch.linalg.norm(tr, dim=-1)
    E = epipolar.essential_from_pose(
        qr, tr / baseline.clamp_min(1e-12)[..., None])
    good = (epipolar.sampson_error(E, uv1, uv2) < th) & mask
    return (good.sum(dim=-1).to(uv1.dtype), mask.sum(dim=-1).to(uv1.dtype),
            baseline)


def _pair_stats_many(m: SfMMap, pair_list, opts: ErrorCorrectOptions,
                     pose_override=None, *, device):
    """Consistency stats of many (id1, id2, matches) in one device pass.
    pose_override: {frame: (q, t)} evaluated instead of the map pose.
    Returns [P, 3] numpy (good, total, baseline)."""
    pose_override = pose_override or {}

    def pose(f):
        return pose_override.get(f, (m.q[f], m.t[f]))

    P = len(pair_list)
    nb = max(len(mt) for _, _, mt in pair_list)
    q1 = np.zeros((P, 4), np.float32)
    q2 = np.zeros((P, 4), np.float32)
    t1 = np.zeros((P, 3), np.float32)
    t2 = np.zeros((P, 3), np.float32)
    uv1 = np.zeros((P, nb, 2), np.float32)
    uv2 = np.zeros((P, nb, 2), np.float32)
    mask = np.zeros((P, nb), bool)
    for i, (id1, id2, mt) in enumerate(pair_list):
        n = len(mt)
        q1[i], t1[i] = pose(id1)
        q2[i], t2[i] = pose(id2)
        uv1[i, :n] = m.kps_norm[id1][mt[:, 0]]
        uv2[i, :n] = m.kps_norm[id2][mt[:, 1]]
        mask[i, :n] = True
    th = float(np.float32(float(np.sin(np.deg2rad(opts.angle_band_deg))) ** 2))
    return np.stack(kernels.on_device(
        _rel_pose_stats, q1, t1, q2, t2, uv1, uv2, mask, th=th,
        device=device), axis=1)


def _good_from_stats(stats_row, opts: ErrorCorrectOptions) -> bool:
    good, total, baseline = stats_row
    if baseline < opts.pure_rotation_th:
        return True  # pure rotation: skip (reference behavior)
    return bool(good >= opts.min_good_ratio * max(total, 1.0))


def is_good_relative_pose(m: SfMMap, id1: int, id2: int, matches,
                          opts: ErrorCorrectOptions, *, device) -> bool:
    """Matches consistent with the current relative pose?  (reference:
    IsGoodRelativePose, error_detector.cc:5-101)."""
    stats = _pair_stats_many(m, [(id1, id2, matches)], opts, device=device)
    return _good_from_stats(stats[0], opts)


def check_all_relative_pose(m: SfMMap, frame: int,
                            opts: ErrorCorrectOptions,
                            engage_all: bool = False, *,
                            device) -> List[int]:
    """Neighbours whose relative pose to `frame` disagrees with the
    matches (reference: CheckAllRelativePose, error_detector.cc:103-159).
    engage_all=True checks every registered pair; otherwise only weakly
    covisible pairs, as in the reference."""
    todo = []
    for pid in m.frame_pairs_of[frame]:
        id1, id2, matches = m.pairs[pid]
        other = id2 if id1 == frame else id1
        if not m.registered[other] or len(matches) < 8:
            continue
        if not engage_all:
            p2d = matches[:, 0] if id1 == frame else matches[:, 1]
            tids = m.track_of[frame][p2d]
            tids = tids[tids >= 0]
            tids = tids[m.track_valid[tids]]
            shared = sum(1 for t in tids if other in m.track_obs[int(t)])
            if shared >= opts.min_covis_engage:
                continue
        todo.append((id1, id2, matches, other))
    if not todo:
        return []
    stats = _pair_stats_many(m, [(a, b, mt) for a, b, mt, _ in todo], opts,
                             device=device)
    return [
        other for (_, _, _, other), s in zip(todo, stats)
        if not _good_from_stats(s, opts)
    ]


def registration_is_consistent(m: SfMMap, frame: int,
                               opts: Optional[ErrorCorrectOptions] = None,
                               *, device):
    """Post-registration gate: the new pose must satisfy the epipolar
    geometry of at least half of its matched registered neighbours.
    Catches the planar-PnP two-fold ambiguity, a mirrored pose whose
    reprojections fit but whose relative geometry is wrong."""
    opts = opts or ErrorCorrectOptions()
    todo = []
    for pid in m.frame_pairs_of[frame]:
        id1, id2, matches = m.pairs[pid]
        other = id2 if id1 == frame else id1
        if not m.registered[other] or other == frame or len(matches) < 8:
            continue
        todo.append((id1, id2, matches))
    if not todo:
        return True
    stats = _pair_stats_many(m, todo, opts, device=device)
    n_bad = sum(1 for s in stats if not _good_from_stats(s, opts))
    return n_bad <= 0.5 * len(todo)


def _locate_probe(uv1, uv2, mask, th, generators):
    E, inl, _n_inl, success = kernels.essential_ransac(
        uv1, uv2, mask, th, generators=generators)
    q, t, n_good, X, good, _ang = kernels.init_pair_stats(E, uv1, uv2, inl)
    return q, t, n_good, X, good, inl, success


def try_locate(m: SfMMap, frame: int, bad_frames: List[int],
               reg_opts: RegisterOptions, min_corr: Optional[int] = None,
               *, device):
    """Alternative pose hypothesis from the bad-matched camp (reference:
    TryLocate -> RegisterNextImageLocal, error_corrector.cc:120-142,
    pnp.cc:133-168), computed 2-view: essential RANSAC on the strongest
    camp pair's matches, pose recovery with the cheirality vote (the planar
    mirror branch puts points behind the cameras and loses), translation
    scale from the camp's map depths at the matched keypoints.  Returns
    (q_alt, t_alt, assoc), assoc mapping the frame's keypoints to the
    camp's track ids (for merge_track_loop), or None."""
    min_corr = reg_opts.min_correspondences if min_corr is None else min_corr
    bad_set = set(int(f) for f in bad_frames)
    best = None
    for pid in m.frame_pairs_of[frame]:
        id1, id2, mt = m.pairs[pid]
        other = id2 if id1 == frame else id1
        if other in bad_set and m.registered[other] and len(mt) >= 8:
            if best is None or len(mt) > len(best[2]):
                best = (id1, id2, mt, other)
    if best is None:
        return None
    id1, id2, mt, other = best
    mk_other = mt[:, 0] if id1 == other else mt[:, 1]
    mk_frame = mt[:, 1] if id1 == other else mt[:, 0]
    if len(mt) < min_corr:
        return None
    n = len(mt)
    uv1 = m.kps_norm[other][mk_other]
    uv2 = m.kps_norm[frame][mk_frame]
    focal = float(m.cameras[int(m.cam_of_frame[frame])][0])
    th = np.float32((reg_opts.ransac_px / focal) ** 2)
    # the integer the JAX package seeds its PRNGKey with
    gen = torch.Generator(device=device).manual_seed(
        (frame * 31 + other + 777) & 0x7FFFFFFF)
    q_r, t_r, n_good, X, good, inl, success = (a[0] for a in kernels.on_device(
        _locate_probe, uv1[None], uv2[None], np.ones((1, n), bool),
        np.full(1, th), generators=[gen], device=device))
    if not bool(success) or int(n_good) < min_corr:
        return None
    good = good & inl
    X = np.asarray(X, np.float64)  # points in `other`'s camera frame

    # translation scale from the camp's structure: depth of the matched
    # tracks in `other`'s camera vs the 2-view triangulated depth
    tids = m.track_of[other][mk_other]
    has_track = tids >= 0
    has_track[has_track] = m.track_valid[tids[has_track]]
    sel = good & has_track & (X[:, 2] > 1e-6)
    if np.count_nonzero(sel) < 4:
        return None
    R_o = G.quat_to_rotmat_np(m.q[other])
    z_map = (m.track_xyz[tids[sel]] @ R_o.T + m.t[other])[:, 2]
    z_tri = X[sel, 2]
    pos = (z_map > 1e-6) & (z_tri > 1e-6)
    if np.count_nonzero(pos) < 4:
        return None
    s = float(np.median(z_map[pos] / z_tri[pos]))
    if not np.isfinite(s) or s <= 1e-6:
        return None

    # T_frame<-world = T_frame<-other * T_other<-world, translation scaled
    q_alt = G.quat_mul_np(q_r, m.q[other])
    R_r = G.quat_to_rotmat_np(np.asarray(q_r, np.float64))
    t_alt = R_r @ m.t[other] + s * np.asarray(t_r, np.float64)
    assoc = [(int(mk_frame[k]), int(tids[k]))
             for k in np.nonzero(good & has_track)[0]]
    return np.asarray(q_alt, np.float64), np.asarray(t_alt, np.float64), assoc


def _mean_depth(m: SfMMap, frame: int, q, t) -> float:
    _p2d, tids = m.frame_observations(frame)
    if len(tids) == 0:
        return 1.0
    z = (m.track_xyz[tids] @ G.quat_to_rotmat_np(q).T + t)[:, 2]
    z = z[z > 0]
    return float(np.mean(z)) if len(z) else 1.0


def spread_loop_correction(m: SfMMap, frame: int, q_alt, t_alt, camp1,
                           camp2, s_obs, good_pairs):
    """Distribute the junction Sim(3) mismatch smoothly around the loop.

    The camp-2 hypothesis puts the junction frame at (q_alt, t_alt) with
    depth ratio s_obs; the chain (camp 1) at (m.q[frame], m.t[frame]).  The
    world similarity mapping camp-2 content onto camp 1 is D = (s_obs,
    R_cur^T R_alt, R_cur^T (s_obs t_alt - t_cur)).  Each registered frame
    gets D^{w_f} with w_f = d1 / (d1 + d2), d1 / d2 its BFS hop distances
    from camp 1 / camp 2 over the epipolar-consistent pair graph.  The
    pose graph then refines this initialization (with a per-node scale the
    single cycle has a manifold of exact solutions, and LM would stop at
    the one nearest the weakest cut).  Returns w [F] (nan for unregistered
    frames)."""
    F = m.num_frames
    adj = [[] for _ in range(F)]
    for a, b in good_pairs:
        adj[a].append(b)
        adj[b].append(a)

    def bfs(seeds):
        d = np.full(F, np.inf)
        dq = deque()
        for s in seeds:
            if m.registered[s]:
                d[s] = 0.0
                dq.append(s)
        while dq:
            x = dq.popleft()
            for y in adj[x]:
                if m.registered[y] and d[y] == np.inf:
                    d[y] = d[x] + 1.0
                    dq.append(y)
        return d

    d1 = bfs([int(f) for f in camp1])
    d2 = bfs([int(f) for f in camp2])
    both = np.isfinite(d1) & np.isfinite(d2)
    w = np.full(F, np.nan)
    w[both] = d1[both] / np.maximum(d1[both] + d2[both], 1.0)
    # frames reachable from only one side take that side's correction
    w[np.isfinite(d1) & ~np.isfinite(d2)] = 0.0
    w[~np.isfinite(d1) & np.isfinite(d2)] = 1.0
    w[frame] = 0.0  # the junction frame keeps its camp-1 pose

    q_cur = np.asarray(m.q[frame], np.float64)
    t_cur = np.asarray(m.t[frame], np.float64)
    q_D = G.quat_mul_np(q_cur * np.array([1.0, -1, -1, -1]),
                        np.asarray(q_alt, np.float64))
    R_cur = G.quat_to_rotmat_np(q_cur)
    R_D = G.quat_to_rotmat_np(q_D)
    t_D = R_cur.T @ (s_obs * np.asarray(t_alt, np.float64) - t_cur)
    # the one-parameter subgroup D^w through the Sim(3) log / exp (screw
    # interpolation keeps the screw axis of smoothly accumulated drift)
    sigma_D, omega_D, ups_D = G.sim3_log_np(s_obs, R_D, t_D)
    for f in range(F):
        if not m.registered[f] or not np.isfinite(w[f]) or w[f] <= 0:
            continue
        wf = float(w[f])
        s_s, R_s, t_s = G.sim3_exp_np(wf * sigma_D, wf * omega_D, wf * ups_D)
        Rf = G.quat_to_rotmat_np(m.q[f])
        # world similarity x' = s_s R_s x + t_s => R' = R R_s^T,
        # t' = s_s t - R R_s^T t_s (reprojection-invariant update)
        R_new = Rf @ R_s.T
        m.q[f] = G.rotmat_to_quat_np(R_new)
        m.t[f] = s_s * m.t[f] - R_new @ t_s
    return w


def correct_loop(m: SfMMap, frame: int, q_alt, t_alt, camp2: List[int],
                 opts: ErrorCorrectOptions, *, device):
    """Spread the junction Sim(3) mismatch around the cycle, then refine
    with the full-pose scale pose graph over every registered frame
    (reference: error_corrector.cc:187-246 and ScalePoseGraphUnorder).

    camp2: the matched frames whose epipolar geometry disagrees with the
    current pose, the side the alt hypothesis was located against.  Loop
    edges anchor each hypothesis only to its own camp (current pose ->
    camp-1 neighbours, alt pose -> camp-2 neighbours), as the reference's
    DivideMatchedFrames / AddLoopEdge."""
    camp2_set = set(int(f) for f in camp2)
    neigh_all, _ = m.covisible_frames(frame, min_shared=1)
    camp1 = [int(f) for f in neigh_all if int(f) not in camp2_set][:5]
    if not camp1:
        return False

    # pair graph of epipolar-consistent registered pairs: an edge from an
    # inconsistent pair's current (drifted) relative pose would fight the
    # correction
    cand = [
        (a, b, mt) for a, b, mt in m.pairs
        if a != frame and b != frame
        and m.registered[a] and m.registered[b]
        and len(mt) >= opts.covis_min_shared
    ]
    if not cand:
        return False
    stats = _pair_stats_many(m, cand, opts, device=device)
    good_pairs = [(a, b) for (a, b, _mt), s in zip(cand, stats)
                  if _good_from_stats(s, opts)]
    if not good_pairs:
        return False

    # observed depth ratio between the hypotheses -> loop-edge scale
    # (reference: GetLoopInfo, error_corrector.cc:66-95)
    d_cur = _mean_depth(m, frame, m.q[frame], m.t[frame])
    d_alt = _mean_depth(m, frame, q_alt, t_alt)
    s_obs = max(d_cur, 1e-6) / max(d_alt, 1e-6)

    nodes = [int(f) for f in np.nonzero(m.registered)[0]]
    idx = {f: i for i, f in enumerate(nodes)}
    N = len(nodes)
    fi = idx[frame]

    # measurement edges from the pre-spread map; the corrected frame's own
    # edges are the loop edges below
    pairs = [(idx[a], idx[b]) for a, b in good_pairs]
    e_i, e_j, e_q, e_t, e_ls, e_w = PG.build_edges_from_poses(
        m.q[nodes], m.t[nodes], pairs, [1.0] * len(pairs))

    # loop edges: current hypothesis -> camp 1, alt hypothesis -> camp 2
    camp1_pairs = [(fi, idx[f]) for f in camp1 if f in idx]
    camp2_pairs = [(fi, idx[f]) for f in sorted(camp2_set)
                   if f in idx and m.registered[f]][:5]
    if not camp2_pairs:
        return False
    loop_specs = [(camp1_pairs, m.q[frame].copy(), m.t[frame].copy(), 0.0),
                  (camp2_pairs, q_alt, t_alt, np.log(s_obs))]
    qs = m.q[nodes].copy()
    ts = m.t[nodes].copy()
    for loop_pairs, qf, tf, extra_ls in loop_specs:
        qs[fi], ts[fi] = qf, tf
        li, lj, lq, lt, lls, lw = PG.build_edges_from_poses(
            qs, ts, loop_pairs, [opts.loop_edge_weight] * len(loop_pairs))
        e_i = np.concatenate([e_i, li])
        e_j = np.concatenate([e_j, lj])
        e_q = np.concatenate([e_q, lq])
        e_t = np.concatenate([e_t, lt])
        e_ls = np.concatenate([e_ls, lls + extra_ls])
        e_w = np.concatenate([e_w, lw])

    # keep a rollback copy, then spread the correction as initialization
    q_before = m.q.copy()
    t_before = m.t.copy()
    w_arc = spread_loop_correction(m, frame, q_alt, t_alt, camp1,
                                   sorted(camp2_set), s_obs, good_pairs)
    log_s0 = np.nan_to_num(np.asarray([w_arc[f] for f in nodes], np.float64),
                           nan=0.0) * np.log(max(s_obs, 1e-6))

    # gauge at the most camp1-consistent node (w = 0)
    fixed = np.zeros(N, bool)
    anchor = int(np.argmin([w_arc[f] if np.isfinite(w_arc[f]) else 2.0
                            for f in nodes]))
    fixed[anchor if anchor != fi else (anchor + 1) % N] = True

    prob = PG.PoseGraphProblem.from_numpy(
        device, q=m.q[nodes], t=m.t[nodes], log_s=log_s0, e_i=e_i, e_j=e_j,
        e_rot=e_q, e_trans=e_t, e_logs=e_ls, e_w=e_w, fixed=fixed)
    q_new, t_new, _s, cost, cost0 = (a.cpu().numpy() for a in
                                     PG.solve_pose_graph(prob))
    print(f"[mapper] loop pose graph: N={N} E={len(e_i)} "
          f"cost {float(cost0):.4f} -> {float(cost):.4f}", flush=True)
    if (float(cost) > opts.max_graph_cost_ratio * max(float(cost0), 1e-12)
            and float(cost) > opts.max_graph_cost_per_edge * len(e_i)):
        # the camps cannot be reconciled: roll the spread back
        m.q[:] = q_before
        m.t[:] = t_before
        return False
    m.q[nodes] = np.asarray(q_new, np.float64)
    m.t[nodes] = np.asarray(t_new, np.float64)

    # rebuild the structure under the corrected poses: batched multi-view
    # retriangulation of every track (the reference re-emits each point
    # from its ref-keyframe depth, ba_solver.cc:269-327, which keeps the
    # pre-correction depth error)
    triangulate.retriangulate(m, np.nonzero(m.track_valid[: m.num_tracks])[0],
                              device=device)
    return True


def merge_track_loop(m: SfMMap, frame: int, assoc, camp2) -> int:
    """Fuse duplicate tracks across the loop by keypoint identity
    (reference: MergeTrackLoop, error_corrector.cc:144-185).

    assoc maps the junction frame's keypoints to camp-2 tracks (the
    TryLocate inliers).  The camp-1 partner of the same point is the
    frame's own track, or one hop through the correspondence graph (the
    keypoint's verified match in a camp-1 frame that carries a track).
    Both observe the same point, so the tracks merge without a
    reprojection gate, which could not pass while loop drift remains."""
    camp2_set = set(int(f) for f in camp2)
    csr = m.corr[frame]
    counts = np.diff(csr.offsets)
    p2d_of_row = np.repeat(np.arange(len(counts)), counts)
    rf, rp = csr.other_frame, csr.other_p2d
    row_tid = np.full(len(rf), -1, np.int64)
    camp1_row = np.zeros(len(rf), bool)
    for f2 in np.unique(rf):
        f2i = int(f2)
        sel = rf == f2
        if not m.registered[f2i] or f2i in camp2_set or f2i == frame:
            continue
        camp1_row[sel] = True
        row_tid[sel] = m.track_of[f2i][rp[sel]]
    ok_row = camp1_row & (row_tid >= 0)
    ok_row[ok_row] = m.track_valid[row_tid[ok_row]]
    camp1_of_p2d = {}
    for r in np.nonzero(ok_row)[0]:
        camp1_of_p2d.setdefault(int(p2d_of_row[r]), int(row_tid[r]))

    merged = 0
    for p2d, tid2 in assoc:
        p2d, tid2 = int(p2d), int(tid2)
        if not m.track_valid[tid2]:
            continue
        tid1 = int(m.track_of[frame][p2d])
        if tid1 < 0 or not m.track_valid[tid1]:
            tid1 = camp1_of_p2d.get(p2d, -1)
        if tid1 == tid2:
            continue
        if tid1 >= 0 and m.track_valid[tid1]:
            # the same physical point: union the observations into the
            # camp-2 track (injective per frame)
            for f, p in list(m.track_obs[tid1].items()):
                m.remove_observation(tid1, f, p)
                if m.track_valid[tid2] and f not in m.track_obs[tid2]:
                    m.add_observation(tid2, f, p)
            if m.track_valid[tid1]:
                m.delete_track(tid1)
            merged += 1
        elif frame not in m.track_obs[tid2]:
            m.add_observation(tid2, frame, p2d)
    return merged


def fuse_inconsistent_pair_tracks(m: SfMMap, opts: ErrorCorrectOptions, *,
                                  device) -> int:
    """Fuse tracks bridged by the verified matches of epipolar-inconsistent
    registered pairs: such a pair is a loop bridge the map failed to
    integrate, each side having built its own track for the same point.
    The matches certify point identity independently of the drifted poses,
    so no reprojection gate.  Union-find over track ids (the smaller id is
    the root), then one pass applying each union."""
    todo = []
    for id1, id2, matches in m.pairs:
        if m.registered[id1] and m.registered[id2] and len(matches) >= 8:
            todo.append((id1, id2, matches))
    if not todo:
        return 0
    stats = _pair_stats_many(m, todo, opts, device=device)
    parent = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    n_ext = 0
    for (id1, id2, matches), s in zip(todo, stats):
        if _good_from_stats(s, opts):
            continue
        t1 = m.track_of[id1][matches[:, 0]]
        t2 = m.track_of[id2][matches[:, 1]]
        v1 = (t1 >= 0) & m.track_valid[np.clip(t1, 0, None)]
        v2 = (t2 >= 0) & m.track_valid[np.clip(t2, 0, None)]
        both = v1 & v2 & (t1 != t2)
        for a, b in zip(t1[both], t2[both]):
            union(int(a), int(b))
        # one side trackless: join the tracked side's track
        for k in np.nonzero(v1 & ~v2)[0]:
            tid, f, p = int(t1[k]), int(id2), int(matches[k, 1])
            if f not in m.track_obs[tid] and m.track_of[f][p] < 0:
                m.add_observation(tid, f, p)
                n_ext += 1
        for k in np.nonzero(v2 & ~v1)[0]:
            tid, f, p = int(t2[k]), int(id1), int(matches[k, 0])
            if f not in m.track_obs[tid] and m.track_of[f][p] < 0:
                m.add_observation(tid, f, p)
                n_ext += 1
    if not parent:
        return n_ext
    groups = {}
    for t in list(parent):
        groups.setdefault(find(t), []).append(t)
    merged = 0
    for root, members in groups.items():
        if not m.track_valid[root]:
            continue
        for t in members:
            if t == root or not m.track_valid[t]:
                continue
            for f, p in list(m.track_obs[t].items()):
                m.remove_observation(t, f, p)
                if m.track_valid[root] and f not in m.track_obs[root]:
                    m.add_observation(root, f, p)
            if m.track_valid[t]:
                m.delete_track(t)
            merged += 1
    return merged + n_ext


def check_and_correct_pose(
    m: SfMMap,
    frame: int,
    opts: ErrorCorrectOptions = ErrorCorrectOptions(),
    reg_opts: RegisterOptions = RegisterOptions(),
    tri_opts: triangulate.TriOptions = triangulate.TriOptions(),
    *,
    device,
) -> bool:
    """Detection and correction for a newly registered frame.  Returns True
    if a loop correction was applied."""
    from . import ba_glue

    bad = check_all_relative_pose(m, frame, opts, device=device)
    if not bad:
        return False
    # structural-loop test: a genuine loop error lives in the map, where
    # some registered pair not involving this frame is itself inconsistent;
    # otherwise the frame's own registration is at fault and the
    # reject / retry path handles it
    others = [(a, b, mt) for a, b, mt in m.pairs
              if a != frame and b != frame and len(mt) >= 8
              and m.registered[a] and m.registered[b]]
    if others:
        stats = _pair_stats_many(m, others, opts, device=device)
        if all(_good_from_stats(s, opts) for s in stats):
            return False
    alt = try_locate(m, frame, bad, reg_opts,
                     min_corr=opts.loop_min_correspondences, device=device)
    if alt is None:
        return False
    q_alt, t_alt, assoc = alt
    # the alt hypothesis must satisfy the epipolar geometry of its own camp
    # (a planar-PnP mirror pose can collect reprojection inliers and still
    # be wrong)
    alt_pairs = []
    for pid in m.frame_pairs_of[frame]:
        id1, id2, matches = m.pairs[pid]
        other = id2 if id1 == frame else id1
        if other in bad and len(matches) >= 8:
            alt_pairs.append((id1, id2, matches))
    if alt_pairs:
        stats = _pair_stats_many(m, alt_pairs, opts,
                                 pose_override={frame: (q_alt, t_alt)},
                                 device=device)
        n_ok = sum(1 for s in stats if _good_from_stats(s, opts))
        if n_ok < 0.5 * len(alt_pairs):
            return False
    c_cur = G.pose_center_np(m.q[frame], m.t[frame])
    c_alt = G.pose_center_np(q_alt, t_alt)
    neigh, _counts = m.covisible_frames(frame, min_shared=1)
    baselines = [float(np.linalg.norm(
        G.pose_center_np(m.q[int(f2)], m.t[int(f2)]) - c_cur))
        for f2 in neigh[:8]]
    th = opts.hypothesis_dist_th
    if baselines:
        th = min(th, opts.hypothesis_dist_rel * float(np.median(baselines)))
    if np.linalg.norm(c_cur - c_alt) <= th:
        return False
    dump = os.environ.get("XRSFM_DUMP_CORRECTION_SNAPSHOT")
    if dump:
        SNAP.save_snapshot(m, dump + f".pre.frame{frame}.npz")
        np.savez(dump + f".alt.frame{frame}.npz", q_alt=q_alt, t_alt=t_alt,
                 bad=np.asarray(bad))
    corrected = correct_loop(m, frame, q_alt, t_alt, bad, opts, device=device)
    if corrected:
        # merge duplicates across the loop by keypoint identity (reference:
        # MergeTrackLoop, error_corrector.cc:144-185) plus gate-free fusion
        # through every inconsistent pair's verified matches, so that BA
        # has the cross-loop constraints to leave the drift basin
        n_fused = merge_track_loop(m, frame, assoc, bad)
        n_fused += fuse_inconsistent_pair_tracks(m, opts, device=device)
        triangulate.retriangulate(
            m, np.nonzero(m.track_valid[: m.num_tracks])[0], device=device)
        if dump:
            SNAP.save_snapshot(m, dump + f".frame{frame}.npz")
        # full GBA where the reference runs keyframe GBA (KGBA,
        # error_corrector.cc:230-241), in two rounds: each run_ba restarts
        # the damping, which lets LM leave the high-lambda plateau the
        # pose-graph perturbation parks it on
        reg = [int(f) for f in np.nonzero(m.registered)[0]]
        polish = BAOptions(max_iters=60, huber_px=4.0, precise=True)
        for _round in range(2):
            g1 = ba_glue.run_ba(m, reg, polish, device=device)
        if g1:
            print(f"[mapper] post-correction GBA: {g1.initial_cost:.1f} -> "
                  f"{g1.final_cost:.1f}", flush=True)
        triangulate.filter_tracks(m, None, tri_opts, device=device)
        # with corrected geometry the remaining duplicates pass the
        # ordinary reprojection merge gate: global sweep, then re-solve
        n_fused += triangulate.merge_all_tracks(m, None, tri_opts,
                                                device=device)
        triangulate.retriangulate(
            m, np.nonzero(m.track_valid[: m.num_tracks])[0], device=device)
        print(f"[mapper] loop merge: {n_fused} cross-loop tracks fused",
              flush=True)
        for _round in range(2):
            g2 = ba_glue.run_ba(m, reg, polish, device=device)
        if g2:
            print(f"[mapper] post-sweep GBA: {g2.initial_cost:.1f} -> "
                  f"{g2.final_cost:.1f}", flush=True)
        triangulate.filter_tracks(m, None, tri_opts, device=device)
    return corrected
