"""Track processing: per-frame triangulation, filtering, merging (port of
xrsfm_tpu/mapper/triangulate.py; reference: Point3dProcessor, src/geometry/track_processor.cc —
TriangulateFramePoint :187-251, CreatePoint3d1 :109-161, Filter* :280-349,
MergeTrack(s) :458-618, ContinueFrameTracks :651-680)
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from . import kernels
from ..base.map import SfMMap


@dataclasses.dataclass
class TriOptions:
    tri_px: float = 8.0  # reference: TriangulateFramePoint(8.0)
    filter_px: float = 16.0  # reference: th_rpe_gba default 16
    polish_px: float = 4.0  # tight final-polish threshold (rec_1dsfm uses 4)
    min_angle_deg: float = 1.5  # reference: th_angle defaults
    max_views: int = 16
    min_depth: float = 1e-3
    max_depth: float = 1e3


def _focal(m: SfMMap, frame: int) -> float:
    return float(m.cameras[int(m.cam_of_frame[frame])][0])


def triangulate_frame(m: SfMMap, frame: int, opts: TriOptions = TriOptions(),
                      *, device):
    """Create/extend tracks for the untracked keypoints of a newly
    registered frame.  Returns (n_new_tracks, n_extended)."""
    csr = m.corr[frame]
    focal = _focal(m, frame)
    th = (opts.tri_px / focal) ** 2
    min_angle = np.deg2rad(opts.min_angle_deg)

    # --- vectorized candidate gathering over the frame's CSR rows
    # (replaces a per-keypoint Python loop; the reference iterates
    # per-point in C++, TriangulateFramePoint :187-251)
    track_of_frame = m.track_of[frame]
    rf = csr.other_frame  # [E]
    rp = csr.other_p2d
    counts = np.diff(csr.offsets)
    p2d_of_row = np.repeat(np.arange(len(counts)), counts)

    row_ok = m.registered[rf] & (track_of_frame[p2d_of_row] < 0)
    if m._kp_off is not None and csr.other_gkp is not None:
        tids = np.where(row_ok, m._track_of_flat[csr.other_gkp], -1)
    else:
        tids = np.full(len(rf), -1, np.int64)
        for f2 in np.unique(rf[row_ok]):
            sel = row_ok & (rf == f2)
            tids[sel] = m.track_of[f2][rp[sel]]
    live = row_ok & (tids >= 0)
    live[live] = m.track_valid[tids[live]]

    extend_p2d: List[int] = []
    extend_tid: List[int] = []
    # extension: per untracked p2d with live corr tracks, take the most
    # frequent track id
    if np.any(live):
        pairs = np.stack([p2d_of_row[live], tids[live]], axis=1)
        uniq, cnts = np.unique(pairs, axis=0, return_counts=True)
        order = np.lexsort((-cnts, uniq[:, 0]))
        uniq, cnts = uniq[order], cnts[order]
        first = np.ones(len(uniq), bool)
        first[1:] = uniq[1:, 0] != uniq[:-1, 0]
        extend_p2d = uniq[first, 0].tolist()
        extend_tid = uniq[first, 1].tolist()

    # creation: untracked p2ds with >=1 registered corr row and 0 live ones
    has_live = np.zeros(len(counts), bool)
    if np.any(live):
        has_live[np.unique(p2d_of_row[live])] = True
    create_rows = row_ok & ~has_live[p2d_of_row]
    create_sets: List[List] = []
    if np.any(create_rows):
        cp = p2d_of_row[create_rows]
        cf = rf[create_rows]
        cq = rp[create_rows]
        order = np.argsort(cp, kind="stable")
        cp, cf, cq = cp[order], cf[order], cq[order]
        starts = np.r_[0, np.nonzero(cp[1:] != cp[:-1])[0] + 1, len(cp)]
        for s, e in zip(starts[:-1], starts[1:]):
            obs = [(frame, int(cp[s]))] + [
                (int(cf[k]), int(cq[k])) for k in range(s, e)
            ]
            create_sets.append(obs[: opts.max_views])

    n_ext = _apply_extensions(m, frame, extend_p2d, extend_tid, th, device)
    n_new = _apply_creations(m, create_sets, th, min_angle, opts.max_views,
                             device)
    return n_new, n_ext


def _apply_extensions(m: SfMMap, frame: int, p2ds, tids, th, device) -> int:
    """Continue existing tracks into `frame` when the reprojection fits
    (reference: ContinueTrack, track_processor.cc:426-456)."""
    if not p2ds:
        return 0
    n = len(p2ds)
    q = np.repeat(m.q[frame][None].astype(np.float32), n, axis=0)
    t = np.repeat(m.t[frame][None].astype(np.float32), n, axis=0)
    uv = m.kps_norm[frame][np.asarray(p2ds)]
    xyz = m.track_xyz[np.asarray(tids)].astype(np.float32)
    err, z = kernels.on_device(kernels.reproj_errors_batch, q, t, uv, xyz,
                               device=device)
    ok = (err < th) & (z > 0)
    sel = [
        k for k in np.nonzero(ok)[0]
        if m.track_valid[int(tids[k])] and frame not in m.track_obs[int(tids[k])]
    ]
    if sel:
        m.add_observations(
            np.asarray(tids)[sel], frame, np.asarray(p2ds)[sel]
        )
    return len(sel)


def _apply_creations(m: SfMMap, obs_sets, th, min_angle, max_views,
                     device) -> int:
    """Robustly triangulate new tracks from correspondence sets
    (reference: CreatePoint3d1, track_processor.cc:109-161)."""
    if not obs_sets:
        return 0
    B = len(obs_sets)
    V = max_views
    q = np.zeros((B, V, 4), np.float32)
    q[..., 0] = 1.0
    t = np.zeros((B, V, 3), np.float32)
    uv = np.zeros((B, V, 2), np.float32)
    mask = np.zeros((B, V), bool)
    for i, obs in enumerate(obs_sets):
        for j, (f, p) in enumerate(obs):
            q[i, j] = m.q[f]
            t[i, j] = m.t[f]
            uv[i, j] = m.kps_norm[f][p]
            mask[i, j] = True
    xyz, obs_ok, ok, ang = kernels.on_device(
        kernels.robust_triangulate, q, t, uv, mask, th=th,
        min_angle=min_angle, device=device)
    n_new = 0
    for i, obs in enumerate(obs_sets):
        if not ok[i]:
            continue
        accepted = [
            obs[j] for j in range(len(obs))
            if obs_ok[i, j] and m.track_of[obs[j][0]][obs[j][1]] < 0
        ]
        if len(accepted) < 2:
            continue
        tid = m.new_track(xyz[i])
        m.track_angle[tid] = ang[i]
        for f, p in accepted:
            m.add_observation(tid, f, p)
        n_new += 1
    return n_new


def continue_all_tracks(m: SfMMap, frames=None,
                        opts: TriOptions = TriOptions(), *, device) -> int:
    """Sweep ALL registered frames and continue live tracks into their
    untracked keypoints (reference: ContinueFrameTracks,
    track_processor.cc:651-680 — the reference only continues the NEWLY
    registered frame; this sweep also reaches keypoints whose track was
    created long after their frame registered).

    Decisive at loop anchors: a circuit's junction frame shares ~40
    matches with the far arm, but those target far-field points whose
    tracks formed dozens of frames later — without the backward sweep
    only 7/40 were tracked and the loop anchor never reached the
    registration visibility gate.

    One reprojection-gate device pass for all candidates.  Returns the
    number of observations added."""
    if frames is None:
        frames = np.nonzero(m.registered)[0]
    cand_f: List[np.ndarray] = []
    cand_p: List[np.ndarray] = []
    cand_t: List[np.ndarray] = []
    for f in (int(x) for x in frames):
        csr = m.corr[f]
        if csr is None or len(csr.other_frame) == 0:
            continue
        counts = np.diff(csr.offsets)
        p2d_of_row = np.repeat(np.arange(len(counts)), counts)
        row_ok = (
            m.registered[csr.other_frame]
            & (m.track_of[f][p2d_of_row] < 0)
        )
        if m._kp_off is not None and csr.other_gkp is not None:
            tids = np.where(row_ok, m._track_of_flat[csr.other_gkp], -1)
        else:
            tids = np.full(len(csr.other_frame), -1, np.int64)
            for f2 in np.unique(csr.other_frame[row_ok]):
                sel = row_ok & (csr.other_frame == f2)
                tids[sel] = m.track_of[f2][csr.other_p2d[sel]]
        live = row_ok & (tids >= 0)
        if not np.any(live):
            continue
        live[live] = m.track_valid[tids[live]]
        if not np.any(live):
            continue
        # most frequent live track per untracked keypoint
        pairs = np.stack([p2d_of_row[live], tids[live]], axis=1)
        uniq, cnts = np.unique(pairs, axis=0, return_counts=True)
        order = np.lexsort((-cnts, uniq[:, 0]))
        uniq = uniq[order]
        first = np.ones(len(uniq), bool)
        first[1:] = uniq[1:, 0] != uniq[:-1, 0]
        p2 = uniq[first, 0]
        t2 = uniq[first, 1]
        cand_f.append(np.full(len(p2), f, np.int64))
        cand_p.append(p2)
        cand_t.append(t2)
    if not cand_f:
        return 0
    cf = np.concatenate(cand_f)
    cp = np.concatenate(cand_p)
    ct = np.concatenate(cand_t)
    n = len(cf)
    q = m.q[cf].astype(np.float32)
    t = m.t[cf].astype(np.float32)
    uv = np.zeros((n, 2), np.float32)
    # per-row keypoint fetch (vectorized per frame)
    for f in np.unique(cf):
        sel = cf == f
        uv[sel] = m.kps_norm[int(f)][cp[sel]]
    xyz = m.track_xyz[ct].astype(np.float32)
    err, z = kernels.on_device(kernels.reproj_errors_batch, q, t, uv, xyz,
                               device=device)
    focal = _focal(m, int(cf[0]))
    th = (opts.tri_px / focal) ** 2
    ok = (err < th) & (z > 0)
    added = 0
    for f in np.unique(cf[ok]):
        sel = ok & (cf == f)
        p2, t2 = cp[sel], ct[sel]
        keep = [
            k for k in range(len(p2))
            if m.track_valid[t2[k]]
            and int(f) not in m.track_obs[int(t2[k])]
            and m.track_of[int(f)][p2[k]] < 0
        ]
        if keep:
            m.add_observations(t2[keep], int(f), p2[keep])
            added += len(keep)
    return added


def merge_all_tracks(m: SfMMap, frames=None, opts: TriOptions = TriOptions(),
                     *, device):
    """Merge pass over many frames (reference applies MergeTracks
    per-frame during mapping; a global sweep is used after loop
    correction and in the final polish, when corrected geometry lets
    cross-loop duplicates pass the reprojection gate).  Returns total
    merged."""
    if frames is None:
        frames = np.nonzero(m.registered)[0]
    total = 0
    for f in frames:
        total += merge_frame_tracks(m, int(f), opts, device=device)
    return total


def filter_tracks(m: SfMMap, track_ids=None, opts: TriOptions = TriOptions(),
                  *, device):
    """Drop observations with big reprojection error / bad depth, and
    tracks with tiny triangulation angle (reference: FilterPoints3d,
    track_processor.cc:280-349).  Returns (n_obs_removed, n_tracks_removed).
    """
    # flatten observations from the map's COO table (vectorized)
    n_slots = m.num_obs_slots
    ot = m.obs_track[:n_slots]
    live = (ot >= 0) & m.track_valid[np.clip(ot, 0, None)]
    if track_ids is not None:
        sel_mask = np.zeros(m.num_tracks, bool)
        ids = np.asarray([int(t) for t in track_ids], np.int64)
        if len(ids):
            sel_mask[ids[m.track_valid[ids]]] = True
        live &= sel_mask[np.clip(ot, 0, None)]
    if not np.any(live):
        return 0, 0
    rows = np.stack(
        [ot[live], m.obs_frame[:n_slots][live], m.obs_p2d[:n_slots][live]],
        axis=1,
    ).astype(np.int64)
    track_ids = np.unique(rows[:, 0]).tolist()
    n = len(rows)
    q = m.q[rows[:, 1]].astype(np.float32)
    t = m.t[rows[:, 1]].astype(np.float32)
    # gather normalized keypoints grouped by frame (vectorized)
    uv_rows = np.empty((n, 2), np.float32)
    order = np.argsort(rows[:, 1], kind="stable")
    rf_s = rows[order, 1]
    rp_s = rows[order, 2]
    starts = np.r_[0, np.nonzero(rf_s[1:] != rf_s[:-1])[0] + 1, n]
    for s, e in zip(starts[:-1], starts[1:]):
        uv_rows[order[s:e]] = m.kps_norm[int(rf_s[s])][rp_s[s:e]]
    xyz = m.track_xyz[rows[:, 0]].astype(np.float32)
    err, z = kernels.on_device(kernels.reproj_errors_batch, q, t, uv_rows,
                               xyz, device=device)
    per_frame_focal = np.array([_focal(m, int(f)) for f in rows[:, 1]])
    th = (opts.filter_px / per_frame_focal) ** 2
    bad = (err > th) | (z < opts.min_depth) | (z > opts.max_depth)
    n_rm = 0
    for k in np.nonzero(bad)[0]:
        tid, f, p = int(rows[k, 0]), int(rows[k, 1]), int(rows[k, 2])
        if m.track_valid[tid] and m.track_obs[tid].get(f) == p:
            m.remove_observation(tid, f, p)
            n_rm += 1
    # update stored error stat (one bincount pass instead of a
    # per-track scan over the observation rows).  track_error is in
    # PIXELS (COLMAP's Point3D error convention; retriangulate's
    # min_error_px gate reads it) — err is squared-normalized, so scale
    # by focal^2 before averaging.
    good = ~bad
    if np.any(good):
        gt = rows[good, 0]
        err_px2 = err * per_frame_focal**2
        sums = np.bincount(gt, weights=err_px2[good], minlength=m.num_tracks)
        cnts = np.bincount(gt, minlength=m.num_tracks)
        upd = (cnts > 0) & m.track_valid[: m.num_tracks]
        m.track_error[: m.num_tracks][upd] = np.sqrt(
            sums[upd] / cnts[upd]
        )
    n_tr = sum(1 for tid in track_ids if not m.track_valid[tid])
    return n_rm, n_tr


def retriangulate(m: SfMMap, track_ids=None, opts: TriOptions = TriOptions(),
                  min_error_px: float = 2.0, *, device):
    """Re-triangulate high-error tracks from their observations under the
    current poses (reference: Point3dProcessor::ReTriangulate,
    track_processor.cc:373-424).  Returns number of updated tracks."""
    if track_ids is None:
        track_ids = np.nonzero(
            m.track_valid[: m.num_tracks]
            & (m.track_error[: m.num_tracks] > min_error_px)
        )[0]
    track_ids = [int(t) for t in track_ids if m.track_valid[t]]
    if not track_ids:
        return 0
    V = opts.max_views
    B = len(track_ids)
    q = np.zeros((B, V, 4), np.float32)
    q[..., 0] = 1.0
    t = np.zeros((B, V, 3), np.float32)
    uv = np.zeros((B, V, 2), np.float32)
    msk = np.zeros((B, V), bool)
    for i, tid in enumerate(track_ids):
        obs = list(m.track_obs[tid].items())
        if len(obs) > V:
            # spread the view selection across the whole track: the
            # extreme observations carry the baseline that removes the
            # low-parallax depth bias (taking the first V would re-fit
            # from the same short window the point was created with)
            sel = np.unique(
                np.round(np.linspace(0, len(obs) - 1, V)).astype(int)
            )
            obs = [obs[k] for k in sel]
        for j, (f, p) in enumerate(obs):
            q[i, j] = m.q[f]
            t[i, j] = m.t[f]
            uv[i, j] = m.kps_norm[f][p]
            msk[i, j] = True
    focal = _focal(m, int(m.obs_frame[0]) if m.num_obs_slots else 0)
    th = (opts.tri_px / focal) ** 2
    xyz, obs_ok, ok, ang = kernels.on_device(
        kernels.robust_triangulate, q, t, uv, msk, th=th,
        min_angle=float(np.deg2rad(opts.min_angle_deg)), device=device)
    updated = 0
    for i, tid in enumerate(track_ids):
        if ok[i]:
            m.track_xyz[tid] = xyz[i]
            m.track_angle[tid] = ang[i]
            updated += 1
    return updated


def merge_frame_tracks(m: SfMMap, frame: int, opts: TriOptions = TriOptions(),
                       *, device):
    """Merge track pairs bridged by a correspondence of `frame`
    (reference: MergeTracks, track_processor.cc:520-618).  A merge is
    accepted when every observation of the union reprojects under the
    threshold at the observation-count-weighted mean position."""
    # vectorized candidate collection over the frame's CSR rows (the
    # reference walks per-keypoint, MergeTracks track_processor.cc:520)
    csr = m.corr[frame]
    if csr is None:  # maps loaded from COLMAP bins carry no match graph
        return 0
    counts = np.diff(csr.offsets)
    p2d_of_row = np.repeat(np.arange(len(counts)), counts)
    tid1 = m.track_of[frame][p2d_of_row]  # [E]
    rf, rp = csr.other_frame, csr.other_p2d
    if m._kp_off is not None and csr.other_gkp is not None:
        tid2 = m._track_of_flat[csr.other_gkp]
    else:
        tid2 = np.full(len(rf), -1, np.int64)
        for f2 in np.unique(rf):
            sel = rf == f2
            tid2[sel] = m.track_of[f2][rp[sel]]
    valid = (
        (tid1 >= 0) & (tid2 >= 0) & (tid1 != tid2)
        & m.track_valid[np.clip(tid1, 0, None)]
        & m.track_valid[np.clip(tid2, 0, None)]
    )
    lo = np.minimum(tid1[valid], tid2[valid])
    hi = np.maximum(tid1[valid], tid2[valid])
    cand = np.unique(np.stack([lo, hi], axis=1), axis=0) if len(lo) else []
    # all candidate merges in one device check (V observation slots each)
    V = 32
    cand_list = [
        (int(t1), int(t2)) for t1, t2 in cand
        if len(m.track_obs[int(t1)]) + len(m.track_obs[int(t2)]) <= V
    ]
    if not cand_list:
        return 0
    B = len(cand_list)
    q = np.zeros((B, V, 4), np.float32)
    q[..., 0] = 1.0
    t = np.zeros((B, V, 3), np.float32)
    uv = np.zeros((B, V, 2), np.float32)
    xyzs = np.zeros((B, V, 3), np.float32)
    msk = np.zeros((B, V), bool)
    merged_xyz = np.zeros((B, 3))
    obs_unions = []
    for k, (t1, t2) in enumerate(cand_list):
        o1, o2 = m.track_obs[t1], m.track_obs[t2]
        n1, n2 = len(o1), len(o2)
        xyz = (m.track_xyz[t1] * n1 + m.track_xyz[t2] * n2) / (n1 + n2)
        merged_xyz[k] = xyz
        obs = list(o1.items()) + [(f, p) for f, p in o2.items() if f not in o1]
        obs_unions.append(obs)
        for j, (f, p) in enumerate(obs[:V]):
            q[k, j] = m.q[f]
            t[k, j] = m.t[f]
            uv[k, j] = m.kps_norm[f][p]
            xyzs[k, j] = xyz
            msk[k, j] = True
    err, z = kernels.on_device(
        kernels.reproj_errors_batch, q.reshape(-1, 4), t.reshape(-1, 3),
        uv.reshape(-1, 2), xyzs.reshape(-1, 3), device=device)
    err = err.reshape(B, V)
    z = z.reshape(B, V)
    focal = _focal(m, frame)
    th = (opts.tri_px / focal) ** 2
    ok = np.all(np.where(msk, (err < th) & (z > 0), True), axis=1)

    merged = 0
    for k, (t1, t2) in enumerate(cand_list):
        if not ok[k] or not (m.track_valid[t1] and m.track_valid[t2]):
            continue
        o2 = m.track_obs[t2]
        for f, p in list(o2.items()):
            m.remove_observation(t2, f, p)
            if m.track_valid[t1] and f not in m.track_obs[t1]:
                m.add_observation(t1, f, p)
        if m.track_valid[t2]:
            m.delete_track(t2)
        m.track_xyz[t1] = merged_xyz[k]
        merged += 1
    return merged
