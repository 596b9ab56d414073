"""Bridge between the host-side SfMMap and the BA solver (port of
xrsfm_tpu/mapper/ba_glue.py; reference: BASolver::GBA/LBA set-up,
src/optimization/ba_solver.cc:358-638).

Builds an unpadded COO BAProblem for a local or global solve, packs it
camera-major (pack_camera_major) and solves it in the row layout on the
requested device, as the JAX package does; over a device mesh it solves
the COO problem through parallel/dist_ba instead.  Writes the optimized
poses and points back in float64 (and, from an intrinsics-refining solve,
the cameras).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..base.map import SfMMap
from ..optim.ba import BAOptions, BAProblem, pack_camera_major, solve_ba
from ..parallel.dist_ba import solve_distributed
from ..utils import camera as Cam
from ..utils.io_features import bucket
from ..utils.profiling import span


@dataclasses.dataclass
class BAGlueResult:
    frame_ids: np.ndarray
    track_ids: np.ndarray
    initial_cost: float
    final_cost: float
    iters: int
    n_obs: int = 0  # live observations of the solved problem


def _collect(m: SfMMap, opt_frames: Sequence[int], obs_frames=None):
    """Rows of the map's flat COO observation table that the problem
    holds: every live observation of a track seen by an opt frame
    (restricted to obs_frames when given)."""
    n = m.num_obs_slots
    ot = m.obs_track[:n]
    of_ = m.obs_frame[:n]
    op_ = m.obs_p2d[:n]
    live = ot >= 0
    live = live & m.track_valid[np.clip(ot, 0, None)]

    opt_mask = np.zeros(m.num_frames, bool)
    opt_mask[np.asarray(list(opt_frames), np.int64)] = True
    tr_mask = np.zeros(m.num_tracks, bool)
    tr_mask[ot[live & opt_mask[of_]]] = True
    rows = live & tr_mask[np.clip(ot, 0, None)]
    if obs_frames is not None:
        allowed = np.zeros(m.num_frames, bool)
        allowed[np.asarray(list(obs_frames), np.int64)] = True
        rows &= allowed[of_]
    ot, of_, op_ = ot[rows], of_[rows], op_[rows]
    frames = np.unique(
        np.concatenate([of_, np.asarray(list(opt_frames), np.int64)])
    )
    return frames, np.unique(ot), (of_, ot, op_)


def build_problem(
    m: SfMMap,
    opt_frames: Sequence[int],
    device,
    fix_all_poses: bool = False,
    gauge_frames: Optional[Sequence[int]] = None,
    obs_frames: Optional[Sequence[int]] = None,
    freeze_tracks: Optional[np.ndarray] = None,
    freeze_rotations: bool = False,
):
    """Returns (BAProblem, frames, tracks, n_obs), or (None, None, None, 0)
    without observations.  Frames outside opt_frames that observe shared
    tracks enter frozen, as the reference holds non-local frames in LBA
    (ba_solver.cc:358-391); obs_frames restricts which frames contribute
    observations (KGBA: keyframes only, ba_solver.cc:640-678);
    freeze_rotations freezes every rotation (fix_rot), so that a settling
    solve keeps averaged rotations while translations and points re-fit."""
    frames, tracks, (row_f, row_t, row_p) = _collect(m, opt_frames, obs_frames)
    n_obs = len(row_f)
    if n_obs == 0:
        return None, None, None, 0
    nf, nt = len(frames), len(tracks)

    opt_mask = np.zeros(m.num_frames, bool)
    opt_mask[np.asarray(list(opt_frames), np.int64)] = True
    fix_cam = fix_all_poses | ~opt_mask[frames]
    fix_trans = np.zeros(nf, bool)
    obs_cam = np.searchsorted(frames, row_f)
    obs_pt = np.searchsorted(tracks, row_t)
    uv = np.empty((n_obs, 2), np.float32)
    order = np.argsort(row_f, kind="stable")
    rf_s, rp_s = row_f[order], row_p[order]
    starts = np.r_[0, np.nonzero(rf_s[1:] != rf_s[:-1])[0] + 1, n_obs]
    for s, e in zip(starts[:-1], starts[1:]):
        uv[order[s:e]] = m.kps[int(rf_s[s])][rp_s[s:e]]

    # gauge: if nothing is frozen, freeze the first gauge frame fully and
    # the second's translation (reference GBA freezes the init-pair
    # translations, ba_solver.cc:610-614)
    if not fix_all_poses and not np.any(fix_cam):
        fidx = {int(f): i for i, f in enumerate(frames)}
        gf = [int(f) for f in (gauge_frames or []) if int(f) in fidx]
        if len(gf) < 2:
            # the two frames with most observations; counted over the JAX
            # package's padded camera count, so that ties sort alike
            cnts = np.bincount(obs_cam, minlength=bucket(nf, lo=8))
            gf = [int(frames[int(i)]) for i in np.argsort(-cnts)[:2]]
        fix_cam[fidx[gf[0]]] = True
        for f in gf[1:2]:
            fix_trans[fidx[f]] = True

    # intrinsics metadata: one intrinsic block per physical camera
    # (reference GBA frees camera_param per Camera, ba_solver.cc:330-356);
    # read only by intrinsics-refining solves
    cids = m.cam_of_frame[frames]
    uniq, cam_kam = np.unique(cids, return_inverse=True)
    fix_intri = np.ones((nf, 8), bool)
    tie_f = np.zeros(nf, bool)
    for cid in uniq:
        free, tie = Cam.intri_free_mask(m.camera_models[int(cid)][0])
        rows = cids == cid
        fix_intri[rows] = ~free
        tie_f[rows] = tie

    prob = BAProblem.from_numpy(
        device,
        cam_q=m.q[frames],
        cam_t=m.t[frames],
        cam_intri=np.stack([m.cameras[int(m.cam_of_frame[f])] for f in frames]),
        points=m.track_xyz[tracks],
        obs_uv=uv,
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_w=np.ones(n_obs, np.float32),
        fix_cam=fix_cam,
        fix_trans=fix_trans,
        fix_pt=(freeze_tracks[tracks] if freeze_tracks is not None
                else np.zeros(nt, bool)),
        cam_kam=cam_kam,
        fix_intri=fix_intri,
        tie_f=tie_f,
        fix_rot=np.ones(nf, bool) if freeze_rotations else None,
    )
    return prob, frames, tracks, n_obs


def run_ba(
    m: SfMMap,
    opt_frames: Sequence[int],
    opts: BAOptions = BAOptions(),
    fix_all_poses: bool = False,
    obs_frames: Optional[Sequence[int]] = None,
    optimize_intrinsics: bool = False,
    freeze_tracks: Optional[np.ndarray] = None,
    freeze_rotations: bool = False,
    mesh=None,
    *,
    device,
) -> Optional[BAGlueResult]:
    """Build, solve on `device`, write back.  optimize_intrinsics frees the
    camera intrinsics (reference: GBA frees camera_param,
    ba_solver.cc:330-356; LBA pins it :389) and writes the refined
    cameras back through update_camera, which refreshes kps_norm.
    freeze_rotations keeps every rotation: the map's quaternions are not
    written back, so they stay bit for bit (the JAX package writes back
    their float32 round trip).

    The problem is packed camera-major on the host and moved to `device`
    in one transfer, then solved in the row layout (solve_ba with its
    EllIndex).  mesh (parallel.mesh.Mesh of more than one shard): solve
    the COO problem through the observation-sharded LM of
    parallel/dist_ba instead, pose-only or intrinsics-refining, with its
    own schedule (as the JAX package passes it only max_iters and
    huber_px).

    Spans: xrsfm.ba.build (the problem and its pack), then the solve's
    own (xrsfm.ba.solve), xrsfm.ba.fetch (the solved state to the host)
    and xrsfm.ba.writeback (into the map)."""
    gauge = [m.init_id1, m.init_id2] if m.init_id1 >= 0 else []
    on_mesh = mesh is not None and mesh.size > 1
    with span("xrsfm.ba.build"):
        prob, frames, tracks, n_obs = build_problem(
            m, opt_frames, device if on_mesh else "cpu",
            fix_all_poses=fix_all_poses, gauge_frames=gauge,
            obs_frames=obs_frames, freeze_tracks=freeze_tracks,
            freeze_rotations=freeze_rotations,
        )
        if prob is not None and not on_mesh:
            prob, ell = pack_camera_major(prob, device=device)
    if prob is None:
        return None
    if optimize_intrinsics:
        opts = dataclasses.replace(opts, optimize_intrinsics=True)
    if on_mesh:
        stats = {}
        sol, _ = solve_distributed(
            mesh, prob, max_iters=opts.max_iters, huber_px=opts.huber_px,
            stats=stats, optimize_intrinsics=optimize_intrinsics)
        info = stats
    else:
        sol, info = solve_ba(prob, opts, ell)
    with span("xrsfm.ba.fetch"):
        q = sol.cam_q.cpu().numpy().astype(np.float64)
        t = sol.cam_t.cpu().numpy().astype(np.float64)
        pts = sol.points.cpu().numpy().astype(np.float64)
    with span("xrsfm.ba.writeback"):
        upd = ~prob.fix_cam.cpu().numpy()
        fr = frames[upd]
        if not freeze_rotations:
            m.q[fr] = q[upd] / np.linalg.norm(q[upd], axis=1, keepdims=True)
        m.t[fr] = t[upd]
        m.track_xyz[tracks] = pts
        if optimize_intrinsics:
            intri = sol.cam_intri.cpu().numpy().astype(np.float64)
            cids = m.cam_of_frame[frames]
            for cid in np.unique(cids):
                m.update_camera(int(cid), intri[int(np.argmax(cids == cid))])
    return BAGlueResult(
        frame_ids=frames,
        track_ids=tracks,
        initial_cost=info["initial_cost"],
        final_cost=info["final_cost"],
        iters=info["iters"],
        n_obs=int(n_obs),
    )
