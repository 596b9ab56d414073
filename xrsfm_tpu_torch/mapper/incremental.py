"""The incremental SfM main loop (port of xrsfm_tpu/mapper/incremental.py;
reference: IncrementalMapper::Reconstruct,
src/mapper/incremental_mapper.cc:6-98: init pair, GBA, then per frame:
select next, register, triangulate, filter, merge, LBA, periodic KGBA).

The outer loop is host Python, since the next frame depends on the map
state (SURVEY.md §7.3); every numeric step inside is a batched call on
the mapper's device.  The port covers BA on one device, pose-only or
intrinsics-refining (refine_intrinsics, the 1DSfM regime), with loop
correction (correct_pose, mapper/error_correct) and the trial-gated
global pose polish (global_polish / rot_avg_polish, optim/global_pose and
optim/rot_avg, followed by a resurrection round for frames that failed
against the drifted map), with snapshots every snapshot_every
registrations (base/snapshot) and resumption from a restored map.  With
n_devices > 1 (or a mesh given), the main KGBA and the polish GBA shard
their observations over a device mesh (parallel/dist_ba); LBA and the
intrinsics warm-ups stay on one device, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import ba_glue, error_correct as EC, initialize, keyframe as KF
from . import register, triangulate
from ..base import snapshot as SNAP
from ..base.map import SfMMap
from ..device import resolve_device
from ..optim import global_pose, rot_avg
from ..optim.ba import BAOptions
from ..parallel.mesh import make_mesh
from ..utils import geometry as G


@dataclasses.dataclass
class MapperOptions:
    init: initialize.InitOptions = dataclasses.field(
        default_factory=initialize.InitOptions
    )
    reg: register.RegisterOptions = dataclasses.field(
        default_factory=register.RegisterOptions
    )
    tri: triangulate.TriOptions = dataclasses.field(
        default_factory=triangulate.TriOptions
    )
    # drift/loop error correction (reference: correct_pose option,
    # incremental_mapper.h:14-24; enabled for KITTI)
    correct_pose: bool = False
    lba_iters: int = 5
    gba_iters: int = 20
    lba_frames: int = 5  # covisibility neighbours included in LBA
    gba_growth: float = 1.2  # periodic GBA trigger (incremental_mapper.cc:77)
    # rotation-averaging polish before the final GBA (optim/rot_avg); off
    # by default: on sequential scenes the 2-view measurement bias
    # accumulates over the chain to worse than the map's own drift
    rot_avg_polish: bool = False
    # full global pose polish (rotation averaging + robust translation
    # recovery, optim/global_pose); supersedes rot_avg_polish
    global_polish: bool = False
    stop_when_register_fail: bool = False
    min_visible: int = 20
    # last-resort visibility floor for frames reachable through a single
    # pair (the reference's TryLocate registers from 12, pnp.cc:133-168)
    min_visible_floor: int = 12
    # free the camera intrinsics in global BA (reference: GBA frees
    # camera_param, ba_solver.cc:330-356; LBA pins it :389); rec_1dsfm
    # turns it on (noisy per-image EXIF focals, rec_1dsfm.cc:46-55)
    refine_intrinsics: bool = False
    # register up to this many covisibility-ready frames per outer
    # iteration in one batched pass (1 = sequential, as the reference)
    batch_registration: int = 8
    # shard global BA over this many devices (parallel/dist_ba)
    n_devices: int = 1
    init_id1: int = -1
    init_id2: int = -1
    verbose: bool = True
    # save a snapshot (base/snapshot) to snapshot_path every N accepted
    # registrations (0 = never)
    snapshot_every: int = 0
    snapshot_path: str = ""
    # stop after N successful registrations (0 = unlimited)
    max_registrations: int = 0


def polish_backup(m: SfMMap):
    """Snapshot of every piece of map state the global-polish trial can
    change: poses (the rewrite), structure (retriangulation, GBA) and
    cameras (with kps_norm through update_camera on restore).  The trial
    adds and removes no observation and leaves the registered flags, so a
    restore is bit-identical over the whole map state."""
    nt = m.num_tracks
    return (
        nt,
        m.q.copy(), m.t.copy(),
        m.track_xyz[:nt].copy(), m.track_valid[:nt].copy(),
        m.track_error[:nt].copy(), m.track_angle[:nt].copy(),
        {cid: np.array(p) for cid, p in m.cameras.items()},
    )


def polish_restore(m: SfMMap, backup):
    nt, q_b, t_b, xyz_b, val_b, err_b, ang_b, cams_b = backup
    m.q[:] = q_b
    m.t[:] = t_b
    m.track_xyz[:nt] = xyz_b
    m.track_valid[:nt] = val_b
    m.track_error[:nt] = err_b
    m.track_angle[:nt] = ang_b
    for cid, params in cams_b.items():
        m.update_camera(cid, params)


@dataclasses.dataclass
class MapperStats:
    registered: int = 0
    failed: int = 0
    tracks: int = 0
    corrections: int = 0
    time_init: float = 0.0
    time_select: float = 0.0
    time_register: float = 0.0
    time_consistency: float = 0.0
    time_triangulate: float = 0.0
    time_filter: float = 0.0
    time_check: float = 0.0
    time_merge: float = 0.0
    time_lba: float = 0.0
    time_gba: float = 0.0
    time_total: float = 0.0
    # the global pose polish of the last round: "off" (not requested or
    # under 10 frames), "skipped" (its gates declined), "kept", "reverted"
    polish: str = "off"


class IncrementalMapper:
    def __init__(self, opts: MapperOptions = MapperOptions(), *, device,
                 mesh=None):
        """The global solves run on `mesh` (parallel.mesh.Mesh, e.g.
        several shards on one device), else on the first opts.n_devices
        devices of `device`'s type (raises when fewer exist), else on
        `device` alone."""
        self.opts = opts
        self.device = resolve_device(device)
        if mesh is None and opts.n_devices > 1:
            mesh = make_mesh(opts.n_devices, self.device)
        self.mesh = mesh
        self.stats = MapperStats()
        self._rejections = {}
        self._intri_gba_warm = False

    def _log(self, msg: str):
        if self.opts.verbose:
            print(f"[mapper] {msg}", flush=True)

    def reconstruct(self, m: SfMMap) -> bool:
        o = self.opts
        dev = self.device
        t_start = time.time()
        n_reg0 = int(np.count_nonzero(m.registered))
        if m.init_id1 >= 0 and n_reg0 >= 2:
            # resumed from a snapshot: the map is initialized already
            self._log(f"resuming with {n_reg0} registered frames")
        else:
            if not initialize.find_and_initialize(m, o.init, o.init_id1,
                                                  o.init_id2, device=dev):
                self._log("initialization failed")
                return False
            self._log(f"initialized with pair ({m.init_id1}, {m.init_id2}), "
                      f"{m.num_tracks} tracks")
            ba_glue.run_ba(m, [m.init_id1, m.init_id2],
                           BAOptions(max_iters=o.gba_iters, huber_px=4.0),
                           device=dev)
        self.stats.time_init = time.time() - t_start

        # growth and polish, with one resurrection round: after a global
        # pose rewrite, frames that failed at drift junctions register
        # against the polished map
        for growth_round in range(2):
            self._grow(m, max(2, n_reg0))
            rotated = self._final_polish(m)
            fresh = (~m.registered) & m.registered_fail
            if growth_round == 0 and rotated and np.count_nonzero(fresh):
                self._log(f"resurrection round: "
                          f"{int(np.count_nonzero(fresh))} failed frames "
                          f"retried against the polished map")
                self._post_correction_amnesty(m)
                continue
            break

        self.stats.tracks = int(np.count_nonzero(m.track_valid))
        self.stats.time_total = time.time() - t_start
        s = self.stats
        tracked = (
            s.time_init + s.time_select + s.time_register
            + s.time_consistency + s.time_triangulate + s.time_filter
            + s.time_check + s.time_merge + s.time_lba + s.time_gba
        )
        self._log(
            f"done: {int(np.count_nonzero(m.registered))} registered, "
            f"{s.tracks} tracks, {s.time_total:.1f}s "
            f"(init {s.time_init:.1f} sel {s.time_select:.1f} "
            f"reg {s.time_register:.1f} con {s.time_consistency:.1f} "
            f"tri {s.time_triangulate:.1f} fil {s.time_filter:.1f} "
            f"mrg {s.time_merge:.1f} chk {s.time_check:.1f} "
            f"lba {s.time_lba:.1f} gba {s.time_gba:.1f} "
            f"other {s.time_total - tracked:.1f})"
        )
        return True

    def _correct(self, m: SfMMap, frame: int) -> bool:
        """check_and_correct_pose for `frame`, timed; counts a correction
        and grants the amnesty after one."""
        o = self.opts
        t0 = time.time()
        corrected = EC.check_and_correct_pose(
            m, frame, reg_opts=o.reg, tri_opts=o.tri, device=self.device)
        if corrected:
            self._log(f"frame {frame}: loop error corrected")
            self.stats.corrections += 1
            self._post_correction_amnesty(m)
        self.stats.time_check += time.time() - t0
        return corrected

    def _grow(self, m: SfMMap, num_reg_at_gba: int):
        """Register, triangulate, filter and merge frames batch by batch,
        with LBA per batch, KGBA whenever the map grew by gba_growth since
        num_reg_at_gba registered frames, and a snapshot every
        snapshot_every registrations."""
        o = self.opts
        dev = self.device
        stop = False
        while not stop:
            t0 = time.time()
            reg_opts = o.reg
            batch = m.ready_frames(o.min_visible,
                                   max_batch=max(1, o.batch_registration))
            if len(batch) == 0 and o.min_visible > o.min_visible_floor:
                # last resort: the single best frame with the relaxed
                # floor; the consistency gate and the bounded retry
                # counter reject bad poses (reference analogue: TryLocate
                # registers from 12 correspondences, pnp.cc:133-168)
                batch = m.ready_frames(o.min_visible_floor, max_batch=1)
                if len(batch):
                    reg_opts = dataclasses.replace(
                        o.reg, min_correspondences=o.min_visible_floor)
            self.stats.time_select += time.time() - t0
            if len(batch) == 0:
                break
            t0 = time.time()
            results = register.register_frames_batch(
                m, batch, reg_opts, seed_salts=self._rejections, device=dev)
            self.stats.time_register += time.time() - t0

            accepted = []
            for nxt in (int(f) for f in batch):
                ok, n_inl, n_cand = results[nxt]
                if not ok:
                    # retry later rather than blacklisting on the first
                    # failure: a frontier frame often registers once its
                    # successors add tracks
                    self._rejections[nxt] = self._rejections.get(nxt, 0) + 1
                    if self._rejections[nxt] >= 3:
                        m.registered_fail[nxt] = True
                        self.stats.failed += 1
                    self._log(f"register frame {nxt} FAILED ({n_inl}/{n_cand} "
                              f"inliers, attempt {self._rejections[nxt]})")
                    if o.stop_when_register_fail and m.registered_fail[nxt]:
                        stop = True
                        break
                    continue
                t0 = time.time()
                consistent = EC.registration_is_consistent(m, nxt, device=dev)
                self.stats.time_consistency += time.time() - t0
                checked_correction = False
                if not consistent and o.correct_pose:
                    # an epipolar-inconsistent pose at a well-matched frame
                    # is the loop-closure signature: correct the map
                    # (reference: CheckAndCorrectPose,
                    # error_corrector.cc:187-246) rather than drop the frame
                    if self._correct(m, nxt):
                        consistent = True
                    else:
                        t0 = time.time()
                        consistent = EC.registration_is_consistent(
                            m, nxt, device=dev)
                        self.stats.time_check += time.time() - t0
                    checked_correction = True
                if not consistent:
                    # planar-PnP ambiguity / bad registration: undo; retry
                    # once later, then fail
                    m.deregister_frame(nxt)
                    self._rejections[nxt] = self._rejections.get(nxt, 0) + 1
                    if self._rejections[nxt] >= 2:
                        m.registered_fail[nxt] = True
                        self.stats.failed += 1
                    self._log(f"register frame {nxt} REJECTED (epipolar-"
                              f"inconsistent pose, attempt "
                              f"{self._rejections[nxt]})")
                    if o.stop_when_register_fail and m.registered_fail[nxt]:
                        stop = True
                        break
                    continue
                self.stats.registered += 1
                if o.correct_pose and not checked_correction:
                    self._correct(m, nxt)

                t0 = time.time()
                n_new, n_ext = triangulate.triangulate_frame(m, nxt, o.tri,
                                                             device=dev)
                self.stats.time_triangulate += time.time() - t0

                t0 = time.time()
                tri_ids = [int(t) for t in np.unique(m.track_of[nxt]) if t >= 0]
                triangulate.filter_tracks(m, tri_ids, o.tri, device=dev)
                self.stats.time_filter += time.time() - t0

                t0 = time.time()
                n_merged = triangulate.merge_frame_tracks(m, nxt, o.tri,
                                                          device=dev)
                self.stats.time_merge += time.time() - t0
                accepted.append(nxt)
                self._log(f"frame {nxt}: +{n_new} tracks, {n_ext} extended, "
                          f"{n_merged} merged, {results[nxt][1]} pnp inliers")
                if (o.max_registrations
                        and self.stats.registered >= o.max_registrations):
                    stop = True
                    break

            if accepted:
                self._refresh_and_lba(m, accepted)

            n_reg = int(np.count_nonzero(m.registered))
            if accepted:
                self._log(f"batch of {len(batch)}: {len(accepted)} accepted, "
                          f"reg {n_reg}")
            if n_reg >= o.gba_growth * num_reg_at_gba:
                t0 = time.time()
                if o.refine_intrinsics and not self._intri_gba_warm:
                    # graduated non-convexity for the first intrinsics
                    # GBA: with EXIF-grade focal errors most residuals lie
                    # beyond the Huber knee and LM stalls on a plateau, so
                    # one wide-knee pass precedes the robust solve
                    self._intri_gba_warm = True
                    KF.kgba(m, BAOptions(max_iters=o.gba_iters, huber_px=32.0),
                            tri_opts=None, optimize_intrinsics=True,
                            device=dev)
                gres = KF.kgba(m, BAOptions(max_iters=o.gba_iters, huber_px=4.0),
                               tri_opts=o.tri,
                               optimize_intrinsics=o.refine_intrinsics,
                               mesh=self.mesh, device=dev)
                self.stats.time_gba += time.time() - t0
                num_reg_at_gba = n_reg
                if gres is not None:
                    self._log(f"KGBA over {n_reg} frames: cost "
                              f"{gres.initial_cost:.1f} -> {gres.final_cost:.1f}")
                if o.refine_intrinsics:
                    # refined cameras invalidate registration failures
                    # judged under the old intrinsics
                    self._post_correction_amnesty(m)
            if (o.snapshot_every and o.snapshot_path and accepted
                    and self.stats.registered % o.snapshot_every
                    < len(accepted)):
                SNAP.save_snapshot(m, o.snapshot_path)
            if o.max_registrations and self.stats.registered >= o.max_registrations:
                self._log(f"stopping after {self.stats.registered} "
                          f"registrations (max_registrations)")
                stop = True

    def _refresh_and_lba(self, m: SfMMap, accepted):
        """Re-triangulate the low-parallax tracks of the accepted frames
        from the spread of their observations (reference: ReTriangulate,
        track_processor.cc:373-424), then one LBA over the union of their
        local bundles."""
        o = self.opts
        dev = self.device
        t0 = time.time()
        fresh = set()
        for nxt in accepted:
            t_ids = m.track_of[nxt]
            t_ids = t_ids[t_ids >= 0]
            fresh.update(int(t) for t in t_ids[m.track_angle[t_ids]
                                               < np.deg2rad(10.0)])
        if fresh:
            triangulate.retriangulate(m, sorted(fresh), o.tri, device=dev)
        self.stats.time_triangulate += time.time() - t0

        t0 = time.time()
        local = []
        seen = set()
        for nxt in accepted:
            for f in self._local_frames(m, nxt):
                if f not in seen:
                    seen.add(f)
                    local.append(f)
        # LBA bounded like the reference's SetUpLBA (ba_solver.cc:358-391):
        # residuals from local frames only, points frozen unless newly
        # observed and still poorly triangulated (below 5 degrees)
        nt = m.num_tracks
        far = m.track_angle[:nt] > np.deg2rad(5.0)
        new_obs = np.zeros(nt, bool)
        for nxt in accepted:
            t_ids = m.track_of[nxt]
            new_obs[t_ids[t_ids >= 0]] = True
        ba_glue.run_ba(m, local, BAOptions(max_iters=o.lba_iters, huber_px=4.0),
                       obs_frames=local, freeze_tracks=far | ~new_obs,
                       device=dev)
        self.stats.time_lba += time.time() - t0

    def _polish_gba_rounds(self, m: SfMMap, reg_frames, tag: str, hard: bool,
                           schedule_intrinsics: bool = False):
        """Polish GBA; after loop corrections or a pose rewrite ("hard")
        two rounds, since each run_ba restarts the damping, which lets LM
        leave the high-lambda plateau the perturbation parks it on.
        schedule_intrinsics first runs one wide-knee and two robust
        intrinsics GBAs, so that late cameras' intrinsics can still reach
        the global basin (each restart of the damping escapes a plateau of
        the slow focal / k1 directions)."""
        o = self.opts
        if schedule_intrinsics:
            for huber in (32.0, 4.0, 4.0):
                ba_glue.run_ba(m, reg_frames,
                               BAOptions(max_iters=o.gba_iters, huber_px=huber),
                               optimize_intrinsics=True, device=self.device)
        polish = BAOptions(max_iters=2 * o.gba_iters, huber_px=4.0,
                           precise=hard)
        pres = None
        for r in range(2 if hard else 1):
            pres = ba_glue.run_ba(m, reg_frames, polish,
                                  optimize_intrinsics=o.refine_intrinsics,
                                  mesh=self.mesh, device=self.device)
            if pres is not None:
                self._log(f"polish GBA {tag} round {r}: cost "
                          f"{pres.initial_cost:.1f} -> {pres.final_cost:.1f}")
        return pres

    def _final_polish(self, m: SfMMap) -> bool:
        """GBA -> (trial-gated global pose rewrite -> retriangulation ->
        GBA) -> tight filter -> merge sweep -> retriangulate -> GBA -> tight
        filter.  Returns True if a pose rewrite was kept."""
        o = self.opts
        dev = self.device
        reg_frames = list(np.nonzero(m.registered)[0])
        if len(reg_frames) < 2:
            return False
        t0 = time.time()
        want_polish = ((o.global_polish or o.rot_avg_polish)
                       and len(reg_frames) >= 10)
        hard = self.stats.corrections > 0 or want_polish
        self.stats.polish = "off"
        # Trial-gated rewrite: the measured-pair fixed point is set by
        # 2-view measurement noise, and on a map already better than that
        # it degrades the geometry.  Settle the current basin (cost_pre),
        # try the rewrite and settle it (cost_post), keep the lower robust
        # cost per observation.
        pres_pre = self._polish_gba_rounds(
            m, reg_frames, "pre", hard=self.stats.corrections > 0)
        cost_pre = (pres_pre.final_cost / max(pres_pre.n_obs, 1)
                    if pres_pre else None)
        rotated = False
        if want_polish:
            backup = polish_backup(m)
            if o.global_polish:
                rotated = global_pose.global_pose_polish(m, log=self._log,
                                                         device=dev)
            else:
                rotated = rot_avg.rotation_averaging_polish(m, log=self._log,
                                                            device=dev)
            self.stats.polish = "kept" if rotated else "skipped"
        if rotated:
            # retriangulate every valid track: after a global rewrite all
            # stored positions and errors refer to the old geometry
            triangulate.retriangulate(
                m, np.nonzero(m.track_valid[: m.num_tracks])[0], o.tri,
                device=dev)
            # the rewrite invalidates the intrinsics basin: the post side
            # re-runs the intrinsics schedule
            pres_post = self._polish_gba_rounds(
                m, reg_frames, "post", hard=hard,
                schedule_intrinsics=o.refine_intrinsics)
            cost_post = (pres_post.final_cost / max(pres_post.n_obs, 1)
                         if pres_post else None)
            # observation-loss guard: the post-rewrite retriangulation drops
            # poorly fitting tracks, so cost_post averages over survivors;
            # cap the shrinkage the comparison may ride on
            obs_shrunk = (pres_pre is not None and pres_post is not None
                          and pres_post.n_obs < 0.97 * pres_pre.n_obs)
            if (cost_pre is not None and cost_post is not None
                    and (cost_post >= cost_pre * 0.995 or obs_shrunk)):
                polish_restore(m, backup)
                rotated = False
                self.stats.polish = "reverted"
                why = (f"observation set shrank {pres_pre.n_obs} -> "
                       f"{pres_post.n_obs}"
                       if obs_shrunk and cost_post < cost_pre * 0.995
                       else "the map beats the measured-edge fixed point")
                self._log(f"global polish REVERTED: cost/obs "
                          f"{cost_post:.4f} vs {cost_pre:.4f} pre - {why}")
        tight = dataclasses.replace(o.tri, filter_px=o.tri.polish_px)
        triangulate.filter_tracks(m, None, tight, device=dev)
        # global merge sweep: duplicates that survived mapping (the two
        # camps of a closed loop) pass the gate once GBA settled the map
        triangulate.merge_all_tracks(m, None, o.tri, device=dev)
        n_rt = triangulate.retriangulate(m, None, o.tri, device=dev)
        fres = ba_glue.run_ba(
            m, reg_frames, BAOptions(max_iters=o.gba_iters, huber_px=2.0),
            optimize_intrinsics=o.refine_intrinsics, device=dev)
        if fres is not None:
            self._log(f"polish GBA final: cost {fres.initial_cost:.1f} -> "
                      f"{fres.final_cost:.1f}")
        triangulate.filter_tracks(m, None, tight, device=dev)
        self.stats.time_gba += time.time() - t0
        if n_rt:
            self._log(f"final polish: {n_rt} tracks retriangulated")
        return rotated

    def _post_correction_amnesty(self, m: SfMMap):
        """After a loop correction or pose rewrite, frames that failed
        against the old (drifted) map get fresh attempts."""
        fresh = (~m.registered) & m.registered_fail
        n = int(np.count_nonzero(fresh))
        if n:
            m.registered_fail[fresh] = False
            for f in np.nonzero(fresh)[0]:
                self._rejections.pop(int(f), None)
            self._log(f"correction amnesty: {n} failed frames retryable")

    def _local_frames(self, m: SfMMap, frame: int):
        """Local bundle: the frame and covisible neighbours chosen for
        covisibility and baseline (reference: FindLocalBundle,
        ba_solver.cc:393-521).  Half the slots go to the nearest
        neighbours, half to the most distant well-covisible frames (camera
        distance as the angle proxy), so that the bundle can observe
        forward-motion scale drift."""
        neigh, cnt = m.covisible_frames(frame)
        k = self.opts.lba_frames
        neigh = [int(f) for f in neigh]
        if len(neigh) <= k:
            return [frame] + neigh
        n_near = max(1, k // 2)
        local = [frame] + neigh[:n_near]
        cand = [
            f for f, c in zip(neigh[n_near:], cnt[n_near:])
            if c >= 0.25 * int(cnt[0])
        ]
        if cand:
            c0 = G.pose_center_np(m.q[frame], m.t[frame])
            cc = np.stack([G.pose_center_np(m.q[f], m.t[f]) for f in cand])
            d = np.linalg.norm(cc - c0, axis=1)
            for j in np.argsort(-d)[: k - n_near]:
                local.append(cand[int(j)])
        for f in neigh[n_near:]:
            if len(local) >= k + 1:
                break
            if f not in local:
                local.append(f)
        return local
