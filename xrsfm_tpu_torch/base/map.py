"""Host-side reconstruction state: frames, tracks, correspondence graph
(host numpy copy of xrsfm_tpu/base/map.py; undistortion goes through the
port's own utils/camera, and `SfMMap.from_state` carries a map state over
from the JAX package).

A re-design of the reference's mutable ``Map``
(reference: src/base/map.h:116-195, src/base/map.cc).  The reference keeps
bidirectional pointers (Track.observations_ <-> Frame.track_ids_) and scans
them with per-point loops; here the same state is SoA numpy with a CSR
correspondence graph so every query used by the incremental loop
(correspondence search, next-frame scoring, covisibility) is a vectorized
gather, and the numeric kernels (RANSAC, triangulation, BA) consume padded
device arrays built from these tables.

Host/device split (SURVEY.md §7.3): graph bookkeeping stays in numpy on the
host, as it is cheap and irregular; all O(points x hypotheses) math runs on
the device.  Host->device transfer per step is O(touched frame), not O(map).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import camera as Cam


@dataclasses.dataclass
class CorrCSR:
    """Per-frame correspondence graph in CSR form.

    For frame f: correspondences of keypoint p are
    (other_frame[offsets[p]:offsets[p+1]], other_p2d[offsets[p]:offsets[p+1]]).
    (reference: CorrespondenceGraph, src/base/map.h:101-114)
    """

    offsets: np.ndarray  # [Ni + 1] int64
    other_frame: np.ndarray  # [E] int32
    other_p2d: np.ndarray  # [E] int32
    # global keypoint index kp_off[other_frame] + other_p2d, filled in by
    # SfMMap._finalize_layout so counter updates are single scatter-adds
    other_gkp: Optional[np.ndarray] = None  # [E] int64

    def of(self, p2d: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.offsets[p2d], self.offsets[p2d + 1]
        return self.other_frame[s:e], self.other_p2d[s:e]

    def slots_of(self, p2ds: np.ndarray) -> np.ndarray:
        """Concatenated CSR row ranges for many keypoints, vectorized
        (no per-keypoint Python loop).  Returns flat indices into
        other_frame/other_p2d/other_gkp."""
        starts = self.offsets[p2ds]
        lens = self.offsets[p2ds + 1] - starts
        tot = int(lens.sum())
        if tot == 0:
            return np.zeros(0, np.int64)
        row_starts = np.cumsum(lens) - lens
        return (
            np.arange(tot, dtype=np.int64)
            - np.repeat(row_starts, lens)
            + np.repeat(starts, lens)
        )


class SfMMap:
    """The world state for incremental SfM."""

    def __init__(self):
        # frames
        self.names: List[str] = []
        self.cam_of_frame: np.ndarray = np.zeros(0, np.int32)
        self.kps: List[np.ndarray] = []  # [Ni, 2] float32 pixels
        self.kps_norm: List[np.ndarray] = []  # [Ni, 2] float32 normalized
        self.track_of: List[np.ndarray] = []  # [Ni] int64, -1 = none
        self.registered: np.ndarray = np.zeros(0, bool)
        self.registered_fail: np.ndarray = np.zeros(0, bool)
        self.q: np.ndarray = np.zeros((0, 4), np.float64)  # Tcw
        self.t: np.ndarray = np.zeros((0, 3), np.float64)
        # cameras: camera_id -> canonical [8] params (+ raw for I/O)
        self.cameras: Dict[int, np.ndarray] = {}
        self.camera_models: Dict[int, Tuple[int, np.ndarray, int, int]] = {}
        # pairs (inlier matches only after geometric verification)
        self.pairs: List[Tuple[int, int, np.ndarray]] = []
        self.pair_index: Dict[Tuple[int, int], int] = {}
        self.frame_pairs_of: List[List[int]] = []  # frame -> pair indices
        # correspondence graph
        self.corr: List[Optional[CorrCSR]] = []
        # per-(frame, p2d) count of correspondences that land on a live track
        self.p3d_corr_cnt: List[np.ndarray] = []
        # tracks (growable pools)
        cap = 1024
        self.track_xyz = np.zeros((cap, 3), np.float64)
        self.track_valid = np.zeros(cap, bool)
        self.track_error = np.zeros(cap, np.float64)
        self.track_angle = np.zeros(cap, np.float64)
        self.track_obs: List[Dict[int, int]] = []  # track -> {frame: p2d}
        self.num_tracks = 0
        # flat COO observation table (append-only with tombstones) — keeps
        # BA problem assembly pure numpy instead of dict iteration
        ocap = 4096
        self.obs_track = np.full(ocap, -1, np.int64)
        self.obs_frame = np.zeros(ocap, np.int32)
        self.obs_p2d = np.zeros(ocap, np.int32)
        self.num_obs_slots = 0
        self._obs_slot: Dict[Tuple[int, int], int] = {}  # (tid, frame) -> slot
        # init pair bookkeeping (gauge fixing in BA)
        self.init_id1 = -1
        self.init_id2 = -1
        # flat-layout acceleration structures (built by _finalize_layout
        # once the frame set is complete; None until then)
        self._kp_off: Optional[np.ndarray] = None  # [F+1] int64
        self._cnt_flat: Optional[np.ndarray] = None  # [T] int32
        self._track_of_flat: Optional[np.ndarray] = None  # [T] int64
        self._vis_cnt: Optional[np.ndarray] = None  # [F] int64 cached
        self._vis_dirty: Optional[np.ndarray] = None  # [F] bool

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    # state attributes, in the order from_state copies them
    _STATE = (
        "names", "cam_of_frame", "kps", "kps_norm", "track_of",
        "registered", "registered_fail", "q", "t", "cameras",
        "camera_models", "pairs", "pair_index", "frame_pairs_of", "corr",
        "p3d_corr_cnt", "track_xyz", "track_valid", "track_error",
        "track_angle", "track_obs", "num_tracks", "obs_track", "obs_frame",
        "obs_p2d", "num_obs_slots", "_obs_slot", "init_id1", "init_id2",
    )
    # keyframe state that mapper/keyframe.py adds to a map
    _KEYFRAME_STATE = ("is_keyframe", "ref_frame", "ref_rel_q", "ref_rel_t")

    @classmethod
    def from_state(cls, obj) -> "SfMMap":
        """A map holding a deep copy of another map's state, read attribute
        by attribute (a JAX-package SfMMap, or this class), so that both
        packages can continue from one map state.  Correspondence graphs
        are rebuilt as this package's CorrCSR, and the flat layout is
        re-finalized when the source had one."""
        import copy

        m = cls()
        for name in cls._STATE + cls._KEYFRAME_STATE:
            if name in cls._KEYFRAME_STATE and not hasattr(obj, name):
                continue
            val = copy.deepcopy(getattr(obj, name))
            if name == "corr":
                val = [None if c is None else CorrCSR(
                    offsets=np.asarray(c.offsets),
                    other_frame=np.asarray(c.other_frame),
                    other_p2d=np.asarray(c.other_p2d)) for c in val]
            elif name in ("kps", "kps_norm", "track_of", "p3d_corr_cnt"):
                val = [np.array(a) for a in val]  # own arrays, not views
            setattr(m, name, val)
        if getattr(obj, "_kp_off", None) is not None:
            m._finalize_layout()
        return m

    @property
    def num_frames(self) -> int:
        return len(self.names)

    def add_camera(self, cam_id: int, model_id: int, params, width=0, height=0):
        raw = np.asarray(params, np.float64)
        self.cameras[cam_id] = Cam.canonicalize_params(model_id, raw)
        self.camera_models[cam_id] = (model_id, raw, width, height)

    def add_frame(self, name: str, cam_id: int, keypoints_xy: np.ndarray):
        """keypoints_xy [N, 2] pixel coordinates."""
        self.names.append(name)
        self.cam_of_frame = np.append(self.cam_of_frame, np.int32(cam_id))
        kp = np.asarray(keypoints_xy, np.float32).reshape(-1, 2)
        self.kps.append(kp)
        self.kps_norm.append(self._normalize(cam_id, kp))
        self.track_of.append(np.full(len(kp), -1, np.int64))
        self.registered = np.append(self.registered, False)
        self.registered_fail = np.append(self.registered_fail, False)
        self.q = np.vstack([self.q, [[1.0, 0, 0, 0]]])
        self.t = np.vstack([self.t, [[0.0, 0, 0]]])
        self.corr.append(None)
        self.p3d_corr_cnt.append(np.zeros(len(kp), np.int32))
        self.frame_pairs_of.append([])
        self._kp_off = None  # invalidate flat layout until next finalize
        return len(self.names) - 1

    def _normalize(self, cam_id: int, kp: np.ndarray) -> np.ndarray:
        # host bookkeeping: float32 undistortion on the CPU
        return Cam.image_to_normalized_np(self.cameras[cam_id], kp)

    def update_camera(self, cam_id: int, canon_params: np.ndarray):
        """Write refined canonical intrinsics back and refresh kps_norm for
        every frame of this camera in one batched undistortion call."""
        canon = np.asarray(canon_params, np.float64).reshape(8)
        self.cameras[cam_id] = canon
        model_id, _, w, h = self.camera_models[cam_id]
        self.camera_models[cam_id] = (
            model_id, Cam.raw_params(model_id, canon), w, h
        )
        frames = np.nonzero(self.cam_of_frame == cam_id)[0]
        if len(frames) == 0:
            return
        allkp = np.concatenate([self.kps[int(f)] for f in frames], axis=0)
        out = Cam.image_to_normalized_np(canon, allkp)
        off = 0
        for f in frames:
            n = len(self.kps[int(f)])
            self.kps_norm[int(f)] = out[off: off + n]
            off += n

    def add_pair(self, id1: int, id2: int, inlier_matches: np.ndarray):
        """inlier_matches [M, 2] int32 (p2d in id1, p2d in id2)."""
        pid = len(self.pairs)
        m = np.asarray(inlier_matches, np.int32).reshape(-1, 2)
        self.pairs.append((id1, id2, m))
        self.pair_index[(id1, id2)] = pid
        self.frame_pairs_of[id1].append(pid)
        self.frame_pairs_of[id2].append(pid)

    def build_correspondence_graph(self):
        """Build per-frame CSR correspondence tables from the pair matches.
        (reference: Map::Init corr-graph phase, src/base/map.cc:29-87)."""
        per_frame: List[List[np.ndarray]] = [[] for _ in range(self.num_frames)]
        for id1, id2, m in self.pairs:
            if len(m) == 0:
                continue
            a = np.empty((len(m), 3), np.int64)
            a[:, 0] = m[:, 0]
            a[:, 1] = id2
            a[:, 2] = m[:, 1]
            per_frame[id1].append(a)
            b = np.empty((len(m), 3), np.int64)
            b[:, 0] = m[:, 1]
            b[:, 1] = id1
            b[:, 2] = m[:, 0]
            per_frame[id2].append(b)
        for f in range(self.num_frames):
            n = len(self.kps[f])
            if per_frame[f]:
                rows = np.concatenate(per_frame[f], axis=0)
                order = np.argsort(rows[:, 0], kind="stable")
                rows = rows[order]
                counts = np.bincount(rows[:, 0], minlength=n)
                offsets = np.zeros(n + 1, np.int64)
                np.cumsum(counts, out=offsets[1:])
                self.corr[f] = CorrCSR(
                    offsets=offsets,
                    other_frame=rows[:, 1].astype(np.int32),
                    other_p2d=rows[:, 2].astype(np.int32),
                )
            else:
                self.corr[f] = CorrCSR(
                    offsets=np.zeros(n + 1, np.int64),
                    other_frame=np.zeros(0, np.int32),
                    other_p2d=np.zeros(0, np.int32),
                )
        self._finalize_layout()

    def _finalize_layout(self):
        """Build the flat global-keypoint layout that turns every
        visibility-counter update into one vectorized scatter-add.

        Layout: keypoint (f, p) gets global index _kp_off[f] + p;
        track_of / p3d_corr_cnt become views into flat arrays (element
        writes go through views transparently); each CSR gets other_gkp.
        Called by build_correspondence_graph; re-call after adding frames
        (add_frame invalidates)."""
        F = self.num_frames
        kp_off = np.zeros(F + 1, np.int64)
        np.cumsum([len(k) for k in self.kps], out=kp_off[1:])
        self._kp_off = kp_off
        self._track_of_flat = (
            np.concatenate(self.track_of)
            if F
            else np.zeros(0, np.int64)
        )
        self._cnt_flat = (
            np.concatenate(self.p3d_corr_cnt)
            if F
            else np.zeros(0, np.int32)
        )
        self.track_of = [
            self._track_of_flat[kp_off[f]: kp_off[f + 1]] for f in range(F)
        ]
        self.p3d_corr_cnt = [
            self._cnt_flat[kp_off[f]: kp_off[f + 1]] for f in range(F)
        ]
        for f in range(F):
            c = self.corr[f]
            if c is not None and c.other_gkp is None:
                c.other_gkp = kp_off[c.other_frame] + c.other_p2d
        self._vis_cnt = np.array(
            [int(np.count_nonzero(self.p3d_corr_cnt[f] > 0)) for f in range(F)],
            np.int64,
        )
        self._vis_dirty = np.zeros(F, bool)

    def _bump_counters(self, frame: int, p2ds: np.ndarray, delta: int):
        """Vectorized p3d_corr_cnt update over the correspondences of
        (frame, p2ds): one scatter-add, dirty-mark touched frames."""
        csr = self.corr[frame]
        if csr is None or len(csr.other_frame) == 0:
            return
        sl = csr.slots_of(np.asarray(p2ds, np.int64).reshape(-1))
        if len(sl) == 0:
            return
        if self._kp_off is not None and csr.other_gkp is not None:
            np.add.at(self._cnt_flat, csr.other_gkp[sl], delta)
            self._vis_dirty[csr.other_frame[sl]] = True
        else:  # pre-finalize fallback (e.g. maps built without corr graph)
            of, op = csr.other_frame[sl], csr.other_p2d[sl]
            for f2, pp in zip(of, op):
                self.p3d_corr_cnt[f2][pp] += delta

    # ------------------------------------------------------------------
    # track pool
    # ------------------------------------------------------------------

    def _grow_tracks(self, need: int):
        cap = len(self.track_valid)
        if self.num_tracks + need <= cap:
            return
        new_cap = max(cap * 2, self.num_tracks + need)
        self.track_xyz = np.vstack(
            [self.track_xyz, np.zeros((new_cap - cap, 3), np.float64)]
        )
        self.track_valid = np.append(
            self.track_valid, np.zeros(new_cap - cap, bool)
        )
        self.track_error = np.append(
            self.track_error, np.zeros(new_cap - cap, np.float64)
        )
        self.track_angle = np.append(
            self.track_angle, np.zeros(new_cap - cap, np.float64)
        )

    def new_track(self, xyz: np.ndarray) -> int:
        self._grow_tracks(1)
        tid = self.num_tracks
        self.num_tracks += 1
        self.track_xyz[tid] = xyz
        self.track_valid[tid] = True
        self.track_obs.append({})
        return tid

    def _obs_append(self, tid: int, frame: int, p2d: int):
        if self.num_obs_slots >= len(self.obs_track):
            grow = len(self.obs_track)
            self.obs_track = np.append(self.obs_track, np.full(grow, -1, np.int64))
            self.obs_frame = np.append(self.obs_frame, np.zeros(grow, np.int32))
            self.obs_p2d = np.append(self.obs_p2d, np.zeros(grow, np.int32))
        s = self.num_obs_slots
        self.num_obs_slots += 1
        self.obs_track[s] = tid
        self.obs_frame[s] = frame
        self.obs_p2d[s] = p2d
        self._obs_slot[(tid, frame)] = s

    _EMPTY_CORR = (np.zeros(0, np.int32), np.zeros(0, np.int32))

    def _corrs(self, frame: int, p2d: int):
        """Correspondences of (frame, p2d); empty when the corr graph is
        absent (e.g. a map loaded from COLMAP bins without matches)."""
        c = self.corr[frame]
        return self._EMPTY_CORR if c is None else c.of(p2d)

    def add_observation(self, tid: int, frame: int, p2d: int):
        """Attach (frame, p2d) to track tid and update visibility counters."""
        old = self.track_of[frame][p2d]
        if old == tid:
            return
        if old >= 0:
            self.remove_observation(int(old), frame, p2d)
        self.track_obs[tid][frame] = p2d
        self.track_of[frame][p2d] = tid
        self._obs_append(tid, frame, p2d)
        self._bump_counters(frame, np.array([p2d]), +1)

    def add_observations(self, tids, frame: int, p2ds):
        """Batch add_observation for many keypoints of ONE frame — the
        common shape in registration/triangulation.  Counter updates are
        one scatter-add for the whole batch."""
        tids = np.asarray(tids, np.int64).reshape(-1)
        p2ds = np.asarray(p2ds, np.int64).reshape(-1)
        fresh = []
        for tid, p2d in zip(tids, p2ds):
            tid, p2d = int(tid), int(p2d)
            old = self.track_of[frame][p2d]
            if old == tid:
                continue
            if old >= 0:
                self.remove_observation(int(old), frame, p2d)
            self.track_obs[tid][frame] = p2d
            self.track_of[frame][p2d] = tid
            self._obs_append(tid, frame, p2d)
            fresh.append(p2d)
        if fresh:
            self._bump_counters(frame, np.asarray(fresh, np.int64), +1)

    def remove_observation(self, tid: int, frame: int, p2d: int):
        if self.track_obs[tid].get(frame) != p2d:
            return
        del self.track_obs[tid][frame]
        self.track_of[frame][p2d] = -1
        slot = self._obs_slot.pop((tid, frame), None)
        if slot is not None:
            self.obs_track[slot] = -1  # tombstone
        self._bump_counters(frame, np.array([p2d]), -1)
        if len(self.track_obs[tid]) < 2 and self.track_valid[tid]:
            # a 1-observation track is not a track
            self.delete_track(tid)

    def delete_track(self, tid: int):
        if not self.track_valid[tid]:
            return
        self.track_valid[tid] = False
        for frame, p2d in list(self.track_obs[tid].items()):
            del self.track_obs[tid][frame]
            self.track_of[frame][p2d] = -1
            slot = self._obs_slot.pop((tid, frame), None)
            if slot is not None:
                self.obs_track[slot] = -1
            self._bump_counters(frame, np.array([p2d]), -1)

    # ------------------------------------------------------------------
    # queries used by the incremental loop
    # ------------------------------------------------------------------

    def rebuild_visibility_counters(self):
        """Recompute p3d_corr_cnt from scratch (after snapshot resume:
        load pairs + build_correspondence_graph first, then this).
        Vectorized: group live observations by frame, scatter-add each
        frame's concatenated correspondence slices."""
        if self._kp_off is None:
            self._finalize_layout()
        self._cnt_flat[:] = 0
        n = self.num_obs_slots
        live = self.obs_track[:n] >= 0
        if np.any(live):
            frames = self.obs_frame[:n][live]
            p2ds = self.obs_p2d[:n][live]
            order = np.argsort(frames, kind="stable")
            frames, p2ds = frames[order], p2ds[order]
            bounds = np.nonzero(np.diff(frames))[0] + 1
            for chunk_f, chunk_p in zip(
                np.split(frames, bounds), np.split(p2ds, bounds)
            ):
                csr = self.corr[int(chunk_f[0])]
                if csr is None or csr.other_gkp is None:
                    continue
                sl = csr.slots_of(chunk_p.astype(np.int64))
                if len(sl):
                    np.add.at(self._cnt_flat, csr.other_gkp[sl], 1)
        self._vis_dirty[:] = True

    def _refresh_vis(self):
        """Recount cached visible-track counts for dirty frames only."""
        dirty = np.nonzero(self._vis_dirty)[0]
        for f in dirty:
            s, e = self._kp_off[f], self._kp_off[f + 1]
            self._vis_cnt[f] = int(np.count_nonzero(self._cnt_flat[s:e] > 0))
        self._vis_dirty[dirty] = False

    def visible_track_count(self, frame: int) -> int:
        """Number of keypoints of `frame` whose correspondences reach >= 1
        live track (reference: Frame::num_visible_points3D analog)."""
        if self._kp_off is None:
            return int(np.count_nonzero(self.p3d_corr_cnt[frame] > 0))
        if self._vis_dirty[frame]:
            s, e = self._kp_off[frame], self._kp_off[frame + 1]
            self._vis_cnt[frame] = int(
                np.count_nonzero(self._cnt_flat[s:e] > 0)
            )
            self._vis_dirty[frame] = False
        return int(self._vis_cnt[frame])

    def next_frame_to_register(self, min_visible: int = 20) -> int:
        """Unregistered frame seeing the most tracks (reference:
        Map::MaxPoint3dFrameId, src/base/map.cc:129-205).  Returns -1 when
        none qualifies."""
        f = self.ready_frames(min_visible, max_batch=1)
        return int(f[0]) if len(f) else -1

    def ready_frames(self, min_visible: int = 20, max_batch: int = 1,
                     ratio: float = 0.6) -> np.ndarray:
        """Unregistered frames ready to register, best-first: all frames
        with visible-track count >= max(min_visible, ratio * best).
        max_batch=1 reproduces MaxPoint3dFrameId; larger batches feed the
        one-pass batched registration (SURVEY §7.3 — the reference
        registers strictly one frame at a time)."""
        if self._kp_off is None:
            self._finalize_layout()
        self._refresh_vis()
        cand = ~(self.registered | self.registered_fail)
        if not np.any(cand):
            return np.zeros(0, np.int64)
        scores = np.where(cand, self._vis_cnt, -1)
        best = int(scores.max())
        if best < min_visible:
            return np.zeros(0, np.int64)
        cut = max(min_visible, int(np.ceil(ratio * best)))
        ids = np.nonzero(scores >= cut)[0]
        order = np.argsort(-scores[ids], kind="stable")
        return ids[order][:max_batch].astype(np.int64)

    def search_correspondences(self, frame: int):
        """2D-3D correspondences for registration: for each keypoint of
        `frame`, tracks seen through registered neighbors.
        Returns (p2d_idx [K], track_id [K]) deduplicated.
        (reference: Map::SearchCorrespondences, src/base/map.cc:255-310)."""
        csr = self.corr[frame]
        if len(csr.other_frame) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        reg = self.registered[csr.other_frame]
        # track of each correspondence target — one flat gather when the
        # layout is finalized, per-frame gathers otherwise
        if self._kp_off is not None and csr.other_gkp is not None:
            tids = np.where(reg, self._track_of_flat[csr.other_gkp], -1)
        else:
            tids = np.full(len(csr.other_frame), -1, np.int64)
            for f2 in np.unique(csr.other_frame[reg]):
                sel = (csr.other_frame == f2) & reg
                tids[sel] = self.track_of[f2][csr.other_p2d[sel]]
        ok = tids >= 0
        ok &= np.where(ok, self.track_valid[np.maximum(tids, 0)], False)
        if not np.any(ok):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        # expand p2d index per correspondence row
        counts = np.diff(csr.offsets)
        p2d_of_row = np.repeat(np.arange(len(counts)), counts)
        pairs = np.stack([p2d_of_row[ok], tids[ok]], axis=1)
        pairs = np.unique(pairs, axis=0)
        return pairs[:, 0], pairs[:, 1]

    def covisible_frames(self, frame: int, min_shared: int = 1):
        """Registered frames sharing tracks with `frame`, sorted by shared
        count descending.  Returns (frame_ids, counts).

        Vectorized over the flat COO observation table: membership mask
        over this frame's live tracks, then one bincount over obs_frame."""
        t = self.track_of[frame]
        tids = t[t >= 0]
        tids = tids[self.track_valid[tids]]
        if len(tids) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        in_set = np.zeros(self.num_tracks, bool)
        in_set[tids] = True
        n = self.num_obs_slots
        ot = self.obs_track[:n]
        sel = (ot >= 0) & in_set[np.maximum(ot, 0)]
        counts = np.bincount(
            self.obs_frame[:n][sel], minlength=self.num_frames
        )
        counts[frame] = 0
        counts[~self.registered] = 0
        ids = np.nonzero(counts >= min_shared)[0]
        order = np.argsort(-counts[ids], kind="stable")
        ids = ids[order]
        return ids.astype(np.int64), counts[ids].astype(np.int64)

    def frame_observations(self, frame: int):
        """(p2d_idx, track_id) of live observations of a frame."""
        t = self.track_of[frame]
        p2d = np.nonzero(t >= 0)[0]
        return p2d, t[p2d]

    def deregister_frame(self, frame: int):
        """Remove a frame and all its observations (reference:
        Map::DeregistrationFrame, src/base/map.cc:665-680)."""
        p2d, tids = self.frame_observations(frame)
        for p, tid in zip(p2d, tids):
            self.remove_observation(int(tid), frame, int(p))
        self.registered[frame] = False
