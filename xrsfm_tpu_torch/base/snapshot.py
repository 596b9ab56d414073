"""Mid-run map snapshots (checkpoint/resume; host numpy copy of
xrsfm_tpu/base/snapshot.py, with its file format).

The reference's resume granularity is the pipeline stage (on-disk
ftr/fp/COLMAP artifacts, SURVEY.md §5.4); a snapshot holds the full
incremental-mapper state, so a reconstruction can resume mid-run (the
incremental loop checkpoints every MapperOptions.snapshot_every
registrations).

Format: one .npz of SoA arrays, with names and cameras in a JSON
document stored as uint8 bytes under "meta": no pickle.  A snapshot
written by either package resumes in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .map import SfMMap


def save_snapshot(m: SfMMap, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    nt = m.num_tracks
    obs = np.asarray([(tid, f, p) for tid in range(nt)
                      for f, p in m.track_obs[tid].items()],
                     np.int64).reshape(-1, 3)
    meta = dict(
        names=m.names,
        cameras={
            str(k): dict(model_id=int(v[0]), params=list(map(float, v[1])),
                         width=int(v[2]), height=int(v[3]))
            for k, v in m.camera_models.items()
        },
        init_id1=m.init_id1,
        init_id2=m.init_id2,
        num_tracks=nt,
    )
    np.savez_compressed(
        path,
        cam_of_frame=m.cam_of_frame,
        registered=m.registered,
        registered_fail=m.registered_fail,
        q=m.q,
        t=m.t,
        track_xyz=m.track_xyz[:nt],
        track_valid=m.track_valid[:nt],
        track_error=m.track_error[:nt],
        track_angle=m.track_angle[:nt],
        obs=obs,
        kp_counts=np.asarray([len(k) for k in m.kps], np.int64),
        kps=(np.concatenate(m.kps, axis=0) if m.kps
             else np.zeros((0, 2), np.float32)),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def _read(path: str):
    z = np.load(path)
    return z, json.loads(bytes(z["meta"]).decode())


def _overlay_state(m: SfMMap, z, meta):
    """Write a snapshot's mapper state (poses, flags, tracks,
    observations) into a map whose frames and cameras already exist."""
    m.registered = z["registered"].copy()
    m.registered_fail = z["registered_fail"].copy()
    m.q = z["q"].copy()
    m.t = z["t"].copy()
    m.init_id1 = meta["init_id1"]
    m.init_id2 = meta["init_id2"]
    nt = meta["num_tracks"]
    m._grow_tracks(nt)
    m.num_tracks = nt
    m.track_xyz[:nt] = z["track_xyz"]
    m.track_valid[:nt] = z["track_valid"]
    m.track_error[:nt] = z["track_error"]
    m.track_angle[:nt] = z["track_angle"]
    m.track_obs = [dict() for _ in range(nt)]
    for f in range(m.num_frames):
        m.track_of[f][:] = -1
    for tid, f, p in z["obs"].tolist():
        m.track_obs[tid][f] = p
        m.track_of[f][p] = tid
        m._obs_append(tid, f, p)
    m.rebuild_visibility_counters()


def load_snapshot(path: str) -> SfMMap:
    """A map holding a snapshot's frames, cameras and mapper state (no
    pairs and no correspondence graph)."""
    z, meta = _read(path)
    m = SfMMap()
    for k, v in meta["cameras"].items():
        m.add_camera(int(k), v["model_id"], v["params"], v["width"],
                     v["height"])
    counts = z["kp_counts"]
    kps_flat = z["kps"]
    off = 0
    for i, name in enumerate(meta["names"]):
        n = int(counts[i])
        m.add_frame(name, int(z["cam_of_frame"][i]), kps_flat[off: off + n])
        off += n
    _overlay_state(m, z, meta)
    return m


def restore_into(m: SfMMap, path: str) -> SfMMap:
    """Resume: overlay a snapshot's mapper state onto a freshly built map
    (build_map carries the pairs and the correspondence graph, which
    snapshots do not duplicate: the matching stage's bins are the
    stage-level checkpoint, SURVEY.md §5.4).  Refuses another dataset."""
    z, meta = _read(path)
    if list(meta["names"]) != list(m.names):
        raise ValueError(
            "snapshot frame names do not match the workspace; refusing to "
            "resume from a different dataset")
    _overlay_state(m, z, meta)
    return m
