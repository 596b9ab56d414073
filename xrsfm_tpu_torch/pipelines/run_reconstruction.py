"""Reconstruction stage pipeline (port of
xrsfm_tpu/pipelines/run_reconstruction.py; reference:
src/run_reconstruction.cc).

Usage: python -m xrsfm_tpu_torch.cli run_reconstruction <bin_dir>
       <camera_txt> <output_dir> [--init_id1 N --init_id2 N]
       [--correct_pose] [--snapshot_every N] [--resume] [--n_devices N]
       [--device cuda]

Reads ftr.bin + fp.bin and a single-camera cameras.txt, runs the
incremental mapper on `device`, and writes cameras.bin / images.bin /
points3D.bin and trajectory.txt.  With snapshot_every the mapper saves
<output_dir>/snapshot.npz every N registrations; resume restores that
snapshot onto the freshly built map and continues from it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..base import snapshot as SNAP
from ..base.colmap_bridge import map_to_colmap, write_trajectory
from ..base.map import SfMMap
from ..device import resolve_device
from ..mapper import IncrementalMapper, MapperOptions
from ..utils import io_colmap as IOC
from ..utils import io_features as IOF


def build_map(bin_dir: str, camera_txt: Optional[str] = None,
              camera_per_image: Optional[dict] = None,
              name2cid: Optional[dict] = None) -> SfMMap:
    """PreProcess (reference: run_reconstruction.cc:12-47): load features
    and verified pairs, build the correspondence graph.  One shared camera
    from camera_txt, or per-image cameras (camera_per_image {cid:
    ColmapCamera} and name2cid {image name: cid}; an image without an
    entry takes camera 0)."""
    feats = IOF.read_features(os.path.join(bin_dir, "ftr.bin"),
                              with_descs=False)
    pairs = IOF.read_frame_pairs(os.path.join(bin_dir, "fp.bin"))
    m = SfMMap()
    if camera_per_image is None:
        cams = IOC.read_cameras_text(camera_txt)
        c = cams[sorted(cams.keys())[0]]
        m.add_camera(0, c.model_id, c.params, c.width, c.height)
        for f in feats:
            m.add_frame(f.name, 0, f.keypoints[:, :2])
    else:
        for cid, c in camera_per_image.items():
            m.add_camera(cid, c.model_id, c.params, c.width, c.height)
        for f in feats:
            m.add_frame(f.name, max(name2cid.get(f.name, -1), 0),
                        f.keypoints[:, :2])
    for p in pairs:
        inl = p.inlier_matches()
        if len(inl):
            m.add_pair(p.id1, p.id2, inl)
    m.build_correspondence_graph()
    return m


def main(
    bin_dir: str,
    camera_txt: str,
    output_dir: str,
    init_id1: int = -1,
    init_id2: int = -1,
    opts: Optional[MapperOptions] = None,
    correct_pose: bool = False,
    snapshot_every: int = 0,
    resume: bool = False,
    n_devices: int = 1,
    stats: Optional[dict] = None,
    *,
    device="cuda",
):
    """Run the stage; returns the map, or None when initialization fails.
    correct_pose turns on loop correction and, with it, the global pose
    polish (the drift-prone sequential regime).  stats, when given,
    receives the mapper's MapperStats and the stage seconds.
    n_devices > 1 shards the global BA solves over that many devices
    (RuntimeError when fewer exist)."""
    dev = resolve_device(device)
    t0 = time.time()
    opts = opts or MapperOptions()
    opts.init_id1 = init_id1
    opts.init_id2 = init_id2
    opts.correct_pose = opts.correct_pose or correct_pose
    # drift-prone sequential regime: couple the global pose polish to
    # correct_pose (guarded by its own connectivity and residual gates)
    opts.global_polish = opts.global_polish or opts.correct_pose
    if n_devices > 1:
        opts.n_devices = n_devices
    snap_path = os.path.join(output_dir, "snapshot.npz")
    if snapshot_every:
        opts.snapshot_every = snapshot_every
        opts.snapshot_path = snap_path
    mapper = IncrementalMapper(opts, device=dev)
    m = build_map(bin_dir, camera_txt)
    if resume and os.path.exists(snap_path):
        SNAP.restore_into(m, snap_path)
        print(f"[reconstruction] resumed from {snap_path} "
              f"({int(np.count_nonzero(m.registered))} frames registered)",
              flush=True)
    ok = mapper.reconstruct(m)
    if stats is not None:
        stats["mapper"] = mapper.stats
    if not ok:
        print("[reconstruction] FAILED to initialize", flush=True)
        return None
    n_img, n_pts = map_to_colmap(m, output_dir)
    write_trajectory(m, os.path.join(output_dir, "trajectory.txt"))
    if stats is not None:
        stats["seconds"] = time.time() - t0
    print(
        f"[reconstruction] {n_img} images, {n_pts} points in "
        f"{time.time() - t0:.1f}s -> {output_dir} "
        f"({int(np.count_nonzero(m.registered))} registered)",
        flush=True,
    )
    return m
