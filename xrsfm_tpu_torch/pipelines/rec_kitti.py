"""KITTI odometry reconstruction (port of xrsfm_tpu/pipelines/rec_kitti.py;
reference: src/rec_kitti.cc:14-115).

Usage: python -m xrsfm_tpu_torch.cli rec_kitti <bin_dir> <seq_name>
       <output_dir> [--timestamp_path times.txt] [--device cuda]

Per-sequence PINHOLE intrinsics as in the reference (rec_kitti.cc:24-30,
sequence -> camera :87-89), unless the workspace holds its own camera.txt;
sequential mapping with loop correction and the global pose polish on;
COLMAP model and a TUM trajectory (<seq_name>.txt) with the timestamps of
times.txt.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..base.colmap_bridge import map_to_colmap, write_trajectory
from ..device import resolve_device
from ..mapper import IncrementalMapper, MapperOptions
from ..utils import io_colmap as IOC
from ..utils.profiling import span
from . import run_reconstruction as RR

# reference: rec_kitti.cc:24-30, the three KITTI calibrations
_KITTI_CAMERAS = {
    0: [718.856, 718.856, 607.1928, 185.2157],  # seq 00-02
    1: [721.5377, 721.5377, 609.5593, 172.854],  # seq 03
    2: [707.0912, 707.0912, 601.8873, 183.1104],  # seq 04-12
}


def camera_for_sequence(seq: int):
    if seq <= 2:
        return _KITTI_CAMERAS[0]
    if seq == 3:
        return _KITTI_CAMERAS[1]
    return _KITTI_CAMERAS[2]


def frame_timestamps(names, all_stamps):
    """The timestamp of each frame from the digits in its image name
    (KITTI names are 000000.png, 000123.png, ...), so that a subsampled or
    partial image set still maps right; a name without digits takes its
    frame index (the reference assumes frame order = timestamp order,
    rec_kitti.cc:95-108)."""
    stamps = []
    for i, name in enumerate(names):
        digits = "".join(c for c in os.path.basename(name) if c.isdigit())
        idx = int(digits) if digits else i
        stamps.append(all_stamps[min(idx, len(all_stamps) - 1)])
    return stamps


def main(bin_dir: str, seq_name: str, output_dir: str,
         timestamp_path: str = "", stats: Optional[dict] = None, *,
         device="cuda"):
    """Run the sequence; returns the map, or None when reconstruction
    fails.  stats, when given, receives the mapper's MapperStats and the
    seconds (the span xrsfm.reconstruct)."""
    dev = resolve_device(device)
    with span("xrsfm.reconstruct") as rec:
        os.makedirs(output_dir, exist_ok=True)
        # a camera.txt in the workspace overrides the built-in table
        # (recalibrated sequences and non-KITTI captures)
        ws_cam = os.path.join(bin_dir, "camera.txt")
        cam_txt = os.path.join(output_dir, "camera.txt")
        if os.path.exists(ws_cam):
            cam_txt = ws_cam
        else:
            params = camera_for_sequence(int(seq_name))
            with open(cam_txt, "w") as f:
                f.write(f"0 PINHOLE 1241 376 {params[0]} {params[1]} "
                        f"{params[2]} {params[3]}\n")
        opts = MapperOptions()
        opts.correct_pose = True  # the KITTI path corrects drift
        # sequential circuits are the drift-basin regime of the global
        # polish
        opts.global_polish = True
        mapper = IncrementalMapper(opts, device=dev)
        with span("xrsfm.reconstruct.load"):
            m = RR.build_map(bin_dir, cam_txt)
        ok = mapper.reconstruct(m)
        if stats is not None:
            stats["mapper"] = mapper.stats
        if not ok:
            print("[rec_kitti] reconstruction failed", flush=True)
            return None
        with span("xrsfm.reconstruct.write"):
            map_to_colmap(m, output_dir)
            stamps = None
            if timestamp_path and os.path.exists(timestamp_path):
                stamps = frame_timestamps(
                    m.names, IOC.load_timestamps(timestamp_path))
            write_trajectory(m, os.path.join(output_dir, f"{seq_name}.txt"),
                             stamps)
    if stats is not None:
        stats["seconds"] = rec.seconds
    print(f"[rec_kitti] seq {seq_name} done in {rec.seconds:.1f}s "
          f"({int(np.count_nonzero(m.registered))} registered)", flush=True)
    return m
