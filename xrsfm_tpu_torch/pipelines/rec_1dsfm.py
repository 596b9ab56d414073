"""1DSfM unordered-scene reconstruction (port of
xrsfm_tpu/pipelines/rec_1dsfm.py; reference: src/rec_1dsfm.cc:14-98).

Usage: python -m xrsfm_tpu_torch.cli rec_1dsfm <bin_dir> <camera_info>
       <output_dir> [--n_devices N] [--device cuda]

Per-image SIMPLE_RADIAL cameras from camera_info.txt (EXIF-grade focals,
zero distortion); frames without an entry take camera 0 and still take
part (the reference marks zero-distortion cameras invalid,
rec_1dsfm.cc:46-55).  The mapper refines the intrinsics in global BA,
registers over a focal-scale grid and runs the global pose polish; writes
the COLMAP model.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..base.colmap_bridge import map_to_colmap
from ..device import resolve_device
from ..mapper import IncrementalMapper, MapperOptions
from ..utils import io_colmap as IOC
from . import run_reconstruction as RR


def main(bin_dir: str, camera_info_path: str, output_dir: str,
         n_devices: int = 1, stats: Optional[dict] = None, *,
         device="cuda"):
    """Run the 1DSfM regime on `device`; returns the map, or None when
    reconstruction fails.  stats, when given, receives the mapper's
    MapperStats and the seconds.  n_devices > 1 shards the global BA
    solves, intrinsics-refining ones included, over that many devices
    (RuntimeError when fewer exist)."""
    dev = resolve_device(device)
    t0 = time.time()
    opts = MapperOptions(n_devices=n_devices)
    # reference th_rpe_gba = 4 px for internet scenes (rec_1dsfm.cc:88):
    # the final-polish gate; the growth-time filter keeps 16 px, since
    # genuine tracks reproject several px off until the intrinsics are
    # refined
    opts.tri.polish_px = 4.0
    # noisy per-image EXIF focals, distortion starting at 0
    # (rec_1dsfm.cc:46-55): GBA refines camera_param
    opts.refine_intrinsics = True
    opts.global_polish = True
    # registration solves PnP over a focal-scale grid and writes the
    # winner back (mapper/register)
    opts.reg = dataclasses.replace(
        opts.reg, focal_scales=(0.85, 0.925, 1.0, 1.08, 1.16))
    mapper = IncrementalMapper(opts, device=dev)
    name2cid, cams = IOC.read_camera_info(camera_info_path)
    m = RR.build_map(bin_dir, camera_per_image=cams, name2cid=name2cid)
    ok = mapper.reconstruct(m)
    if stats is not None:
        stats["mapper"] = mapper.stats
    if not ok:
        print("[rec_1dsfm] reconstruction failed", flush=True)
        return None
    n_img, n_pts = map_to_colmap(m, output_dir)
    if stats is not None:
        stats["seconds"] = time.time() - t0
    print(f"[rec_1dsfm] {n_img} images, {n_pts} points in "
          f"{time.time() - t0:.1f}s "
          f"({int(np.count_nonzero(m.registered))} registered)", flush=True)
    return m
