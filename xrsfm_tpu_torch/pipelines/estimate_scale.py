"""AprilTag metric scale estimation pipeline (port of
xrsfm_tpu/pipelines/estimate_scale.py; reference:
src/estimate_scale.cc:17-32 -> tag_refine, src/tag/tag_extract.hpp:133-277;
the tag side defaults to 0.113 m, docs/en/faq.md).

Usage: python -m xrsfm_tpu_torch.cli estimate_scale <images_dir>
       <model_dir> [--tag_length 0.113] [--device cuda]

Reads a COLMAP model and its images (PNG/PGM through utils/image_io),
detects the tags on the host (cv2, imported by feature/tags.detect_tags),
triangulates their corners with the poses fixed, estimates the global
metric scale and refines it on `device`, rescales the model and rewrites
its binaries in place.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from ..base.colmap_bridge import colmap_to_map, map_to_colmap
from ..base.map import SfMMap
from ..device import resolve_device
from ..feature import tags as T
from ..utils import image_io


def rescale(m: SfMMap, detections: Dict[int, Dict[int, np.ndarray]],
            tag_length: float, *, device="cuda") -> Optional[float]:
    """Corner triangulation, closed-form scale, joint refinement, then the
    map divided by the scale; returns the scale, or None (map unchanged)
    when no tag is usable."""
    corners = T.triangulate_tag_corners(m, detections, device=device)
    scale, poses = T.estimate_scale_from_corners(corners, tag_length)
    if scale <= 0:
        return None
    # joint refinement against every corner reprojection (reference: the
    # second Ceres solve, tag_extract.hpp:237-265)
    scale = T.joint_refine_scale(m, detections, corners, scale, poses,
                                 tag_length, device=device)
    T.apply_metric_scale(m, scale)
    return scale


def main(images_dir: str, model_dir: str, tag_length: float = 0.113, *,
         device="cuda"):
    dev = resolve_device(device)
    t0 = time.time()
    m = colmap_to_map(model_dir)
    detections = {}
    n_det = 0
    for fid, name in enumerate(m.names):
        img = image_io.read_gray_or_none(os.path.join(images_dir, name))
        if img is None:
            continue
        tags = T.detect_tags(img)
        if tags:
            detections[fid] = tags
            n_det += len(tags)
    print(f"[estimate_scale] {n_det} tag detections in "
          f"{len(detections)} frames", flush=True)
    scale = rescale(m, detections, tag_length, device=dev)
    if scale is None:
        print("[estimate_scale] no usable tags; model unchanged", flush=True)
        return None
    map_to_colmap(m, model_dir)
    print(f"[estimate_scale] scale {scale:.6f} (1 m = {scale:.4f} units), "
          f"model rescaled in {time.time() - t0:.1f}s", flush=True)
    return scale
