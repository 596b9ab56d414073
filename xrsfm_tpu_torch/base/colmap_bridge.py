"""SfMMap -> COLMAP-format conversion (host numpy copy of
xrsfm_tpu/base/colmap_bridge.py; reference: WriteColMapDataBinary,
src/utility/io_ecim.cc:86-301).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .map import SfMMap
from ..utils import io_colmap as IO


def map_to_colmap(m: SfMMap, out_dir: str):
    """Write cameras.bin / images.bin / points3D.bin for the registered
    portion of the map."""
    os.makedirs(out_dir, exist_ok=True)
    cams: Dict[int, IO.ColmapCamera] = {}
    for cid, (model_id, raw, w, h) in m.camera_models.items():
        cams[cid] = IO.ColmapCamera(cid, model_id, w, h, np.asarray(raw))
    imgs: Dict[int, IO.ColmapImage] = {}
    for f in range(m.num_frames):
        if not m.registered[f]:
            continue
        tid = m.track_of[f].astype(np.int64).copy()
        tid[tid >= 0] = np.where(
            m.track_valid[tid[tid >= 0]], tid[tid >= 0], -1
        )
        imgs[f + 1] = IO.ColmapImage(
            image_id=f + 1,
            qvec=np.asarray(m.q[f], np.float64),
            tvec=np.asarray(m.t[f], np.float64),
            camera_id=int(m.cam_of_frame[f]),
            name=m.names[f],
            xys=np.asarray(m.kps[f], np.float64),
            point3D_ids=tid,
        )
    pts: Dict[int, IO.ColmapPoint3D] = {}
    for t in np.nonzero(m.track_valid[: m.num_tracks])[0]:
        obs = m.track_obs[int(t)]
        if not obs:
            continue
        pts[int(t)] = IO.ColmapPoint3D(
            point3D_id=int(t),
            xyz=np.asarray(m.track_xyz[t], np.float64),
            rgb=np.array([128, 128, 128], np.uint8),
            error=float(m.track_error[t]),
            image_ids=np.asarray([f + 1 for f in obs], np.int32),
            point2D_idxs=np.asarray(list(obs.values()), np.int32),
        )
    IO.write_cameras_bin(os.path.join(out_dir, "cameras.bin"), cams)
    IO.write_images_bin(os.path.join(out_dir, "images.bin"), imgs)
    IO.write_points3d_bin(os.path.join(out_dir, "points3D.bin"), pts)
    return len(imgs), len(pts)


def write_trajectory(m: SfMMap, path: str, timestamps=None):
    """TUM trajectory of registered frames (reference: WriteTrajectory,
    io_ecim.hpp:108-122), in float64."""
    q = np.asarray(m.q, np.float64)  # (w, x, y, z) Tcw
    t = np.asarray(m.t, np.float64)
    qwc = q * np.array([1.0, -1.0, -1.0, -1.0])
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(-1, 3, 3)
    twc = -np.einsum("fji,fj->fi", R, t)  # camera center = -R^T t
    stamps = timestamps if timestamps is not None else m.names
    IO.write_trajectory_tum(path, list(stamps), qwc, twc, m.registered)
