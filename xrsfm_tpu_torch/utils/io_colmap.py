"""COLMAP-compatible map I/O (binary + text) and trajectory output (host
numpy copy of xrsfm_tpu/utils/io_colmap.py, byte format unchanged).

Byte-compatible with COLMAP's cameras.bin / images.bin / points3D.bin so
outputs open in the COLMAP GUI, matching the reference's contract
(reference: src/utility/io_ecim.cc:9-301, docs/en/tutorial.md "The format of
output binary files is consistent with COLMAP").  Also parses the
reference's cameras.txt / camera_info text formats (io_ecim.hpp:22-77) and
writes TUM trajectories (io_ecim.hpp:108-122).

The in-memory representation is plain numpy dataclasses.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional

import numpy as np

from . import camera as Cam


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray  # raw COLMAP params (model-dependent length)


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # [4] (w, x, y, z) — Tcw
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [N, 2]
    point3D_ids: np.ndarray  # [N] int64, -1 = none


@dataclasses.dataclass
class ColmapPoint3D:
    point3D_id: int
    xyz: np.ndarray  # [3]
    rgb: np.ndarray  # [3] uint8
    error: float
    image_ids: np.ndarray  # [T] int32
    point2D_idxs: np.ndarray  # [T] int32


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            np_ = Cam.MODEL_NUM_PARAMS[model_id]
            params = np.frombuffer(f.read(8 * np_), "<f8").copy()
            cams[cid] = ColmapCamera(cid, model_id, int(w), int(h), params)
    return cams


def write_cameras_bin(path: str, cams: Dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid in sorted(cams):
            c = cams[cid]
            f.write(struct.pack("<iiQQ", c.camera_id, c.model_id, c.width, c.height))
            f.write(np.asarray(c.params, "<f8").tobytes())


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    imgs: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    off = 0
    (n,) = struct.unpack_from("<Q", buf, off)
    off += 8
    for _ in range(n):
        (iid,) = struct.unpack_from("<i", buf, off)
        off += 4
        qt = np.frombuffer(buf, "<f8", count=7, offset=off).copy()
        off += 56
        (cam_id,) = struct.unpack_from("<i", buf, off)
        off += 4
        end = off
        while buf[end] != 0:
            end += 1
        name = bytes(buf[off:end]).decode("utf-8")
        off = end + 1
        (npts,) = struct.unpack_from("<Q", buf, off)
        off += 8
        rec = np.frombuffer(
            buf, np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<i8")]),
            count=npts, offset=off,
        )
        off += npts * 24
        imgs[iid] = ColmapImage(
            image_id=iid,
            qvec=qt[:4],
            tvec=qt[4:],
            camera_id=cam_id,
            name=name,
            xys=np.stack([rec["x"], rec["y"]], -1).copy() if npts else np.zeros((0, 2)),
            point3D_ids=rec["pid"].copy() if npts else np.zeros(0, np.int64),
        )
    return imgs


def write_images_bin(path: str, imgs: Dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid in sorted(imgs):
            im = imgs[iid]
            f.write(struct.pack("<i", im.image_id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\0")
            npts = len(im.xys)
            f.write(struct.pack("<Q", npts))
            rec = np.empty(npts, np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<i8")]))
            rec["x"] = im.xys[:, 0]
            rec["y"] = im.xys[:, 1]
            rec["pid"] = im.point3D_ids
            f.write(rec.tobytes())


def read_points3d_bin(path: str) -> Dict[int, ColmapPoint3D]:
    pts: Dict[int, ColmapPoint3D] = {}
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    off = 0
    (n,) = struct.unpack_from("<Q", buf, off)
    off += 8
    for _ in range(n):
        (pid,) = struct.unpack_from("<q", buf, off)
        off += 8
        xyz = np.frombuffer(buf, "<f8", count=3, offset=off).copy()
        off += 24
        rgb = np.frombuffer(buf, "u1", count=3, offset=off).copy()
        off += 3
        (err,) = struct.unpack_from("<d", buf, off)
        off += 8
        (tl,) = struct.unpack_from("<Q", buf, off)
        off += 8
        tr = np.frombuffer(buf, "<i4", count=tl * 2, offset=off).reshape(tl, 2)
        off += tl * 8
        pts[pid] = ColmapPoint3D(
            point3D_id=pid,
            xyz=xyz,
            rgb=rgb,
            error=err,
            image_ids=tr[:, 0].copy(),
            point2D_idxs=tr[:, 1].copy(),
        )
    return pts


def write_points3d_bin(path: str, pts: Dict[int, ColmapPoint3D]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid in sorted(pts):
            p = pts[pid]
            f.write(struct.pack("<q", p.point3D_id))
            f.write(np.asarray(p.xyz, "<f8").tobytes())
            f.write(np.asarray(p.rgb, "u1").tobytes())
            f.write(struct.pack("<d", float(p.error)))
            tl = len(p.image_ids)
            f.write(struct.pack("<Q", tl))
            tr = np.empty((tl, 2), "<i4")
            tr[:, 0] = p.image_ids
            tr[:, 1] = p.point2D_idxs
            f.write(tr.tobytes())


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    """COLMAP cameras.txt: CAMERA_ID MODEL W H PARAMS...
    (reference: ReadCamerasText, io_ecim.hpp:22-49)."""
    cams: Dict[int, ColmapCamera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            model_id = Cam.MODEL_IDS[parts[1]]
            w, h = int(parts[2]), int(parts[3])
            params = np.asarray([float(x) for x in parts[4:]], np.float64)
            cams[cid] = ColmapCamera(cid, model_id, w, h, params)
    return cams


def read_camera_info(path: str):
    """Per-image SIMPLE_RADIAL camera list (the 1DSfM `camera_info` format:
    image_name SIMPLE_RADIAL w h f cx cy k — reference: ReadCameraInfo,
    io_ecim.hpp:51-77; rec_1dsfm.cc:46-55 invalidates zero-distortion
    entries)."""
    name2cid: Dict[str, int] = {}
    cams: Dict[int, ColmapCamera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or len(line) < 10:
                continue
            parts = line.split()
            name, model_name = parts[0], parts[1]
            if model_name != "SIMPLE_RADIAL":
                raise ValueError(f"unsupported model {model_name}")
            w, h = int(parts[2]), int(parts[3])
            params = np.asarray([float(x) for x in parts[4:8]], np.float64)
            cid = len(cams)
            name2cid[name] = cid
            cams[cid] = ColmapCamera(cid, Cam.SIMPLE_RADIAL, w, h, params)
    return name2cid, cams


def write_trajectory_tum(
    path: str,
    names_or_stamps: List,
    q_wc: np.ndarray,
    t_wc: np.ndarray,
    registered: Optional[np.ndarray] = None,
):
    """TUM format: `stamp tx ty tz qx qy qz qw` with world-from-camera pose
    (reference: WriteTrajectory, io_ecim.hpp:108-122)."""
    with open(path, "w") as f:
        for i, stamp in enumerate(names_or_stamps):
            if registered is not None and not registered[i]:
                continue
            t = t_wc[i]
            q = q_wc[i]  # (w, x, y, z)
            f.write(
                f"{stamp} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n"
            )


def load_timestamps(path: str) -> List[float]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(float(line.split()[0]))
    return out
