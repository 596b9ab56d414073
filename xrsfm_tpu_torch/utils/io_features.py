"""Binary feature / frame-pair I/O, byte-compatible with the reference.

Re-implements the reference's raw-struct formats so artifacts interoperate
(ftr.bin / fp.bin / size.bin / retrieval ranks — reference:
src/utility/io_feature.hpp:19-212, io_base.hpp:12-88).  Layouts verified
against the reference source:

  ftr.bin:  int32 num_frames; per frame: name '\0', int32 n,
            n x (float32 x, y, size, angle), n x 128 uint8 descriptors.
  fp.bin:   uint64 num_pairs; per pair: int32 id1, id2, uint64 n_matches,
            n x Match{int32 id1, int32 id2, float64 distance} (16B packed),
            3x3 float64 E (column-major), int32 inlier_num, n x int8 mask.
  size.bin: int32 num_frames; per frame: int32 width, int32 height.

A numpy-only copy of xrsfm_tpu/utils/io_features.py (that package's
``utils`` imports JAX on import), with the same byte formats, so files
written by either package are read by the other.  It also holds the
shape-bucketing helpers of xrsfm_tpu/mapper/kernels.py.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List

import numpy as np

_MATCH_DTYPE = np.dtype(
    [("id1", "<i4"), ("id2", "<i4"), ("distance", "<f8")]
)  # 16 bytes, matches C++ struct layout (src/base/types.h:14-21)


@dataclasses.dataclass
class FrameFeatures:
    name: str
    keypoints: np.ndarray  # [N, 4] float32: x, y, size, angle
    descriptors: np.ndarray  # [N, 128] uint8


@dataclasses.dataclass
class FramePairData:
    id1: int
    id2: int
    matches: np.ndarray  # [M, 2] int32 feature index pairs
    distances: np.ndarray  # [M] float64
    E: np.ndarray  # [3, 3] float64
    inlier_num: int
    inlier_mask: np.ndarray  # [M] bool

    def inlier_matches(self) -> np.ndarray:
        return self.matches[self.inlier_mask]


def _read_cstr(buf: memoryview, off: int):
    end = off
    while buf[end] != 0:
        end += 1
    return bytes(buf[off:end]).decode("utf-8"), end + 1


def read_features(path: str, with_descs: bool = True) -> List[FrameFeatures]:
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    off = 0
    (num_frames,) = struct.unpack_from("<i", buf, off)
    off += 4
    frames = []
    for _ in range(num_frames):
        name, off = _read_cstr(buf, off)
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        kps = np.frombuffer(buf, "<f4", count=n * 4, offset=off).reshape(n, 4).copy()
        off += n * 16
        # the file always stores descriptors (write_features default);
        # with_descs=False skips them but must still advance the cursor
        if with_descs:
            descs = (
                np.frombuffer(buf, "u1", count=n * 128, offset=off)
                .reshape(n, 128)
                .copy()
            )
        else:
            descs = np.zeros((n, 128), np.uint8)
        off += n * 128
        frames.append(FrameFeatures(name=name, keypoints=kps, descriptors=descs))
    return frames


def write_features(path: str, frames: List[FrameFeatures], with_descs: bool = True):
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(frames)))
        for fr in frames:
            f.write(fr.name.encode("utf-8") + b"\0")
            n = len(fr.keypoints)
            f.write(struct.pack("<i", n))
            f.write(np.ascontiguousarray(fr.keypoints, "<f4").tobytes())
            if with_descs:
                f.write(np.ascontiguousarray(fr.descriptors, "u1").tobytes())


def read_frame_pairs(path: str) -> List[FramePairData]:
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    off = 0
    (num_pairs,) = struct.unpack_from("<Q", buf, off)
    off += 8
    pairs = []
    for _ in range(num_pairs):
        id1, id2 = struct.unpack_from("<ii", buf, off)
        off += 8
        (nm,) = struct.unpack_from("<Q", buf, off)
        off += 8
        m = np.frombuffer(buf, _MATCH_DTYPE, count=nm, offset=off)
        off += nm * 16
        E = (
            np.frombuffer(buf, "<f8", count=9, offset=off)
            .reshape(3, 3)
            .T.copy()  # stored column-major (Eigen default)
        )
        off += 72
        (inlier_num,) = struct.unpack_from("<i", buf, off)
        off += 4
        mask = np.frombuffer(buf, "i1", count=nm, offset=off).astype(bool)
        off += nm
        if id1 == id2:  # reference drops self-pairs on read
            continue
        pairs.append(
            FramePairData(
                id1=id1,
                id2=id2,
                matches=np.stack([m["id1"], m["id2"]], axis=-1).astype(np.int32),
                distances=m["distance"].copy(),
                E=E,
                inlier_num=inlier_num,
                inlier_mask=mask,
            )
        )
    return pairs


def write_frame_pairs(path: str, pairs: List[FramePairData]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pairs)))
        for p in pairs:
            nm = len(p.matches)
            f.write(struct.pack("<ii", p.id1, p.id2))
            f.write(struct.pack("<Q", nm))
            m = np.empty(nm, _MATCH_DTYPE)
            m["id1"] = p.matches[:, 0]
            m["id2"] = p.matches[:, 1]
            m["distance"] = p.distances if p.distances is not None else 0.0
            f.write(m.tobytes())
            f.write(np.ascontiguousarray(p.E.T, "<f8").tobytes())  # column-major
            f.write(struct.pack("<i", int(p.inlier_num)))
            f.write(np.asarray(p.inlier_mask, "i1").tobytes())


def read_image_size(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<i", buf, 0)
    return np.frombuffer(buf, "<i4", count=n * 2, offset=4).reshape(n, 2).copy()


def write_image_size(path: str, sizes: np.ndarray):
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(sizes)))
        f.write(np.ascontiguousarray(sizes, "<i4").tobytes())


def load_retrieval_rank(path: str, name_to_id: Dict[str, int]) -> Dict[int, List[int]]:
    """Parse `name1 name2` ranked-pair lines into id1 -> [id2, ...] in file
    order (reference: LoadRetrievalRank, io_feature.hpp:180-212)."""
    id2rank: Dict[int, List[int]] = {}
    missing = set()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            n1, n2 = parts[0], parts[1]
            if n1 not in name_to_id:
                missing.add(n1)
                continue
            if n2 not in name_to_id:
                missing.add(n2)
                continue
            id2rank.setdefault(name_to_id[n1], []).append(name_to_id[n2])
    for name in sorted(missing):
        print(f"Warning : missing {name} in name map")
    return id2rank


def load_image_names(dir_path: str) -> List[str]:
    return sorted(os.listdir(dir_path))


def bucket(n: int, lo: int = 64) -> int:
    """Smallest lo * 2^k >= n."""
    b = lo
    while b < n:
        b *= 2
    return b


def pad_rows(a: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if len(a) >= n:
        return a[:n]
    pad = np.full((n - len(a),) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)
