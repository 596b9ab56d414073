"""Unpack a phone RGB capture into per-frame images and timestamps
(host copy of xrsfm_tpu/pipelines/unpack_collect_data.py; reference:
src/unpack_collect_data.cc:6-54, the RGBCaptureTool binary stream).

Usage: python -m xrsfm_tpu_torch.cli unpack_collect_data <input_path>
       <output_dir>

The stream is repeated records of a little-endian double timestamp, an
int32 JPEG size and that many bytes of JPEG data (`<di`).  Writes
<output_dir>/images/NNNNNN.jpg and timestamps.txt, byte for byte as the
JAX package does.
"""

from __future__ import annotations

import os
import struct


def main(input_path: str, output_dir: str):
    img_dir = os.path.join(output_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    stamps = []
    with open(input_path, "rb") as f:
        idx = 0
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            ts, size = struct.unpack("<di", head)
            blob = f.read(size)
            if len(blob) < size:
                break
            with open(os.path.join(img_dir, f"{idx:06d}.jpg"), "wb") as out:
                out.write(blob)
            stamps.append(ts)
            idx += 1
    with open(os.path.join(output_dir, "timestamps.txt"), "w") as f:
        for ts in stamps:
            f.write(f"{ts}\n")
    print(f"[unpack] {len(stamps)} frames -> {img_dir}", flush=True)
    return len(stamps)
