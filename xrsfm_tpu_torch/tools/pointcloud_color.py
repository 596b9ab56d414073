"""Write per-point RGB into a COLMAP model from the source images: the
twin of scripts/pointcloud_color.py (the reference's
scripts/pointcloud_color_calculator.py): the pixel under every
observation, averaged per 3D point, rewritten into points3D.bin.  One
fancy-index gather per image and one scatter-add into the accumulators;
images are read by utils/image_io in RGB order.

Usage: python -m xrsfm_tpu_torch.tools.pointcloud_color --image_dir DIR
       --bin_dir MODEL [--device cuda]
"""

import argparse
import os

import numpy as np

from ..device import resolve_device
from ..utils import image_io
from ..utils import io_colmap as IOC


def add_color(image_dir: str, bin_dir: str) -> int:
    """Returns the number of points that received a colour."""
    images = IOC.read_images_bin(os.path.join(bin_dir, "images.bin"))
    points = IOC.read_points3d_bin(os.path.join(bin_dir, "points3D.bin"))
    if not points:
        return 0
    max_id = max(points.keys())
    acc = np.zeros((max_id + 1, 3), np.float64)
    cnt = np.zeros(max_id + 1, np.int64)
    for img in images.values():
        try:
            rgb = image_io.read_rgb(os.path.join(image_dir, img.name))
        except (OSError, ValueError):  # unreadable: no colour from it
            continue
        h, w, _ = rgb.shape
        ids = np.asarray(img.point3D_ids, np.int64)
        xy = np.asarray(img.xys, np.float64)
        ok = (ids >= 0) & (ids <= max_id)
        x = xy[:, 0].astype(np.int64)
        y = xy[:, 1].astype(np.int64)
        ok &= (x >= 0) & (x < w) & (y >= 0) & (y < h)
        ids, x, y = ids[ok], x[ok], y[ok]
        np.add.at(acc, ids, rgb[y, x])
        np.add.at(cnt, ids, 1)
    n_colored = 0
    for pid, p in points.items():
        if cnt[pid] > 0:
            p.rgb = np.clip(acc[pid] / cnt[pid], 0, 255).astype(np.uint8)
            n_colored += 1
    IOC.write_points3d_bin(os.path.join(bin_dir, "points3D.bin"), points)
    return n_colored


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--bin_dir", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    n = add_color(a.image_dir, a.bin_dir)
    print(f"colored {n} points in {a.bin_dir}/points3D.bin", flush=True)


if __name__ == "__main__":
    main()
