"""KITTI odometry runner: the twin of scripts/run_kitti.py (the
reference's run_kitti_matching.py / run_kitti_reconstruction.py): for each
sequence, sequential matching on image_0, then rec_kitti, through the
port's CLI.

Usage: python -m xrsfm_tpu_torch.tools.run_kitti <kitti_root> <workspace>
       [--seqs 00 01 ...] [--device cuda]

Expects <kitti_root>/<seq>/image_0/*.png and an optional times.txt; writes
<workspace>/<seq>/bins and <workspace>/<seq>/model.
"""

import argparse
import os

from .. import cli
from ..device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kitti_root")
    ap.add_argument("workspace")
    ap.add_argument("--seqs", nargs="*",
                    default=[f"{i:02d}" for i in range(11)])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    dev = ["--device", a.device]
    for seq in a.seqs:
        images = os.path.join(a.kitti_root, seq, "image_0")
        if not os.path.isdir(images):
            print(f"skip {seq}: no {images}")
            continue
        ws = os.path.join(a.workspace, seq)
        bins = os.path.join(ws, "bins")
        model = os.path.join(ws, "model")
        cli.main(["run_matching", images, "", "sequential", bins] + dev)
        stamps = os.path.join(a.kitti_root, seq, "times.txt")
        args = ["rec_kitti", bins, seq, model] + dev
        if os.path.exists(stamps):
            args += ["--timestamp_path", stamps]
        cli.main(args)


if __name__ == "__main__":
    main()
