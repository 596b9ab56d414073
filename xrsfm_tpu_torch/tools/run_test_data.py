"""End-to-end pipeline on a workspace directory: the twin of
scripts/run_test_data.py (the reference's scripts/run_test_data.py:27-56):
the matching stage, the reconstruction stage, point colours, then the
optional tag scale, each through the port's CLI.  Works on a dataset from
tools.synth_dataset or any workspace with images/ and camera.txt.

Usage: python -m xrsfm_tpu_torch.tools.run_test_data <workspace>
       [--matching sequential] [--estimate_scale] [--correct_pose]
       [--tag_length 0.113] [--device cuda]

Writes <workspace>/bins (ftr.bin, fp.bin, size.bin) and <workspace>/model;
exits 1 when no model was written.
"""

import argparse
import os
import sys
import time

from .. import cli
from ..device import resolve_device
from .pointcloud_color import add_color


def main(argv=None, stats=None) -> int:
    """Returns the number of points coloured.  stats (optional dict)
    receives "matching" and "reconstruction" (the stages' own stats, as
    pipelines.run_matching and run_reconstruction fill them) and the
    host-clock seconds matching_s, reconstruction_s and color_s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("workspace")
    ap.add_argument("--matching", default="sequential",
                    choices=["sequential", "retrieval", "covisibility"])
    ap.add_argument("--estimate_scale", action="store_true")
    ap.add_argument("--correct_pose", action="store_true")
    ap.add_argument("--tag_length", type=float, default=0.113)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    stats = {} if stats is None else stats
    stats.update(matching={}, reconstruction={})

    ws = a.workspace
    images = os.path.join(ws, "images")
    retrieval = os.path.join(ws, "retrieval.txt")
    bin_dir = os.path.join(ws, "bins")
    out_dir = os.path.join(ws, "model")
    dev = ["--device", a.device]

    t0 = time.perf_counter()
    cli.main(["run_matching", images, retrieval, a.matching, bin_dir] + dev,
             stats=stats["matching"])
    t1 = time.perf_counter()
    rec_args = ["run_reconstruction", bin_dir, os.path.join(ws, "camera.txt"),
                out_dir] + dev
    if a.correct_pose:
        rec_args.append("--correct_pose")
    try:
        cli.main(rec_args, stats=stats["reconstruction"])
    except SystemExit as e:  # the CLI exits 1 when the mapper fails
        if e.code != 1:
            raise
    t2 = time.perf_counter()
    stats.update(matching_s=t1 - t0, reconstruction_s=t2 - t1)
    if not os.path.exists(os.path.join(out_dir, "images.bin")):
        print("[run_test_data] reconstruction produced no model", flush=True)
        sys.exit(1)

    # per-point RGB from the source images (reference:
    # scripts/pointcloud_color_calculator.py)
    n_colored = add_color(images, out_dir)
    stats["color_s"] = time.perf_counter() - t2
    print(f"[run_test_data] colored {n_colored} points", flush=True)

    if a.estimate_scale:
        cli.main(["estimate_scale", images, out_dir, "--tag_length",
                  str(a.tag_length)] + dev)
    return n_colored


if __name__ == "__main__":
    main()
