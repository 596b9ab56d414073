"""Render a synthetic multi-view dataset (images, camera.txt, ground-truth
poses): the twin of scripts/synth_dataset.py, through utils/synth.

Scenes (ray-cast textured Lambertian planes):
  arc       (default) wall and floor viewed from an arc of cameras
  loop      square room, cameras on a full 360-degree circle looking
            tangentially: sequential mapping drifts until loop closure
  corridor  KITTI-like forward motion between two side walls and a floor

Usage: python -m xrsfm_tpu_torch.tools.synth_dataset <out_dir>
       [--n_cams 8] [--seed 3] [--scene arc] [--device cuda]

Output layout: utils/synth's module docstring.  The rendering runs on the
host; --device is checked like every tool's.
"""

import argparse

from ..device import resolve_device
from ..utils import synth


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n_cams", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--scene", default="arc", choices=sorted(synth.SCENES))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    synth.write_dataset(a.out_dir, a.n_cams, a.seed, scene=a.scene)
    print(f"wrote {a.n_cams} images ({a.scene}) to {a.out_dir}")


if __name__ == "__main__":
    main()
