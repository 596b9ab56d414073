"""Feature-level synthetic workspaces at reference scale (no images): the
twin of scripts/synth_features.py, through
utils/synth.write_features_workspace (the same bytes for the same
arguments).

Scenes:
  kitti      forward-motion square circuit with loop-closure pairs
  unordered  landmark ring: cameras around one building (1DSfM class)
  tour       a street of separate facades walked past

Usage: python -m xrsfm_tpu_torch.tools.synth_features <out_dir>
       [--scene kitti] [--n_frames 1000] [--seed 0] [--per_image_cameras]
       [--focal_noise 0.08] [--descriptors] [--distractors 0]
       [--device cuda]
"""

import argparse

from ..device import resolve_device
from ..utils import synth


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--scene", default="kitti",
                    choices=["kitti", "unordered", "tour"])
    ap.add_argument("--n_frames", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--per_image_cameras", action="store_true",
                    help="1DSfM regime: per-image SIMPLE_RADIAL + "
                         "noisy-focal camera_info.txt")
    ap.add_argument("--focal_noise", type=float, default=0.08)
    ap.add_argument("--descriptors", action="store_true",
                    help="synthesize matchable descriptors + size.bin")
    ap.add_argument("--distractors", type=int, default=0,
                    help="unordered scene: append this many unregistrable "
                         "junk frames")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    w = synth.write_features_workspace(
        a.out_dir, a.scene, a.n_frames, a.seed,
        per_image_cameras=a.per_image_cameras, focal_noise=a.focal_noise,
        descriptors=a.descriptors, distractors=a.distractors)
    print(f"wrote {a.scene} workspace: {len(w['names'])} frames, "
          f"{w['n_points']} points, {w['n_obs']} observations, "
          f"{w['n_pairs']} pairs -> {a.out_dir}", flush=True)


if __name__ == "__main__":
    main()
