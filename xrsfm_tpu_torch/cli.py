"""Command-line entry points of the port.

Usage: python -m xrsfm_tpu_torch.cli run_matching <images_dir>
       <retrieval_path> <matching_type> <output_dir> [--device cuda]
       python -m xrsfm_tpu_torch.cli retrieve <images_dir> <output_dir>
       [--topk 25] [--num_words 64] [--device cuda]
       python -m xrsfm_tpu_torch.cli run_reconstruction <bin_dir>
       <camera_txt> <output_dir> [--init_id1 N --init_id2 N]
       [--correct_pose] [--device cuda]
       python -m xrsfm_tpu_torch.cli run_triangulation <bin_dir>
       <model_dir> <output_dir> [--device cuda]
       python -m xrsfm_tpu_torch.cli rec_kitti <bin_dir> <seq_name>
       <output_dir> [--timestamp_path times.txt] [--device cuda]
       python -m xrsfm_tpu_torch.cli rec_1dsfm <bin_dir> <camera_info>
       <output_dir> [--device cuda]

The JAX package's `xrsfm_tpu.cli` commands of the same names (reference
run_matching.cc, run_reconstruction.cc, run_triangulation.cc,
rec_kitti.cc, rec_1dsfm.cc; retrieve has no reference binary).  --device names the device explicitly; "cuda" without a GPU
is an error.
"""

from __future__ import annotations

import argparse
import sys


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="xrsfm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run_matching", help="matching stage")
    p.add_argument("images_dir")
    p.add_argument("retrieval_path",
                   help="ranked-pairs retrieval.txt, or '' for none")
    p.add_argument("matching_type",
                   choices=["sequential", "retrieval", "covisibility"])
    p.add_argument("output_dir")
    _device_arg(p)

    p = sub.add_parser("retrieve", help="retrieval.txt from images (VLAD)")
    p.add_argument("images_dir")
    p.add_argument("output_dir")
    p.add_argument("--topk", type=int, default=25)
    p.add_argument("--num_words", type=int, default=64)
    _device_arg(p)

    p = sub.add_parser("run_reconstruction", help="incremental reconstruction")
    p.add_argument("bin_dir", help="directory with ftr.bin and fp.bin")
    p.add_argument("camera_txt", help="single-camera cameras.txt")
    p.add_argument("output_dir")
    p.add_argument("--init_id1", type=int, default=-1)
    p.add_argument("--init_id2", type=int, default=-1)
    p.add_argument("--correct_pose", action="store_true",
                   help="loop correction and the global pose polish")
    _device_arg(p)

    p = sub.add_parser("run_triangulation", help="triangulate known poses")
    p.add_argument("bin_dir", help="directory with ftr.bin and fp.bin")
    p.add_argument("model_dir", help="COLMAP model with the known poses")
    p.add_argument("output_dir")
    _device_arg(p)

    p = sub.add_parser("rec_kitti", help="KITTI odometry reconstruction")
    p.add_argument("bin_dir", help="directory with ftr.bin and fp.bin")
    p.add_argument("seq_name", help="sequence number, e.g. 00")
    p.add_argument("output_dir")
    p.add_argument("--timestamp_path", default="",
                   help="KITTI times.txt for the TUM trajectory")
    _device_arg(p)

    p = sub.add_parser("rec_1dsfm", help="1DSfM unordered reconstruction")
    p.add_argument("bin_dir", help="directory with ftr.bin and fp.bin")
    p.add_argument("camera_info_path",
                   help="per-image SIMPLE_RADIAL camera_info.txt")
    p.add_argument("output_dir")
    _device_arg(p)

    args = ap.parse_args(argv)
    if args.cmd == "run_matching":
        from .pipelines import run_matching as M

        M.main(args.images_dir, args.retrieval_path, args.matching_type,
               args.output_dir, device=args.device)
    elif args.cmd == "retrieve":
        from .pipelines import retrieve as RV

        RV.main(args.images_dir, args.output_dir, args.topk, args.num_words,
                device=args.device)
    elif args.cmd == "run_reconstruction":
        from .pipelines import run_reconstruction as R

        if R.main(args.bin_dir, args.camera_txt, args.output_dir,
                  args.init_id1, args.init_id2,
                  correct_pose=args.correct_pose,
                  device=args.device) is None:
            sys.exit(1)
    elif args.cmd == "run_triangulation":
        from .pipelines import run_triangulation as T

        T.main(args.bin_dir, args.model_dir, args.output_dir,
               device=args.device)
    elif args.cmd == "rec_kitti":
        from .pipelines import rec_kitti as K

        if K.main(args.bin_dir, args.seq_name, args.output_dir,
                  args.timestamp_path, device=args.device) is None:
            sys.exit(1)
    elif args.cmd == "rec_1dsfm":
        from .pipelines import rec_1dsfm as U

        if U.main(args.bin_dir, args.camera_info_path, args.output_dir,
                  device=args.device) is None:
            sys.exit(1)


if __name__ == "__main__":
    main()
