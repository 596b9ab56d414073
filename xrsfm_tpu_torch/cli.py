"""Command-line entry points of the port.

Usage: python -m xrsfm_tpu_torch.cli run_matching <images_dir>
       <retrieval_path> <matching_type> <output_dir> [--device cuda]
       python -m xrsfm_tpu_torch.cli run_reconstruction <bin_dir>
       <camera_txt> <output_dir> [--init_id1 N --init_id2 N] [--device cuda]

Ported so far: run_matching and run_reconstruction (the JAX package's
`xrsfm_tpu.cli` commands of the same names; reference run_matching.cc,
run_reconstruction.cc).  --device names the device explicitly; "cuda"
without a GPU is an error.
"""

from __future__ import annotations

import argparse
import sys


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
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")

    p = sub.add_parser("run_reconstruction", help="incremental reconstruction")
    p.add_argument("bin_dir", help="directory with ftr.bin and fp.bin")
    p.add_argument("camera_txt", help="single-camera cameras.txt")
    p.add_argument("output_dir")
    p.add_argument("--init_id1", type=int, default=-1)
    p.add_argument("--init_id2", type=int, default=-1)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")

    args = ap.parse_args(argv)
    if args.cmd == "run_matching":
        from .pipelines import run_matching as M

        M.main(args.images_dir, args.retrieval_path, args.matching_type,
               args.output_dir, device=args.device)
    elif args.cmd == "run_reconstruction":
        from .pipelines import run_reconstruction as R

        if R.main(args.bin_dir, args.camera_txt, args.output_dir,
                  args.init_id1, args.init_id2, device=args.device) is None:
            sys.exit(1)


if __name__ == "__main__":
    main()
