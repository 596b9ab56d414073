"""Command-line entry points of the port.

Usage: python -m xrsfm_tpu_torch.cli run_matching <images_dir>
       <retrieval_path> <matching_type> <output_dir> [--device cuda]

Ported so far: run_matching (the JAX package's `xrsfm_tpu.cli
run_matching`, reference run_matching.cc).  --device names the device
explicitly; "cuda" without a GPU is an error.
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

    args = ap.parse_args(argv)
    if args.cmd == "run_matching":
        from .pipelines import run_matching as M

        M.main(args.images_dir, args.retrieval_path, args.matching_type,
               args.output_dir, device=args.device)


if __name__ == "__main__":
    main()
