"""Command-line entry points of the port.

Usage: python -m xrsfm_tpu_torch.cli run_matching <images_dir>
       <retrieval_path> <matching_type> <output_dir> [--n_devices N]
       [--device cuda]
       python -m xrsfm_tpu_torch.cli retrieve <images_dir> <output_dir>
       [--topk 25] [--num_words 64] [--device cuda]
       python -m xrsfm_tpu_torch.cli run_reconstruction <bin_dir>
       <camera_txt> <output_dir> [--init_id1 N --init_id2 N]
       [--correct_pose] [--snapshot_every N] [--resume] [--n_devices N]
       [--device cuda]
       python -m xrsfm_tpu_torch.cli run_triangulation <bin_dir>
       <model_dir> <output_dir> [--device cuda]
       python -m xrsfm_tpu_torch.cli rec_kitti <bin_dir> <seq_name>
       <output_dir> [--timestamp_path times.txt] [--device cuda]
       python -m xrsfm_tpu_torch.cli rec_1dsfm <bin_dir> <camera_info>
       <output_dir> [--n_devices N] [--device cuda]
       python -m xrsfm_tpu_torch.cli estimate_scale <images_dir>
       <model_dir> [--tag_length 0.113] [--device cuda]
       python -m xrsfm_tpu_torch.cli unpack_collect_data <input_path>
       <output_dir>
       python -m xrsfm_tpu_torch.cli <command> --config config.json

The JAX package's `xrsfm_tpu.cli` commands of the same names (reference
CMakeLists.txt:160-181: run_matching, run_reconstruction,
run_triangulation, rec_kitti, rec_1dsfm, estimate_scale,
unpack_collect_data; retrieve has no reference binary).  Every command
takes --config, a JSON file with the reference binaries' keys
(utils/config; positional arguments win over it), and --profile_dir, a
directory for a torch.profiler trace of the command (utils/profiling).
--device names the device explicitly; "cuda" without a GPU is an error.
--n_devices N > 1 shards matching or global BA over the first N GPUs
(parallel/), and is an error when fewer exist.
"""

from __future__ import annotations

import argparse
import sys


def _parser():
    ap = argparse.ArgumentParser(prog="xrsfm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, help_, device=True):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--config", default=None,
                       help="JSON config (reference-compatible keys)")
        p.add_argument("--profile_dir", default=None,
                       help="write a torch.profiler trace here")
        if device:
            p.add_argument("--device", default="cuda",
                           help="torch device to run on (default: cuda)")
        return p

    p = add("run_matching", "matching stage")
    p.add_argument("images_dir", nargs="?")
    p.add_argument("retrieval_path", nargs="?",
                   help="ranked-pairs retrieval.txt, or '' for none")
    p.add_argument("matching_type", nargs="?",
                   choices=["sequential", "retrieval", "covisibility"])
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--n_devices", type=int, default=1,
                   help="shard descriptor matching over this many devices")

    p = add("retrieve", "retrieval.txt from images (VLAD)")
    p.add_argument("images_dir", nargs="?")
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--topk", type=int, default=25)
    p.add_argument("--num_words", type=int, default=64)

    p = add("run_reconstruction", "incremental reconstruction")
    p.add_argument("bin_dir", nargs="?",
                   help="directory with ftr.bin and fp.bin")
    p.add_argument("camera_txt", nargs="?", help="single-camera cameras.txt")
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--init_id1", type=int, default=-1)
    p.add_argument("--init_id2", type=int, default=-1)
    p.add_argument("--correct_pose", action="store_true",
                   help="loop correction and the global pose polish")
    p.add_argument("--snapshot_every", type=int, default=0,
                   help="checkpoint the mapper state to "
                        "<output_dir>/snapshot.npz every N registrations")
    p.add_argument("--resume", action="store_true",
                   help="resume from <output_dir>/snapshot.npz if present")
    p.add_argument("--n_devices", type=int, default=1,
                   help="shard global BA over this many devices "
                        "(parallel/dist_ba; 1 = single-device)")

    p = add("run_triangulation", "triangulate known poses")
    p.add_argument("bin_dir", nargs="?",
                   help="directory with ftr.bin and fp.bin")
    p.add_argument("model_dir", nargs="?",
                   help="COLMAP model with the known poses")
    p.add_argument("output_dir", nargs="?")

    p = add("rec_kitti", "KITTI odometry reconstruction")
    p.add_argument("bin_dir", nargs="?",
                   help="directory with ftr.bin and fp.bin")
    p.add_argument("seq_name", nargs="?", help="sequence number, e.g. 00")
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--timestamp_path", default="",
                   help="KITTI times.txt for the TUM trajectory")

    p = add("rec_1dsfm", "1DSfM unordered reconstruction")
    p.add_argument("bin_dir", nargs="?",
                   help="directory with ftr.bin and fp.bin")
    p.add_argument("camera_info_path", nargs="?",
                   help="per-image SIMPLE_RADIAL camera_info.txt")
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--n_devices", type=int, default=1,
                   help="shard global BA (incl. intrinsics-refining GBA) "
                        "over this many devices")

    p = add("estimate_scale", "AprilTag metric scale")
    p.add_argument("images_dir", nargs="?")
    p.add_argument("model_dir", nargs="?")
    p.add_argument("--tag_length", type=float, default=0.113)

    p = add("unpack_collect_data", "unpack a phone capture", device=False)
    p.add_argument("input_path", nargs="?")
    p.add_argument("output_dir", nargs="?")
    return ap


def main(argv=None, stats=None):
    """Run one command.  stats (optional dict), for a caller in the same
    process: the pipeline of run_matching, run_reconstruction, rec_kitti
    or rec_1dsfm fills it as its main() documents.  Exits 1 when the
    pipeline failed."""
    argv = argv if argv is not None else sys.argv[1:]
    args = _parser().parse_args(argv)
    if args.config or any(v is None for k, v in vars(args).items()
                          if k not in ("cmd", "config", "profile_dir")):
        from .utils import config as C

        C.resolve(args.cmd, args, args.config)

    from .utils.profiling import maybe_trace

    with maybe_trace(args.profile_dir):
        ok = _dispatch(args, stats)
    if ok is None:
        sys.exit(1)


def _dispatch(args, stats=None):
    """Run the command; None when its pipeline failed."""
    if args.cmd == "run_matching":
        from .pipelines import run_matching as M

        return M.main(args.images_dir, args.retrieval_path,
                      args.matching_type, args.output_dir,
                      n_devices=args.n_devices, stats=stats,
                      device=args.device) or True
    if args.cmd == "retrieve":
        from .pipelines import retrieve as RV

        RV.main(args.images_dir, args.output_dir, args.topk, args.num_words,
                device=args.device)
        return True
    if args.cmd == "run_reconstruction":
        from .pipelines import run_reconstruction as R

        return R.main(args.bin_dir, args.camera_txt, args.output_dir,
                      args.init_id1, args.init_id2,
                      correct_pose=args.correct_pose,
                      snapshot_every=args.snapshot_every,
                      resume=args.resume, n_devices=args.n_devices,
                      stats=stats, device=args.device)
    if args.cmd == "run_triangulation":
        from .pipelines import run_triangulation as T

        T.main(args.bin_dir, args.model_dir, args.output_dir,
               device=args.device)
        return True
    if args.cmd == "rec_kitti":
        from .pipelines import rec_kitti as K

        return K.main(args.bin_dir, args.seq_name, args.output_dir,
                      args.timestamp_path, stats=stats, device=args.device)
    if args.cmd == "rec_1dsfm":
        from .pipelines import rec_1dsfm as U

        return U.main(args.bin_dir, args.camera_info_path, args.output_dir,
                      n_devices=args.n_devices, stats=stats,
                      device=args.device)
    if args.cmd == "estimate_scale":
        from .pipelines import estimate_scale as S

        S.main(args.images_dir, args.model_dir, args.tag_length,
               device=args.device)
        return True
    from .pipelines import unpack_collect_data as UC

    UC.main(args.input_path, args.output_dir)
    return True


if __name__ == "__main__":
    main()
