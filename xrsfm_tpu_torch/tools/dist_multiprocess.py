"""Multi-process distributed BA dry run (the process axis, for real): the
twin of scripts/dist_multiprocess.py.

Starts --procs coordinated processes that join one torch.distributed group
through parallel/mesh.initialize_distributed at a file:// store under
--workdir: NCCL on CUDA, where rank r takes card r (more processes than
cards raise here, before anything starts, as make_mesh does), Gloo on the
CPU.  Each builds the pod mesh (dcn = processes, ici = 4 shards of its
device) with make_pod_mesh and runs parallel/dist_ba.solve_distributed on
bench.py's BA problem (utils/synth.ba_problem) sharded over both axes, in
the COO layout (the port's sharded solve has no camera-major ELL yet; the
JAX script's shards are ELL tables).  Rank 0 prints the final
cost; the parent then runs the same solve in one process holding all the
shards and gates cost parity at 1%.  The shard count stays fixed across
process layouts, so the observations shard identically and only the
process boundary moves (the port's cross-shard sums fold in shard order,
so the two are bit-identical in practice).

Usage:
  python -m xrsfm_tpu_torch.tools.dist_multiprocess [--procs 2]
      [--cams 50] [--pts 5000] [--iters 5] [--seed 0] [--sweep]
      [--workdir DIR] [--timeout 900] [--device cuda]
Prints one JSON line: {"procs":N, "cost_multi":..., "cost_single":...,
"parity_pct":..., "ok":true}; with --sweep, one per size and seed and a
summary line.  Exits 1 when parity fails.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import uuid

import torch

from ..device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (cams, pts, iters) sweep of the JAX script, with its seeds
SWEEP_SIZES = [(30, 2000, 5), (40, 4000, 8), (25, 1500, 6), (60, 6000, 5),
               (50, 3000, 10)]
SWEEP_SEEDS = [0, 7]
SHARDS_PER_PROC = 4


def worker(rank, nproc, shards, init_method, args):
    """One process of the group: join, build the pod mesh, solve; rank 0
    prints its costs as a JSON line."""
    import torch.distributed as dist

    from ..optim.ba import BAProblem
    from ..parallel import dist_ba, mesh as pmesh
    from ..utils import synth

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(2)
    n, pid = pmesh.initialize_distributed(init_method, nproc, rank,
                                          device=dev,
                                          timeout_s=float(args.timeout))
    try:
        if (n, pid) != (nproc, rank):
            raise RuntimeError(f"joined as {pid} of {n}, not {rank} of "
                               f"{nproc}")
        mesh = pmesh.make_pod_mesh([dev] * shards)
        prob = BAProblem.from_numpy(dev, **synth.ba_problem(
            args.cams, args.pts, args.obs_per_pt, seed=args.seed))
        stats = {}
        dist_ba.solve_distributed(mesh, prob, max_iters=args.iters,
                                  axis=("dcn", "ici"), stats=stats)
        if rank == 0:
            print(json.dumps({
                "n_obs": int(prob.obs_cam.shape[0]),
                "initial_cost": stats["initial_cost"],
                "final_cost": stats["final_cost"],
            }), flush=True)
    finally:
        dist.destroy_process_group()


def launch(nproc, shards, args):
    """Start nproc worker processes of shards shards each; return rank 0's
    JSON record.  A worker that fails or outlives --timeout is an error
    (every worker is stopped first)."""
    store = os.path.join(os.path.abspath(args.workdir),
                         f"store_{nproc}_{uuid.uuid4().hex}")
    procs = []
    for r in range(nproc):
        cmd = [sys.executable, "-m", "xrsfm_tpu_torch.tools.dist_multiprocess",
               "--worker_rank", str(r), "--procs", str(nproc),
               "--shards", str(shards),
               "--init_method", f"file://{store}",
               "--cams", str(args.cams), "--pts", str(args.pts),
               "--obs_per_pt", str(args.obs_per_pt),
               "--iters", str(args.iters), "--seed", str(args.seed),
               "--timeout", str(args.timeout), "--device", args.device]
        procs.append(subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        outs = [p.communicate(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        if os.path.exists(store):
            os.remove(store)
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stderr.write(f"--- rank {r} rc={p.returncode}\n{out}\n{err}\n")
            raise RuntimeError(f"worker rank {r} failed")
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def compare(args):
    """The parity record of args.procs processes against one process with
    the same shards in all (gate 1%)."""
    multi = launch(args.procs, SHARDS_PER_PROC, args)
    single = launch(1, args.procs * SHARDS_PER_PROC, args)
    parity = abs(multi["final_cost"] - single["final_cost"]) / max(
        single["final_cost"], 1e-9)
    return {
        "procs": args.procs,
        "cams": args.cams,
        "pts": args.pts,
        "iters": args.iters,
        "seed": args.seed,
        "n_obs": multi["n_obs"],
        "cost_multi": multi["final_cost"],
        "cost_single": single["final_cost"],
        "parity_pct": round(100.0 * parity, 4),
        "ok": bool(parity < 0.01),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--shards", type=int, default=SHARDS_PER_PROC,
                    help=argparse.SUPPRESS)  # a worker's shard count
    ap.add_argument("--cams", type=int, default=50)
    ap.add_argument("--pts", type=int, default=5000)
    ap.add_argument("--obs_per_pt", type=int, default=7)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="run the 5-size x 2-seed parity sweep")
    ap.add_argument("--workdir", default=tempfile.gettempdir())
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds a worker, and a collective, may take")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker_rank", type=int, default=-1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--init_method", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker_rank >= 0:
        worker(args.worker_rank, args.procs, args.shards, args.init_method,
               args)
        return None
    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.procs > torch.cuda.device_count():
        raise RuntimeError(
            f"--procs {args.procs} on CUDA needs a card a process, but only "
            f"{torch.cuda.device_count()} CUDA device(s) exist")
    os.makedirs(args.workdir, exist_ok=True)

    if args.sweep:
        records = []
        for cams, pts, iters in SWEEP_SIZES:
            for seed in SWEEP_SEEDS:
                args.cams, args.pts, args.iters, args.seed = (
                    cams, pts, iters, seed)
                rec = compare(args)
                records.append(rec)
                print(json.dumps(rec), flush=True)
        out = {
            "sweep": len(records),
            "max_parity_pct": max(r["parity_pct"] for r in records),
            "ok": all(r["ok"] for r in records),
        }
    else:
        out = compare(args)
    print(json.dumps(out), flush=True)
    if not out["ok"]:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
