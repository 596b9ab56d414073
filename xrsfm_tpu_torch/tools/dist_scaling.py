"""Distributed-BA scaling shape over 1, 2, 4 and 8 shards: the twin of
scripts/dist_scaling.py.

Runs parallel/dist_ba.solve_distributed on bench.py's BA problem
(utils/synth.ba_problem, 139,265 observations at 200 cameras and 20,000
points), in its COO layout (the port's sharded solve has no camera-major
ELL yet; the JAX script's shards are ELL tables), over a mesh of n shards
of one device, `Mesh([device] * n)`: on a
GPU, n shards of that card; on the CPU, n virtual shards.  The JAX script
needs a process per count (its device count is fixed when its backend
starts); the port's meshes are built per call, so one process runs every
count.  Records, per count, the cost parity (the sharded sums fold in
shard order) and LM iterations/s: 2 warm-up iterations, then a timed solve
of --iters (8), synchronised, on the host clock.

Prints one JSON line: {"1": {n_devices, iters_per_s, final_cost, n_obs},
"2": {...}, ...}.

Usage: python -m xrsfm_tpu_torch.tools.dist_scaling [--cams 200]
       [--pts 20000] [--iters 8] [--device cuda]
"""

import argparse
import json
import time

import torch

from ..device import resolve_device
from ..optim.ba import BAProblem
from ..parallel.dist_ba import solve_distributed
from ..parallel.mesh import Mesh
from ..utils import synth


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=200)
    ap.add_argument("--pts", type=int, default=20000)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prob = BAProblem.from_numpy(dev, **synth.ba_problem(a.cams, a.pts))
    n_obs = int(prob.obs_cam.shape[0])
    out = {}
    for n in (1, 2, 4, 8):
        mesh = Mesh([dev] * n)
        solve_distributed(mesh, prob, max_iters=2)  # warm-up
        st = {}
        sync()
        t0 = time.perf_counter()
        _, cost = solve_distributed(mesh, prob, max_iters=a.iters, stats=st)
        sync()
        dt = time.perf_counter() - t0
        out[str(n)] = {
            "n_devices": n, "iters_per_s": round(st["iters"] / dt, 3),
            "final_cost": round(float(cost), 2), "n_obs": n_obs,
        }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
