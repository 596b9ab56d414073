"""A process of the port's multi-process BA test (tests/test_torch_parallel.py):
it joins a Gloo group through a file store, builds the pod mesh of its CPU
shards and runs parallel/dist_ba.solve_distributed on the problem it is
given, then writes the solved state's checksum.  Started with the spawn
method; imports torch and the port only."""

import json

import numpy as np
import torch


def gloo_solve(rank, world, init_method, shards_per_process, problem,
               max_iters, out_path):
    torch.set_num_threads(2)
    import torch.distributed as dist

    from xrsfm_tpu_torch.optim.ba import BAProblem
    from xrsfm_tpu_torch.parallel import checksum, dist_ba, mesh

    mesh.initialize_distributed(init_method, world, rank, device="cpu",
                                timeout_s=60.0)
    try:
        pod = mesh.make_pod_mesh([torch.device("cpu")] * shards_per_process)
        sol, cost = dist_ba.solve_distributed(
            pod, BAProblem.from_numpy("cpu", **problem), max_iters=max_iters,
            axis=("dcn", "ici"))
        out = {"rank": rank, "cost": cost, "shape": pod.shape,
               "checksum": checksum.pytree_checksum(
                   {"q": sol.cam_q, "t": sol.cam_t, "x": sol.points})}
        with open(out_path, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def problem_arrays(prob):
    """numpy arrays of a port BAProblem's fields, to send to a process."""
    return {k: np.asarray(v.cpu().numpy()) for k, v in vars(prob).items()
            if v is not None}
