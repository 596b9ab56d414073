"""Observation-sharded Schur-complement bundle adjustment over a device mesh
(port of xrsfm_tpu/parallel/dist_ba.py).

  * The COO observation table is padded with weight-0 rows to a multiple
    of the shard count and split into contiguous slices, one per shard,
    each on its shard's device; residuals, Jacobians and the per-shard
    partial sums run there.
  * Cameras and points are replicated: the reduced blocks, the PCG
    vectors and the LM state live on the home device (the mesh's first)
    and are copied to the other devices where a shard needs them.
  * Every sum that crosses shards goes through one rule, the JAX
    package's r5 determinism (dist_ba.py:131-154): each shard's partial is
    copied to the home device and the partials are summed by a left fold
    in global shard order; across processes, one all_gather of every
    process's stacked partials comes first, then the same fold.  The
    solve is bit-identical for a given shard layout whatever the process
    layout.  deterministic=False sums in one process with a plain sum and
    across processes with all_reduce.
  * The LM step is the single-device solver's: its normal-block build and
    Schur solve take a reduce_fn hook (optim/ba.py) that this module fills
    with the rule above.

The JAX package shards an ELL layout (build_sharded_ell, and _put_global
to place it on a pod).  The port's solver is COO (optim/ba.py), so
neither has a twin here: each shard's slice of the COO table is its whole
index.  The JAX step runs bf16 Schur products; the port's runs float32
inside device.full_precision().
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device import full_precision
from ..optim import ba
from ..optim.ba import BAProblem
from .mesh import Mesh

# make_distributed_lm_step's defaults: solve_distributed never passes the
# BAOptions CG settings
CG_ITERS = 50
CG_TOL = 1e-6
_OBS = ("obs_uv", "obs_cam", "obs_pt", "obs_w")
_STATE = ("cam_q", "cam_t", "cam_intri", "points")


def shard_problem(p: BAProblem, n_shards: int) -> BAProblem:
    """Pad the observation table to a multiple of n_shards (weight-0 rows
    on camera 0 and point 0)."""
    pad = (-p.obs_uv.shape[0]) % n_shards
    if pad == 0:
        return p
    return dataclasses.replace(p, **{
        f: torch.cat([getattr(p, f),
                      getattr(p, f).new_zeros((pad,) + getattr(p, f).shape[1:])])
        for f in _OBS})


def make_reduce(mesh: Mesh, deterministic: bool = True):
    """The cross-shard sum of a mesh: a function of this process's shard
    partials (a sequence, in local shard order, each on its shard's
    device) returning the global sum on the home device."""
    home = mesh.home
    if mesh.group is None:
        if deterministic:
            def red(parts):
                acc = parts[0].to(home)
                for q in parts[1:]:
                    acc = acc + q.to(home)
                return acc
        else:
            def red(parts):
                return torch.stack([q.to(home) for q in parts]).sum(dim=0)
        return red

    import torch.distributed as dist

    def red(parts):
        local = torch.stack([q.to(home) for q in parts])
        if not deterministic:
            out = local.sum(dim=0)
            dist.all_reduce(out, group=mesh.group)
            return out
        gathered = [torch.empty_like(local) for _ in range(mesh.process_count)]
        dist.all_gather(gathered, local, group=mesh.group)
        g = torch.cat(gathered)  # [global shards, ...] in shard order
        acc = g[0]
        for k in range(1, g.shape[0]):
            acc = acc + g[k]
        return acc

    return red


def _shards(state: BAProblem, obs, devices):
    """The local shards' problems: the replicated fields of `state` on each
    shard's device (copied once per distinct device) with the shard's
    observations."""
    rep = {}
    for d in devices:
        if d not in rep:
            rep[d] = dataclasses.replace(state, **{
                f.name: getattr(state, f.name).to(d)
                for f in dataclasses.fields(state)
                if f.name not in _OBS and getattr(state, f.name) is not None})
    return [dataclasses.replace(rep[d], **o) for d, o in zip(devices, obs)]


def _lm_step(state, obs, devices, lam, huber_px, red, with_intri):
    """One distributed LM step (make_distributed_lm_step's): returns the
    new state, damping, cost and accept flag, all on the home device, and
    the cost at the linearization point."""
    shards = _shards(state, obs, devices)
    rzj = [ba._residuals_and_jacobians(s, with_intri=with_intri)
           for s in shards]
    cw = [ba._robust_cost_and_weight(r, z, s.obs_w, huber_px)
          for s, (r, z, _, _) in zip(shards, rzj)]
    cost = red([c for c, _ in cw])
    U, V, W, bc, bp = ba._build_normal_blocks(
        shards, [a[0] for a in rzj], [a[2] for a in rzj],
        [a[3] for a in rzj], [w for _, w in cw], reduce_fn=red)
    dx_c, dx_p = ba._schur_solve(shards, U, V, W, bc, bp, lam, CG_ITERS,
                                 CG_TOL, reduce_fn=red)
    cand = ba._apply_step(state, dx_c, dx_p)
    # the candidate's cost through the same sharded reduction as `cost`
    new_cost = red([
        ba._robust_cost_and_weight(*ba._residuals_only(s), s.obs_w,
                                   huber_px)[0]
        for s in _shards(cand, obs, devices)])
    accept = new_cost < cost
    out = dataclasses.replace(state, **{
        f: torch.where(accept, getattr(cand, f), getattr(state, f))
        for f in _STATE})
    lam2 = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-10, 1e8)
    return out, lam2, torch.where(accept, new_cost, cost), accept, cost


def solve_distributed(mesh: Mesh, prob: BAProblem, max_iters: int = 20,
                      lam0: float = 1e-4, huber_px: float = 4.0, axis="obs",
                      stats: dict | None = None,
                      optimize_intrinsics: bool = False,
                      deterministic: bool = True, tol: float = 1e-6):
    """Host-looped distributed LM solve, one host read per iteration.
    `axis` names the mesh axis, or a tuple such as ("dcn", "ici") for a
    pod mesh (mesh.make_pod_mesh); the observations shard over all of the
    mesh's shards.  PCG runs 50 iterations at tolerance 1e-6; the damping
    halves on an accepted step and grows 4x on a rejected one, within
    [1e-10, 1e8].

    Stops early on a converged problem:
      (a) an accepted step whose relative cost decrease is below tol while
          the damping is back near nominal (lam <= 10 * lam0: a tiny
          accepted step at high lam is a shrunk trust region);
      (b) 8 rejections in a row (4.5 decades of damping explored without
          a descent step: a settled map, where (a) never fires).

    Returns (solved problem on the home device, with prob's observations,
    final cost).  When stats is a dict it receives initial_cost (the cost
    before the first step; the JAX package records the cost after it),
    final_cost and iters (iterations run)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if math.prod(mesh.shape[a] for a in axes) != mesh.size:
        raise ValueError(f"the observations shard over every shard of "
                         f"{mesh}; axis {axis!r} does not span them")
    if optimize_intrinsics and (prob.cam_kam is None
                                or prob.fix_intri is None):
        raise ValueError("optimize_intrinsics requires cam_kam and "
                         "fix_intri on the problem")
    home = mesh.home
    ba.COUNTS[f"dist_solves_{home.type}"] += 1
    padded = shard_problem(prob, mesh.size)
    per = padded.obs_uv.shape[0] // mesh.size
    obs = []
    for i, d in enumerate(mesh.devices):
        g = mesh.shard_index(i)
        obs.append({f: getattr(padded, f)[g * per:(g + 1) * per].to(d)
                    for f in _OBS})
    red = make_reduce(mesh, deterministic)
    state = dataclasses.replace(prob, **{
        f.name: getattr(prob, f.name).to(home)
        for f in dataclasses.fields(prob) if getattr(prob, f.name) is not None})
    with full_precision():
        lam = torch.tensor(lam0, dtype=torch.float32, device=home)
        cost_f = None
        prev_cost = None
        iters = 0
        rejects = 0
        for it in range(max_iters):
            ba.COUNTS["lm_iters"] += 1
            lam_before = lam
            state, lam, cost, accepted, cost0 = _lm_step(
                state, obs, mesh.devices, lam, huber_px, red,
                optimize_intrinsics)
            # the one host read of the iteration
            cost0_f, cost_f, lam_f, acc_f = torch.stack(
                [cost0, cost, lam_before, accepted.to(cost.dtype)]).tolist()
            iters = it + 1
            if it == 0 and stats is not None:
                stats["initial_cost"] = cost0_f
            if acc_f:
                rejects = 0
                if prev_cost is not None and (
                        abs(prev_cost - cost_f) / max(prev_cost, 1e-12) < tol
                        and lam_f <= 10.0 * lam0):
                    break
            else:
                rejects += 1
                if rejects >= 8:
                    break
            prev_cost = cost_f
    if stats is not None:
        stats["final_cost"] = cost_f
        stats["iters"] = iters
    return state, cost_f
