"""Batched LO-RANSAC harness (port of xrsfm_tpu/ops/ransac.py).

A fixed batch of H hypotheses per problem is sampled at once, every model
is scored against every point as one [B, H*M, N] residual tensor, and the
best-supported model wins.  Support follows COLMAP's MSAC-style measurer:
maximize the inlier count, tie-broken by the minimal truncated residual
sum (reference: src/geometry/colmap/optim/support_measurement.cc:44-78).
The local optimization is a refit on the current inlier set, iterated a
fixed number of times (reference: loransac.h's LocalEstimator).

The leading dimension B is the problem (image pair) dimension that the
JAX package expresses with vmap.  Sampling draws from one explicit
torch.Generator per problem, or takes the indices from the caller.  A
model is a tensor or a tuple of tensors (PnP's (q, t)), as a JAX pytree
of arrays.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Model = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def _map(fn, model: Model, *others: Model) -> Model:
    """fn applied leaf by leaf to a tensor model or a tuple of tensors."""
    if isinstance(model, tuple):
        return tuple(fn(*leaves) for leaves in zip(model, *others))
    return fn(model, *others)


class RansacResult(NamedTuple):
    model: Model  # [B, ...] best model per problem (or a tuple of them)
    inliers: torch.Tensor  # [B, N] bool
    num_inliers: torch.Tensor  # [B] int
    score: torch.Tensor  # [B] float32 (truncated residual sum, lower=better)
    success: torch.Tensor  # [B] bool


def sample_indices(generators: Sequence[torch.Generator], mask,
                   num_hypotheses: int, sample_size: int):
    """[B, H, k] indices drawn uniformly without replacement among
    mask[b] == True, one generator per problem.

    Each entry gets a uniform key and the k largest keys are taken (a
    uniform random k-subset; the JAX package's Gumbel keys give the same
    distribution).  Masked entries get -inf, and a stable sort keeps the
    lowest indices among equal keys, as lax.top_k does."""
    B, n = mask.shape
    if len(generators) != B:
        raise ValueError(f"{len(generators)} generators for {B} problems")
    keys = torch.stack([
        torch.rand((num_hypotheses, n), generator=g, device=mask.device)
        for g in generators
    ])
    keys = torch.where(mask[:, None, :], keys, -torch.inf)
    order = torch.sort(keys, dim=-1, descending=True, stable=True).indices
    return order[..., :sample_size]


def ransac(
    data,
    mask,
    estimate_fn: Callable,
    residual_fn: Callable,
    sample_size: int,
    threshold: float,
    num_hypotheses: int = 512,
    refit_fn: Optional[Callable] = None,
    lo_iters: int = 2,
    min_inliers: int = 0,
    generators: Optional[Sequence[torch.Generator]] = None,
    sample_idx: Optional[torch.Tensor] = None,
) -> RansacResult:
    """Run batched (LO-)RANSAC over B problems.

    data: tuple of tensors [B, N, ...] (padded points).
    mask: [B, N] bool, valid entries of the padded pool.
    threshold: a float, or a [B] tensor of one threshold per problem.
    generators: one torch.Generator per problem (on mask's device), or
    sample_idx: [B, H, k] explicit sample indices (H = num_hypotheses).
    estimate_fn(sampled, sample_valid) -> (models [B, H, M, ...] or a
        tuple of such tensors, valid [B, H, M]); sampled is data gathered
        to [B, H, k, ...].
    residual_fn(models [B, S, ...], data) -> [B, S, N] residuals (same
        metric as threshold).
    refit_fn(data, weight_mask [B, N]) -> (model [B, ...], valid [B]):
        least-squares refit on the inlier set.
    """
    B, n = mask.shape
    dev = mask.device
    if sample_idx is None:
        if generators is None:
            raise ValueError("pass generators or sample_idx")
        sample_idx = sample_indices(generators, mask, num_hypotheses,
                                    sample_size)
    idx = sample_idx.to(device=dev, dtype=torch.long)  # [B, H, k]
    bi = torch.arange(B, device=dev)
    sample_valid = mask[bi[:, None, None], idx]
    sampled = tuple(a[bi[:, None, None], idx] for a in data)

    models, model_valid = estimate_fn(sampled, sample_valid)
    flat_models = _map(lambda a: a.reshape((B, -1) + a.shape[3:]),
                       models)  # [B, S, ...]
    flat_valid = model_valid.reshape(B, -1)  # [B, S]

    res = residual_fn(flat_models, data)  # [B, S, N]
    res = torch.where(mask[:, None, :], res, torch.inf)
    res = torch.where(flat_valid[..., None], res, torch.inf)

    if isinstance(threshold, torch.Tensor):  # one threshold per problem
        th = threshold.to(device=dev, dtype=res.dtype).reshape(B, 1)
        th_sn, th_key = th[..., None], th  # against [B, S, N], [B, S]
    else:
        th = th_sn = torch.tensor(threshold, dtype=res.dtype, device=dev)
        th_key = threshold
    inl = res <= th_sn
    counts = inl.sum(dim=-1)
    scores = torch.minimum(res, th_sn).sum(dim=-1)
    scores = torch.where(torch.isfinite(scores), scores, torch.inf)
    # maximize count, tie-break by minimal truncated score
    order_key = counts.to(torch.float32) - scores / (
        th_key * max(n, 1) + 1.0
    )
    best = torch.argmax(order_key, dim=-1)  # first maximum

    best_model = _map(lambda a: a[bi, best], flat_models)
    best_inl = inl[bi, best]
    best_count = counts[bi, best]
    best_score = scores[bi, best]
    success = flat_valid[bi, best] & (
        best_count >= max(sample_size, min_inliers)
    )

    if refit_fn is not None:
        for _ in range(lo_iters):
            new_model, new_valid = refit_fn(data, best_inl & mask)
            r = residual_fn(_map(lambda a: a[:, None], new_model),
                            data)[:, 0]  # [B, N]
            r = torch.where(mask, r, torch.inf)
            r = torch.where(new_valid[:, None], r, torch.inf)
            new_inl = r <= th
            new_count = new_inl.sum(dim=-1)
            new_score = torch.minimum(r, th).sum(dim=-1)
            new_score = torch.where(torch.isfinite(new_score), new_score,
                                    torch.inf)
            better = (new_count > best_count) | (
                (new_count == best_count) & (new_score < best_score)
            )
            better = better & new_valid
            best_model = _map(
                lambda new, old: torch.where(
                    better.reshape((B,) + (1,) * (old.dim() - 1)), new, old),
                new_model, best_model)
            best_inl = torch.where(better[:, None], new_inl, best_inl)
            best_count = torch.where(better, new_count, best_count)
            best_score = torch.where(better, new_score, best_score)

    return RansacResult(
        model=best_model,
        inliers=best_inl & success[:, None],
        num_inliers=torch.where(success, best_count, 0),
        score=best_score,
        success=success,
    )
