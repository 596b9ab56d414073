"""Bitwise state checksums for cross-run and cross-process determinism
(port of xrsfm_tpu/parallel/checksum.py; the numbers are the JAX
package's for the same values).

  * an array's bits are read as uint32 words (bool, int8, uint8, int16
    and uint16 widened; float32 bit-cast; bfloat16 bit-cast to uint16
    and widened; float64 cast to float32 and int64 to int32 first),
    weighted by idx * 2654435761 + 1 and summed, all mod 2^32: the sum
    is the same however the array was split or summed;
  * a tree of dicts, lists and tuples folds its leaves' checksums with
    their paths, spelled as jax.tree_util.keystr spells them (['q'], [0]),
    so swapped leaves of equal content do not collide.

torch has few uint32 kernels: the arithmetic runs in int64 with explicit
masks, the product split into 16-bit halves so that no term reaches 2^63.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_MULT = 2654435761  # Knuth's multiplicative hash
_MASK = 0xFFFFFFFF


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """The array's uint32 words, in int64, flattened."""
    x = x.reshape(-1)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    if x.is_floating_point():
        return x.to(torch.float32).view(torch.int32).to(torch.int64) & _MASK
    # bool and every integer type: the value's two's complement mod 2^32
    # (the JAX package widens small types and casts wider ones to int32)
    return x.to(torch.int64) & _MASK


def array_checksum(x) -> int:
    """Position-weighted uint32 checksum of a tensor or array."""
    u = _as_u32(torch.as_tensor(x))
    idx = torch.arange(u.numel(), dtype=torch.int64, device=u.device)
    w = (idx * _MULT + 1) & _MASK
    lo, hi = u & 0xFFFF, u >> 16
    prod = (lo * w + (((hi * w) & 0xFFFF) << 16)) & _MASK
    return int(prod.sum()) & _MASK


def _leaves_with_path(tree, path=""):
    """(keystr, leaf) in jax.tree_util's order: dict keys sorted, lists and
    tuples in order; None holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def pytree_checksum(tree) -> int:
    """Fold a tree of tensors or arrays into one int (the same in every
    process: leaf order comes from the tree's structure)."""
    acc = 0x811C9DC5  # FNV offset
    for path, leaf in _leaves_with_path(tree):
        h = functools.reduce(
            lambda a, c: ((a ^ ord(c)) * 0x01000193) & _MASK, path,
            0x811C9DC5)
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        acc = (acc * 0x01000193 ^ (array_checksum(leaf) + h)) & _MASK
    return acc
