"""Guards for the batched decompositions of the reconstruction kernels.

JAX returns NaN quietly for a decomposition of a non-finite matrix;
torch.linalg's eigh and svd check their status and raise.  The padded and
degenerate rows of a batch (an all-masked sample, a hypothesis whose
depth division overflowed) are replaced by the identity before the
decomposition, so the batch decomposes and the row's own validity mask,
computed by the caller as in the JAX package, discards it.  Errors of a
finite batch are not caught.
"""

from __future__ import annotations

import torch


def finite_or_eye(A):
    """A [..., n, n] with every matrix that holds a non-finite entry
    replaced by the identity."""
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(bad[..., None, None], eye, A)


# cuSOLVER's batched symmetric eigensolver refuses very large batches
# (CUSOLVER_STATUS_INVALID_VALUE from its workspace query at 32768 4x4 or
# 9x9 matrices on an H100 with CUDA 12.8; 16384 pass); larger batches
# are decomposed in chunks of this many matrices
_EIGH_CHUNK = 16384


def eigh(A):
    """torch.linalg.eigh of the guarded A (ascending eigenvalues)."""
    A = finite_or_eye(A)
    n = A.shape[-1]
    flat = A.reshape(-1, n, n)
    if flat.shape[0] <= _EIGH_CHUNK:
        return torch.linalg.eigh(A)
    parts = [torch.linalg.eigh(c) for c in flat.split(_EIGH_CHUNK)]
    vals = torch.cat([p[0] for p in parts]).reshape(A.shape[:-1])
    vecs = torch.cat([p[1] for p in parts]).reshape(A.shape)
    return vals, vecs


def svd(A):
    """torch.linalg.svd (reduced) of the guarded square A."""
    return torch.linalg.svd(finite_or_eye(A))


def solve(A, B):
    """A^-1 B without a status check: like jnp.linalg.solve, a singular A
    gives non-finite entries instead of an error."""
    return torch.linalg.solve_ex(finite_or_eye(A), B)[0]
