"""Nister 5-point essential-matrix minimal solver (port of
xrsfm_tpu/ops/essential5pt.py; reference: solve_essential_5pt,
src/geometry/essential.cc:105-304).

Nister's elimination: the 10x20 constraint system of the 4-dim nullspace
basis is reduced, the 3x3 polynomial matrix B(z) whose determinant is
the degree-10 polynomial is formed, that polynomial is rooted with the
batched Durand-Kerner iteration (ops/poly.py), and (x, y) are
back-substituted per root.  The polynomial expansion runs in Python over
dicts of exponent tuples whose values are tensors with the samples'
leading batch dimensions, so the solver is batched over any number of
samples.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import linalg, poly

Mono = Tuple[int, int, int]  # exponents of (x, y, z)

# column order of the 10x20 constraint matrix
_FIRST10 = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
]
_LAST10 = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_COLS = {m: i for i, m in enumerate(_FIRST10 + _LAST10)}


def _pmul(a: Dict[Mono, torch.Tensor], b: Dict[Mono, torch.Tensor]):
    out: Dict[Mono, torch.Tensor] = {}
    for ma, ca in a.items():
        for mb, cb in b.items():
            m = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
            v = ca * cb
            out[m] = out[m] + v if m in out else v
    return out


def _padd(a, b, sign=1.0):
    out = dict(a)
    for m, c in b.items():
        out[m] = out[m] + sign * c if m in out else sign * c
    return out


def _row(p: Dict[Mono, torch.Tensor]):
    """Polynomial dict -> coefficient row [..., 20]."""
    cols = [None] * 20
    zero = None
    for m, c in p.items():
        cols[_COLS[m]] = c
        zero = torch.zeros_like(c)
    return torch.stack([c if c is not None else zero for c in cols], dim=-1)


def _essential_constraints(E_basis):
    """E_basis [..., 4, 3, 3] (E = x*B0 + y*B1 + z*B2 + B3) -> M [..., 10, 20]."""
    monos = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    ent = [[{m: E_basis[..., k, i, j] for k, m in enumerate(monos)}
            for j in range(3)] for i in range(3)]

    rows = []
    det = {}
    for (a, b, c, s) in (
        (0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
        (2, 1, 0, -1.0), (1, 0, 2, -1.0), (0, 2, 1, -1.0),
    ):
        det = _padd(det, _pmul(_pmul(ent[0][a], ent[1][b]), ent[2][c]), s)
    rows.append(_row(det))

    # E E^T E - 0.5 trace(E E^T) E = 0  (9 equations)
    EEt = [[{} for _ in range(3)] for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(ent[i][k], ent[j][k]))
            EEt[i][j] = acc
    tr = _padd(_padd(EEt[0][0], EEt[1][1]), EEt[2][2])
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(EEt[i][k], ent[k][j]))
            acc = _padd(acc, _pmul(tr, ent[i][j]), sign=-0.5)
            rows.append(_row(acc))
    return torch.stack(rows, dim=-2)


def _zmul(a, b, out_len: int):
    """Product of z-polynomials [..., la] and [..., lb] stored
    highest-degree first, cut or zero-padded to the trailing out_len."""
    la, lb = a.shape[-1], b.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = a.new_zeros(shape + (la + lb - 1,))
    for i in range(la):
        out[..., i:i + lb] += a[..., i:i + 1] * b
    if out.shape[-1] >= out_len:
        return out[..., -out_len:]
    pad = out.new_zeros(shape + (out_len - out.shape[-1],))
    return torch.cat([pad, out], dim=-1)


def essential_5pt(x1, x2, mask):
    """Minimal 5-point solver.  x1, x2 [..., N>=5, 2] normalized coords,
    mask [..., N].  Returns (E [..., 10, 3, 3], valid [..., 10])."""
    w = mask.to(x1.dtype)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], dim=-1
    ) * w[..., None]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = linalg.eigh(AtA)
    basis = vecs[..., :, :4].transpose(-1, -2).reshape(
        vecs.shape[:-2] + (4, 3, 3))

    M = _essential_constraints(basis)
    eye = torch.eye(10, dtype=x1.dtype, device=x1.device)
    Bred = linalg.solve(M[..., :10] + 1e-12 * eye, M[..., 10:])  # [..., 10, 10]

    z1 = Bred.new_zeros(Bred.shape[:-2] + (1,))

    def split(row):
        # rows over [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1]
        return (torch.cat([z1, row[..., 0:3]], -1),
                torch.cat([z1, row[..., 3:6]], -1), row[..., 6:10])

    def minus_z(hi, lo):
        # <hi> - z <lo>: the leading monomials cancel; the result is
        # linear in (x, y) with z-polynomial coefficients (deg 4..0)
        ph, qh, rh = split(Bred[..., hi, :])
        pl, ql, rl = split(Bred[..., lo, :])
        return tuple(torch.cat([z1, h], -1) - torch.cat([l_, z1], -1)
                     for h, l_ in ((ph, pl), (qh, ql), (rh, rl)))

    B1 = minus_z(4, 5)
    B2 = minus_z(8, 9)
    B3 = minus_z(6, 7)

    def m2(a, b, c, d):
        return _zmul(a, d, 9) - _zmul(b, c, 9)

    (p1, q1, r1), (p2, q2, r2), (p3, q3, r3) = B1, B2, B3
    dpoly = (_zmul(p1, m2(q2, r2, q3, r3), 11)
             - _zmul(q1, m2(p2, r2, p3, r3), 11)
             + _zmul(r1, m2(p2, q2, p3, q3), 11))
    roots, rvalid = poly.real_roots(dpoly, imag_tol=1e-3, iters=80)  # [..., 10]

    def ev(c, z):  # highest-first coefficients c [..., k] at z [..., 10]
        out = c[..., 0:1].expand(z.shape)
        for k in range(1, c.shape[-1]):
            out = out * z + c[..., k:k + 1]
        return out

    rows = [torch.stack([ev(p, roots), ev(q, roots), ev(r, roots)], dim=-1)
            for (p, q, r) in (B1, B2, B3)]  # each [..., 10, 3]
    cs = torch.stack([torch.linalg.cross(rows[0], rows[1], dim=-1),
                      torch.linalg.cross(rows[0], rows[2], dim=-1),
                      torch.linalg.cross(rows[1], rows[2], dim=-1)], dim=-2)
    best = torch.argmax(torch.linalg.norm(cs, dim=-1), dim=-1)  # [..., 10]
    cbest = torch.gather(cs, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    wc = cbest[..., 2]
    wc = torch.where(wc.abs() < 1e-12, 1e-12, wc)
    xs, ys = cbest[..., 0] / wc, cbest[..., 1] / wc

    b = basis[..., None, :, :, :]  # [..., 1, 4, 3, 3]
    Es = (xs[..., None, None] * b[..., 0, :, :]
          + ys[..., None, None] * b[..., 1, :, :]
          + roots[..., None, None] * b[..., 2, :, :]
          + b[..., 3, :, :])
    nrm = torch.linalg.norm(Es, dim=(-2, -1), keepdim=True)
    Es = Es / nrm.clamp_min(1e-12)
    valid = rvalid & (mask.sum(dim=-1) >= 5)[..., None]
    return Es, valid
