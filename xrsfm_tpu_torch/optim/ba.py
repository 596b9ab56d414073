"""Levenberg-Marquardt bundle adjuster with a Schur complement (port of the
COO path of xrsfm_tpu/optim/ba.py: solve_ba(prob, opts) with ell=None;
reference: src/optimization/ba_solver.cc, GBA :594-638, KGBA :640-678,
LBA :523-592).

  * The problem is a flat COO observation table (obs_cam, obs_pt, obs_uv);
    residuals and analytic Jacobians are evaluated for all observations
    at once.
  * Per-camera 6x6 blocks U, per-point 3x3 blocks V and per-observation
    6x3 coupling blocks W are summed with index_add_ (the JAX package's
    segment_sum); points are marginalized with a closed-form 3x3 inverse
    and the reduced camera system is solved matrix-free by block-Jacobi
    PCG (Ceres' SCHUR_JACOBI).
  * Huber robustness is IRLS re-weighting; the reference's negative-depth
    guard (constant residual (12, 12), cost_factor_ceres.h:29-32) becomes
    zero IRLS weight and a constant cost.
  * Gauge freedom is fixed by masking Jacobian columns: frozen cameras,
    frozen translations (ba_solver.cc:610-614) and frozen points.

The LM and PCG loops run on the host: each stop test reads one scalar
from the device.  Everything is float32; on a GPU the solve runs inside
`device.full_precision()` (no TF32).  Left out, as the JAX package's
TPU-only or off-path parts: the ELL / camera-major layout (a TPU gather
workaround), the bf16 Schur operands, and intrinsics refinement.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..device import full_precision
from ..ops import linalg
from ..utils import camera as Cam
from ..utils import geometry as G

_BAD_RESIDUAL = 12.0  # the reference's negative-depth guard constant

# Solves and iterations since the last reset_counts(), by the device the
# solve ran on: shows that a run's bundle adjustment ran on the card, and
# what its host loops cost.
COUNTS = {"solves_cuda": 0, "solves_cpu": 0, "lm_iters": 0, "cg_iters": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


@dataclasses.dataclass
class BAProblem:
    """Flat COO bundle-adjustment problem (tensors on one device)."""

    cam_q: torch.Tensor  # [C, 4] Tcw quaternions
    cam_t: torch.Tensor  # [C, 3]
    cam_intri: torch.Tensor  # [C, 8] canonical intrinsics
    points: torch.Tensor  # [P, 3]
    obs_uv: torch.Tensor  # [O, 2] pixel observations
    obs_cam: torch.Tensor  # [O] int64
    obs_pt: torch.Tensor  # [O] int64
    obs_w: torch.Tensor  # [O] float32, 0 = padded-out observation
    fix_cam: torch.Tensor  # [C] bool, freeze the full pose
    fix_trans: torch.Tensor  # [C] bool, freeze the translation only
    fix_pt: torch.Tensor  # [P] bool, freeze the point

    @classmethod
    def from_numpy(cls, device, **arrays):
        """Problem on `device` from numpy arrays named as the fields:
        floats to float32, indices to int64, flags to bool."""
        out = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(arrays[f.name])
            if f.name.startswith("fix_"):
                a = a.astype(bool)
            elif f.name in ("obs_cam", "obs_pt"):
                a = a.astype(np.int64)
            else:
                a = a.astype(np.float32)
            out[f.name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(**out)


@dataclasses.dataclass(frozen=True)
class BAOptions:
    max_iters: int = 20
    cg_iters: int = 15  # truncated Newton: block-Jacobi PCG rarely needs more
    huber_px: float = 2.0
    lam_init: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    lam_max: float = 1e8
    cg_tol: float = 1e-2  # inexact Newton: loose inner solves


def _gather(p: BAProblem):
    return (p.cam_q[p.obs_cam], p.cam_t[p.obs_cam], p.cam_intri[p.obs_cam],
            p.points[p.obs_pt])


def _project(R, t, intri, xyz, uv):
    """pc, z, safe z, normalized projection and pixel residual of every
    observation."""
    # elementwise rotation (as the reference does, to keep O(100) world
    # coordinates out of any reduced-precision matrix unit)
    pc = (R * xyz[..., None, :]).sum(dim=-1) + t
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    return pc, z, zs, proj, Cam.normalized_to_image(intri, proj) - uv


def _residuals_and_jacobians(p: BAProblem):
    """Residuals [O, 2], depths [O], Jc [O, 2, 6], Jp [O, 2, 3].

    Analytic chain: pc = R x + t; proj = pc_xy / pc_z;
    pix = f * distort(proj) + c;
      d pix / d pc = diag(f) Jdist(proj) [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]]
      d pc / d dw = -R [x]_x (right-multiplicative), d pc / d dt = I,
      d pc / d x = R."""
    q, t, intri, xyz = _gather(p)
    R = G.quat_to_rotmat(q)
    pc, z, zs, proj, r = _project(R, t, intri, xyz, p.obs_uv)
    A = intri[..., :2, None] * Cam.distort_jacobian(intri, proj)
    inv_z = 1.0 / zs
    zero = torch.zeros_like(inv_z)
    Jproj = torch.stack([
        torch.stack([inv_z, zero, -pc[..., 0] * inv_z * inv_z], dim=-1),
        torch.stack([zero, inv_z, -pc[..., 1] * inv_z * inv_z], dim=-1),
    ], dim=-2)
    B = A @ Jproj  # [O, 2, 3] = d pix / d pc
    Jw = B @ -(R @ G.skew(xyz))
    return r, z, torch.cat([Jw, B], dim=-1), B @ R


def _residuals_only(p: BAProblem):
    q, t, intri, xyz = _gather(p)
    _, z, _, _, r = _project(G.quat_to_rotmat(q), t, intri, xyz, p.obs_uv)
    return r, z


def _robust_cost_and_weight(r, z, obs_w, huber_px):
    """Huber cost and IRLS weights; cheirality violations get the
    reference's constant residual and zero weight."""
    bad = z <= 1e-3
    rn2 = (r * r).sum(dim=-1)
    rn2 = torch.where(bad, 2.0 * _BAD_RESIDUAL**2, rn2)
    rn = torch.sqrt(rn2.clamp_min(1e-18))
    in_quad = rn <= huber_px
    cost = torch.where(in_quad, rn2, huber_px * (2.0 * rn - huber_px))
    wirls = torch.where(in_quad, 1.0, huber_px / rn)
    wirls = torch.where(bad, 0.0, wirls)
    return (obs_w * cost).sum(), obs_w * wirls


def _inv3x3(M):
    """Batched closed-form 3x3 inverse with a determinant safeguard."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, torch.sign(det) * 1e-12 + 1e-12, det)
    adj = torch.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        dim=-1,
    ).reshape(M.shape)
    return adj / det[..., None, None]


def _masked_jacobians(p: BAProblem, Jc, Jp):
    """Zero the Jacobian columns of frozen cameras, translations, points."""
    dt = Jc.dtype
    cam_free = (~p.fix_cam)[p.obs_cam].to(dt)
    trans_free = (~(p.fix_cam | p.fix_trans))[p.obs_cam].to(dt)
    colmask = torch.cat([cam_free[:, None].expand(-1, 3),
                         trans_free[:, None].expand(-1, 3)], dim=1)  # [O, 6]
    Jc = Jc * colmask[:, None, :]
    Jp = Jp * (~p.fix_pt)[p.obs_pt].to(dt)[:, None, None]
    return Jc, Jp


def _segment_sum(x, idx, n):
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx, x)


def _build_normal_blocks(p: BAProblem, r, Jc, Jp, w):
    """The normal-equation blocks U [C, 6, 6], V [P, 3, 3], W [O, 6, 3],
    bc [C, 6], bp [P, 3]."""
    C = p.cam_q.shape[0]
    P = p.points.shape[0]
    Jc, Jp = _masked_jacobians(p, Jc, Jp)
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    wJcT = wJc.transpose(1, 2)
    U = _segment_sum(wJcT @ Jc, p.obs_cam, C)
    V = _segment_sum(wJp.transpose(1, 2) @ Jp, p.obs_pt, P)
    W = wJcT @ Jp
    bc = -_segment_sum((wJcT @ r[..., None])[..., 0], p.obs_cam, C)
    bp = -_segment_sum((wJp.transpose(1, 2) @ r[..., None])[..., 0],
                       p.obs_pt, P)
    return U, V, W, bc, bp


def _schur_solve(p: BAProblem, U, V, W, bc, bp, lam, cg_iters, cg_tol):
    """Marginalize the points, block-Jacobi PCG on the reduced camera
    system, back-substitute."""
    C = p.cam_q.shape[0]
    P = p.points.shape[0]
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=U.dtype, device=U.device)

    # multiplicative LM damping on the block diagonals
    Ud = U + lam * (U * eye6) + 1e-8 * eye6
    Vd = V + lam * (V * eye3) + 1e-8 * eye3
    Vinv = _inv3x3(Vd)
    WT = W.transpose(1, 2)

    def mv(M, x):  # batched matrix-vector product
        return (M @ x[..., None])[..., 0]

    def S_matvec(x):  # x [C, 6]
        yp = _segment_sum(mv(WT, x[p.obs_cam]), p.obs_pt, P)
        zp = mv(Vinv, yp)
        return mv(Ud, x) - _segment_sum(mv(W, zp[p.obs_pt]), p.obs_cam, C)

    # rhs = bc - W Vinv bp
    rhs = bc - _segment_sum(mv(W, mv(Vinv, bp)[p.obs_pt]), p.obs_cam, C)

    # block-Jacobi preconditioner: the diagonal blocks of S
    WVW = (W @ Vinv[p.obs_pt]) @ WT
    Sdiag = Ud - _segment_sum(WVW, p.obs_cam, C) + 1e-7 * eye6
    Minv = linalg.solve(Sdiag, eye6.expand(C, 6, 6))

    x = torch.zeros_like(rhs)
    r_ = rhs
    z_ = mv(Minv, r_)
    pk = z_
    rz = (r_ * z_).sum()
    bnorm = torch.sqrt((rhs * rhs).sum()) + 1e-30
    for _ in range(cg_iters):
        if not bool(torch.sqrt((r_ * r_).sum()) > cg_tol * bnorm):
            break
        COUNTS["cg_iters"] += 1
        Ap = S_matvec(pk)
        denom = (pk * Ap).sum()
        alpha = rz / torch.where(denom.abs() < 1e-30, 1e-30, denom)
        x = x + alpha * pk
        r_ = r_ - alpha * Ap
        z_ = mv(Minv, r_)
        rz_new = (r_ * z_).sum()
        beta = rz_new / torch.where(rz.abs() < 1e-30, 1e-30, rz)
        pk = z_ + beta * pk
        rz = rz_new

    # back-substitute the points: dp = Vinv (bp - W^T dx_c)
    WTdx = _segment_sum(mv(WT, x[p.obs_cam]), p.obs_pt, P)
    return x, mv(Vinv, bp - WTdx)


def _apply_step(p: BAProblem, dx_c, dx_p) -> BAProblem:
    """Retract the free parameters; frozen ones are kept bit for bit (the
    JAX package re-normalizes frozen quaternions, a last-bit change)."""
    q2, t2 = G.pose_retract(p.cam_q, p.cam_t, dx_c)
    fix_c = p.fix_cam[:, None]
    return dataclasses.replace(
        p,
        cam_q=torch.where(fix_c, p.cam_q, q2),
        cam_t=torch.where(fix_c | p.fix_trans[:, None], p.cam_t, t2),
        points=torch.where(p.fix_pt[:, None], p.points, p.points + dx_p),
    )


def solve_ba(p: BAProblem, opts: BAOptions = BAOptions()):
    """Run LM.  Returns (solved problem, info dict with float
    initial_cost, final_cost, lam and int iters)."""
    COUNTS["solves_cuda" if p.cam_q.is_cuda else "solves_cpu"] += 1
    with full_precision():
        return _solve(p, opts)


def _solve(p: BAProblem, opts: BAOptions):
    def cost_of(prob):
        r, z = _residuals_only(prob)
        return _robust_cost_and_weight(r, z, prob.obs_w, opts.huber_px)[0]

    c0 = cost_of(p)
    cost = c0
    lam = torch.tensor(opts.lam_init, dtype=p.cam_q.dtype,
                       device=p.cam_q.device)
    it = 0
    while it < opts.max_iters:
        COUNTS["lm_iters"] += 1
        r, z, Jc, Jp = _residuals_and_jacobians(p)
        _, w = _robust_cost_and_weight(r, z, p.obs_w, opts.huber_px)
        U, V, W, bc, bp = _build_normal_blocks(p, r, Jc, Jp, w)
        dx_c, dx_p = _schur_solve(p, U, V, W, bc, bp, lam, opts.cg_iters,
                                  opts.cg_tol)
        cand = _apply_step(p, dx_c, dx_p)
        new_cost = cost_of(cand)
        accept = new_cost < cost
        p = dataclasses.replace(
            p,
            cam_q=torch.where(accept, cand.cam_q, p.cam_q),
            cam_t=torch.where(accept, cand.cam_t, p.cam_t),
            points=torch.where(accept, cand.points, p.points),
        )
        cost2 = torch.where(accept, new_cost, cost)
        lam2 = torch.where(accept, lam * opts.lam_down, lam * opts.lam_up)
        lam2 = lam2.clamp(1e-10, opts.lam_max)
        rel = (cost - cost2).abs() / cost.clamp_min(1e-12)
        # early stop only when damping is back near nominal: a tiny
        # accepted step at high lambda is a plateau, not convergence
        done = accept & (rel < 1e-6) & (lam <= 10.0 * opts.lam_init)
        it += 1
        cost, lam = cost2, lam2
        if bool(done):
            break
    info = dict(initial_cost=float(c0), final_cost=float(cost), iters=it,
                lam=float(lam))
    return p, info
