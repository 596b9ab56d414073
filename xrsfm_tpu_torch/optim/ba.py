"""Levenberg-Marquardt bundle adjuster with a Schur complement (port of the
COO path of xrsfm_tpu/optim/ba.py: solve_ba(prob, opts) with ell=None;
reference: src/optimization/ba_solver.cc, GBA :594-638, KGBA :640-678,
LBA :523-592).

  * The problem is a flat COO observation table (obs_cam, obs_pt, obs_uv);
    residuals and analytic Jacobians are evaluated for all observations
    at once.
  * Per-camera 6x6 blocks U, per-point 3x3 blocks V and per-observation
    6x3 coupling blocks W are segment sums in a fixed order (the JAX
    package's segment_sum); points are marginalized with a closed-form 3x3 inverse
    and the reduced camera system is solved matrix-free by block-Jacobi
    PCG (Ceres' SCHUR_JACOBI).
  * Huber robustness is IRLS re-weighting; the reference's negative-depth
    guard (constant residual (12, 12), cost_factor_ceres.h:29-32) becomes
    zero IRLS weight and a constant cost.
  * Gauge freedom is fixed by masking Jacobian columns: frozen cameras,
    frozen translations (ba_solver.cc:610-614) and frozen points.
  * Intrinsics refinement (optimize_intrinsics; reference: GBA frees
    camera_param per physical camera, ba_solver.cc:330-356) widens the
    camera tangent from 6 to 14: pose, then log fx, log fy, cx, cy, k1,
    k2, p1, p2.  Cameras that share a physical camera share one intrinsic
    block (cam_kam): PCG vectors stay per camera, [C, 14], with their
    intrinsic part constant within a block, and the preconditioner has a
    6x6 pose block per camera and an 8x8 intrinsic block per block.

The LM and PCG loops run on the host: each stop test reads one scalar
from the device.  The normal-block build and the Schur solve take the
observations as a list of shards and a reduce_fn hook that sums the
shards' partials (a single shard here; parallel/dist_ba shards over a
device mesh).  Everything is float32; on a GPU the solve runs inside
`device.full_precision()` (no TF32).  Left out, as the JAX package's
TPU-only parts: the ELL / camera-major layout (a TPU gather workaround,
which the JAX package requires for intrinsics; the algorithm is the same
on the COO layout here) and the bf16 Schur operands.
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
# solve ran on (dist_solves_*: parallel/dist_ba's, by its home device):
# shows that a run's bundle adjustment ran on the card, and what its host
# loops cost.
COUNTS = {"solves_cuda": 0, "solves_cpu": 0, "intri_solves_cuda": 0,
          "intri_solves_cpu": 0, "dist_solves_cuda": 0, "dist_solves_cpu": 0,
          "lm_iters": 0, "cg_iters": 0}


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
    # intrinsics metadata, read only by intrinsics-refining solves:
    # intrinsic block per camera (cameras of one physical camera share a
    # block) [C] int64; frozen canonical entries [C, 8] bool (entries the
    # COLMAP model lacks); fx and fy one tied focal [C] bool
    cam_kam: torch.Tensor | None = None
    fix_intri: torch.Tensor | None = None
    tie_f: torch.Tensor | None = None

    @classmethod
    def from_numpy(cls, device, **arrays):
        """Problem on `device` from numpy arrays named as the fields:
        floats to float32, indices to int64, flags to bool; the
        intrinsics fields may be left out."""
        out = {}
        for f in dataclasses.fields(cls):
            if arrays.get(f.name) is None and f.default is None:
                continue
            a = np.asarray(arrays[f.name])
            if f.name.startswith("fix_") or f.name == "tie_f":
                a = a.astype(bool)
            elif f.name in ("obs_cam", "obs_pt", "cam_kam"):
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
    # The JAX package's switch from bf16 to float32 Schur/PCG products for
    # the ill-conditioned solves after a loop correction.  This solver
    # always runs in float32 inside device.full_precision(), so the field
    # changes nothing here; it is kept so that both packages' options and
    # call sites stay alike.
    precise: bool = False
    # free the camera intrinsics (the 14-dof camera tangent); needs
    # cam_kam and fix_intri on the problem
    optimize_intrinsics: bool = False


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


def _residuals_and_jacobians(p: BAProblem, with_intri: bool = False):
    """Residuals [O, 2], depths [O], Jc [O, 2, 6] (or [O, 2, 14] with the
    intrinsic tangent appended), Jp [O, 2, 3].

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
    Jc = torch.cat([Jw, B], dim=-1)
    if with_intri:
        tie = (p.tie_f[p.obs_cam].to(r.dtype) if p.tie_f is not None
               else torch.zeros_like(z))
        Jc = torch.cat([Jc, _intri_jacobian(intri, proj, tie)], dim=-1)
    return r, z, Jc, B @ R


def _intri_jacobian(intri, proj, tie):
    """Analytic d pix / d intrinsic tangent, [..., 2, 8].

    Tangent: (dlog fx, dlog fy, dcx, dcy, dk1, dk2, dp1, dp2); a log focal
    keeps the column pixel-sized like the pose columns.  Where tie is 1
    (single-focal models) column 0 carries d/dlog f for both axes and
    column 1 is zero (its mask freezes it too)."""
    fx, fy = intri[..., 0], intri[..., 1]
    u, v = proj[..., 0], proj[..., 1]
    d = Cam.distort(intri, proj)  # distorted normalized coordinates
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    r4 = r2 * r2
    zeros = torch.zeros_like(u)
    ones = torch.ones_like(u)
    jx = torch.stack([
        fx * d[..., 0], zeros,              # dlog fx (dlog f when tied)
        ones, zeros,                        # dcx, dcy
        fx * u * r2, fx * u * r4,           # dk1, dk2
        fx * 2 * u * v, fx * (r2 + 2 * u2),  # dp1, dp2
    ], dim=-1)
    jy = torch.stack([
        tie * fy * d[..., 1], (1.0 - tie) * fy * d[..., 1],
        zeros, ones,
        fy * v * r2, fy * v * r4,
        fy * (r2 + 2 * v2), fy * 2 * u * v,
    ], dim=-1)
    return torch.stack([jx, jy], dim=-2)


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


def _inv2x2(M):
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    det = torch.where(det.abs() < 1e-12, torch.sign(det) * 1e-12 + 1e-12, det)
    adj = torch.stack([d, -b, -c, a], dim=-1).reshape(M.shape)
    return adj / det[..., None, None]


def inv_spd(M):
    """Batched closed-form inverse of small SPD blocks [..., n, n]:
    recursive block-Schur partitioning down to 2x2 / 3x3 closed forms (the
    JAX package's _inv_spd; the pose graph inverts 7x7 blocks with it)."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / torch.where(M.abs() < 1e-12, 1e-12, M)
    if n == 2:
        return _inv2x2(M)
    if n == 3:
        return _inv3x3(M)
    k = (n + 1) // 2
    A, Bm, D = M[..., :k, :k], M[..., :k, k:], M[..., k:, k:]
    Ai = inv_spd(A)
    AiB = Ai @ Bm
    Si = inv_spd(D - Bm.transpose(-1, -2) @ AiB)
    TR = -(AiB @ Si)
    TL = Ai - TR @ AiB.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([TR.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _colmask_intri(p: BAProblem):
    """Per-camera intrinsic-tangent mask [C, 8]: entries frozen by
    fix_intri, and the dlog fy column of tied-focal cameras (column 0
    carries both axes)."""
    im = (~p.fix_intri).to(p.cam_q.dtype)
    if p.tie_f is not None:
        im[:, 1] = im[:, 1] * (~p.tie_f).to(im.dtype)
    return im


def _cam_colmask(p: BAProblem, with_intri: bool):
    """Per-camera tangent mask [C, 6] (or [C, 14]): rotation columns free
    unless the camera is frozen, translation columns also frozen by
    fix_trans."""
    dt = p.cam_q.dtype
    cam_free = (~p.fix_cam).to(dt)
    trans_free = (~(p.fix_cam | p.fix_trans)).to(dt)
    m = torch.cat([cam_free[:, None].expand(-1, 3),
                   trans_free[:, None].expand(-1, 3)], dim=1)
    if with_intri:
        m = torch.cat([m, _colmask_intri(p)], dim=1)
    return m


def _masked_jacobians(p: BAProblem, Jc, Jp):
    """Zero the Jacobian columns of frozen cameras, translations,
    intrinsic entries and points."""
    dt = Jc.dtype
    colmask = _cam_colmask(p, Jc.shape[-1] > 6).to(dt)[p.obs_cam]  # [O, D]
    Jc = Jc * colmask[:, None, :]
    Jp = Jp * (~p.fix_pt)[p.obs_pt].to(dt)[:, None, None]
    return Jc, Jp


def segment_sum(x, idx, n):
    """Rows of x summed into n segments by idx, in the same order on every
    run.  On a GPU, index_add_ sums with atomics, in another order each
    time, and the mapper's RANSAC and gating decisions then differ from run
    to run; index_put_ with accumulate sorts the indices and sums each
    segment in a fixed order.  On the CPU it is the other way round:
    index_add_ sums in row order whatever the thread count, while
    index_put_ with accumulate splits the rows over threads and its sums
    change from run to run."""
    out = x.new_zeros((n,) + x.shape[1:])
    if x.is_cuda:
        return out.index_put_((idx,), x, accumulate=True)
    return out.index_add_(0, idx, x)


def _single(parts):
    """The reduction over one shard: its partial itself (the default hook;
    parallel/dist_ba passes the r5 rule, partials folded in shard order)."""
    return parts[0]


def _shard_normal_blocks(p: BAProblem, r, Jc, Jp, w):
    """One shard's partial U [C, D, D], V [P, 3, 3], bc [C, D], bp [P, 3]
    and its coupling blocks W [O, D, 3]."""
    C = p.cam_q.shape[0]
    P = p.points.shape[0]
    Jc, Jp = _masked_jacobians(p, Jc, Jp)
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    wJcT = wJc.transpose(1, 2)
    U = segment_sum(wJcT @ Jc, p.obs_cam, C)
    V = segment_sum(wJp.transpose(1, 2) @ Jp, p.obs_pt, P)
    W = wJcT @ Jp
    bc = -segment_sum((wJcT @ r[..., None])[..., 0], p.obs_cam, C)
    bp = -segment_sum((wJp.transpose(1, 2) @ r[..., None])[..., 0],
                       p.obs_pt, P)
    return U, V, W, bc, bp


def _build_normal_blocks(ps, r, Jc, Jp, w, reduce_fn=_single):
    """The normal-equation blocks U [C, D, D], V [P, 3, 3], W [O, D, 3],
    bc [C, D], bp [P, 3], D = 6 (pose) or 14 (pose and intrinsics).

    ps, r, Jc, Jp, w hold one entry per observation shard (a single entry
    on one device; parallel/dist_ba passes a mesh's shards, each on its
    device, with the cameras and points replicated).  The twin of the JAX
    package's reduce_fn on _build_normal_blocks_ell: reduce_fn sums the
    shards' partial U, V, bc, bp into one tensor on the home device; W
    stays per shard (a list)."""
    U, V, W, bc, bp = zip(*(_shard_normal_blocks(*a)
                            for a in zip(ps, r, Jc, Jp, w)))
    return reduce_fn(U), reduce_fn(V), list(W), reduce_fn(bc), reduce_fn(bp)


class _TiedSpace:
    """The reduced space of an intrinsics solve (JAX optim/ba.py
    :1094-1120): pose columns live per camera, intrinsic columns per
    intrinsic block.  Vectors keep the replicated per-camera form [C, 14]
    whose intrinsic part is constant within a block; `proj` sums a
    camera-level gradient over its block, `dot` counts each block once."""

    def __init__(self, kam, C):
        self.kam = kam
        self.C = C
        cnt = segment_sum(torch.ones(C, dtype=torch.float32,
                                     device=kam.device), kam, C)
        self.wred = (1.0 / cnt.clamp_min(1.0))[kam][:, None]  # [C, 1]

    def proj(self, y):
        yi = segment_sum(y[:, 6:], self.kam, self.C)
        return torch.cat([y[:, :6], yi[self.kam]], dim=1)

    def dot(self, a, b):
        return ((a[:, :6] * b[:, :6]).sum()
                + (a[:, 6:] * b[:, 6:] * self.wred).sum())

    def reduce(self, x):
        """One copy of each block's intrinsic value: [C(blocks), 8]."""
        return segment_sum(x[:, 6:] * self.wred, self.kam, self.C)


class _PlainSpace:
    """The camera space of a pose-only solve: no tying."""

    @staticmethod
    def proj(y):
        return y

    @staticmethod
    def dot(a, b):
        return (a * b).sum()


def _jacobi_blocks(ps, Ud, Vinv, W, space, reduce_fn=_single):
    """The blocks the preconditioner inverts: the diagonal blocks of the
    reduced camera system S; with intrinsics, a 6x6 pose block per camera
    and an 8x8 intrinsic block per intrinsic block (the blocks' cameras
    summed).  The W Vinv W^T sum crosses shards (reduce_fn); the
    intrinsic blocks' sum acts on reduced [C, ...] blocks.  Returns (pose
    or whole blocks [C, D, D], intrinsic blocks [C, 8, 8] or None)."""
    C, D = Ud.shape[0], Ud.shape[-1]
    eyeD = torch.eye(D, dtype=Ud.dtype, device=Ud.device)
    WVW = reduce_fn([
        segment_sum((Ws @ Vinv.to(Ws.device)[p.obs_pt]) @ Ws.transpose(1, 2),
                    p.obs_cam, C)
        for p, Ws in zip(ps, W)])
    Sdiag = Ud - WVW + 1e-7 * eyeD
    if D == 6:
        return Sdiag, None
    Sd_i = segment_sum(Sdiag[:, 6:, 6:], space.kam, C) + 1e-7 * eyeD[:8, :8]
    return Sdiag[:, :6, :6], Sd_i


def _schur_solve(ps, U, V, W, bc, bp, lam, cg_iters, cg_tol,
                 reduce_fn=_single):
    """Marginalize the points, block-Jacobi PCG on the reduced camera
    system (in the tied space of the intrinsic blocks when the tangent
    has them), back-substitute.  ps and W hold one entry per observation
    shard (see _build_normal_blocks); every sum over observations is
    summed over shards by reduce_fn: the rhs, the Jacobi blocks, the
    back-substituted W^T dx, and in each matvec the point sum (before
    Vinv is applied) and the camera sum.  The tied space's sums act on
    reduced [C, ...] vectors and cross no shard."""
    C, D = U.shape[0], U.shape[-1]
    P = ps[0].points.shape[0]
    eyeD = torch.eye(D, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
    space = _TiedSpace(ps[0].cam_kam, C) if D > 6 else _PlainSpace()

    # multiplicative LM damping on the block diagonals
    Ud = U + lam * (U * eyeD) + 1e-8 * eyeD
    Vd = V + lam * (V * eye3) + 1e-8 * eye3
    Vinv = _inv3x3(Vd)

    def mv(M, x):  # batched matrix-vector product
        return (M @ x[..., None])[..., 0]

    def pt_sum(x):  # sum over observations of W^T x_cam, into points
        return reduce_fn([
            segment_sum(mv(Ws.transpose(1, 2), x.to(Ws.device)[p.obs_cam]),
                        p.obs_pt, P)
            for p, Ws in zip(ps, W)])

    def cam_sum(y):  # sum over observations of W y_pt, into cameras
        return reduce_fn([
            segment_sum(mv(Ws, y.to(Ws.device)[p.obs_pt]), p.obs_cam, C)
            for p, Ws in zip(ps, W)])

    def S_matvec(x):  # x [C, D]
        zp = mv(Vinv, pt_sum(x))
        return space.proj(mv(Ud, x) - cam_sum(zp))

    # rhs = bc - W Vinv bp
    rhs = space.proj(bc - cam_sum(mv(Vinv, bp)))

    # block-Jacobi preconditioner, LU-inverted
    M_p, M_i = _jacobi_blocks(ps, Ud, Vinv, W, space, reduce_fn)
    n = M_p.shape[-1]
    Minv = linalg.solve(M_p, eyeD[:n, :n].expand(C, n, n))
    if M_i is None:
        def precond(x):
            return mv(Minv, x)
    else:
        Minv_i = linalg.solve(M_i, eyeD[:8, :8].expand(C, 8, 8))

        def precond(x):
            xi = mv(Minv_i, space.reduce(x))
            return torch.cat([mv(Minv, x[:, :6]), xi[space.kam]], dim=1)

    dot = space.dot
    x = torch.zeros_like(rhs)
    r_ = rhs
    z_ = precond(r_)
    pk = z_
    rz = dot(r_, z_)
    bnorm = torch.sqrt(dot(rhs, rhs)) + 1e-30
    for _ in range(cg_iters):
        if not bool(torch.sqrt(dot(r_, r_)) > cg_tol * bnorm):
            break
        COUNTS["cg_iters"] += 1
        Ap = S_matvec(pk)
        denom = dot(pk, Ap)
        alpha = rz / torch.where(denom.abs() < 1e-30, 1e-30, denom)
        x = x + alpha * pk
        r_ = r_ - alpha * Ap
        z_ = precond(r_)
        rz_new = dot(r_, z_)
        beta = rz_new / torch.where(rz.abs() < 1e-30, 1e-30, rz)
        pk = z_ + beta * pk
        rz = rz_new

    # back-substitute the points: dp = Vinv (bp - W^T dx_c)
    return x, mv(Vinv, bp - pt_sum(x))


def _apply_step(p: BAProblem, dx_c, dx_p) -> BAProblem:
    """Retract the free parameters; frozen ones are kept bit for bit (the
    JAX package re-normalizes frozen quaternions, a last-bit change).
    With intrinsics: f exp(dlog f) per axis (both from column 0 when
    tied), additive cx, cy, k1, k2, p1, p2."""
    q2, t2 = G.pose_retract(p.cam_q, p.cam_t, dx_c[:, :6])
    fix_c = p.fix_cam[:, None]
    out = dataclasses.replace(
        p,
        cam_q=torch.where(fix_c, p.cam_q, q2),
        cam_t=torch.where(fix_c | p.fix_trans[:, None], p.cam_t, t2),
        points=torch.where(p.fix_pt[:, None], p.points, p.points + dx_p),
    )
    if dx_c.shape[1] > 6:
        di = dx_c[:, 6:] * _colmask_intri(p)
        intri = p.cam_intri
        tie = (p.tie_f.to(intri.dtype) if p.tie_f is not None
               else torch.zeros_like(intri[:, 0]))
        dlogfy = tie * di[:, 0] + (1.0 - tie) * di[:, 1]
        out.cam_intri = torch.cat([
            (intri[:, 0] * torch.exp(di[:, 0]))[:, None],
            (intri[:, 1] * torch.exp(dlogfy))[:, None],
            intri[:, 2:] + di[:, 2:]], dim=1)
    return out


def solve_ba(p: BAProblem, opts: BAOptions = BAOptions()):
    """Run LM.  Returns (solved problem, info dict with float
    initial_cost, final_cost, lam and int iters)."""
    if opts.optimize_intrinsics and (p.cam_kam is None
                                     or p.fix_intri is None):
        raise ValueError("optimize_intrinsics requires cam_kam and "
                         "fix_intri on the problem")
    dev = "cuda" if p.cam_q.is_cuda else "cpu"
    COUNTS[f"solves_{dev}"] += 1
    if opts.optimize_intrinsics:
        COUNTS[f"intri_solves_{dev}"] += 1
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
        r, z, Jc, Jp = _residuals_and_jacobians(
            p, with_intri=opts.optimize_intrinsics)
        _, w = _robust_cost_and_weight(r, z, p.obs_w, opts.huber_px)
        U, V, W, bc, bp = _build_normal_blocks([p], [r], [Jc], [Jp], [w])
        dx_c, dx_p = _schur_solve([p], U, V, W, bc, bp, lam, opts.cg_iters,
                                  opts.cg_tol)
        cand = _apply_step(p, dx_c, dx_p)
        new_cost = cost_of(cand)
        accept = new_cost < cost
        p = dataclasses.replace(
            p,
            cam_q=torch.where(accept, cand.cam_q, p.cam_q),
            cam_t=torch.where(accept, cand.cam_t, p.cam_t),
            cam_intri=(torch.where(accept, cand.cam_intri, p.cam_intri)
                       if opts.optimize_intrinsics else p.cam_intri),
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
