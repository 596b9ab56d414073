"""Levenberg-Marquardt bundle adjuster with a Schur complement (port of
xrsfm_tpu/optim/ba.py; reference: src/optimization/ba_solver.cc, GBA
:594-638, KGBA :640-678, LBA :523-592).

Two layouts of the same solve, chosen by solve_ba's `ell` argument as in
the JAX package:

  * COO (ell=None): a flat observation table (obs_cam, obs_pt, obs_uv);
    residuals and analytic Jacobians for all observations at once,
    per-camera blocks U, per-point blocks V and per-observation coupling
    blocks W summed into segments by segment_sum.  parallel/dist_ba shards
    this layout over a device mesh.
  * Camera-major ELL (pack_camera_major, the main path: mapper/ba_glue
    packs every single-device problem).  The table is reordered, on the
    device that solves it, so that each camera's observations are
    consecutive rows of at most 128 slots, and a point-major index (rows
    of at most 32 slots) maps each point's observations into it.  Camera
    data is read once a row, the camera blocks are reductions over
    consecutive rows, and the point blocks are recomputed in point order
    (_build_pt_blocks_native).  On a GPU the two
    per-iteration block builds are the hand-written kernels
    csrc/ba_cam_rows.cu and csrc/ba_pt_rows.cu (cam_rows / pt_rows: the
    kernel for CUDA tensors, the plain composition of this module's
    functions for CPU tensors).  The Schur solve keeps the factored
    Y = Jcᵀ Z form (_schur_solve_ell) and never builds the [O, D, 3]
    coupling blocks.  The JAX package's flat ELL layout is not ported:
    every ELL problem is packed camera-major.

Common to both:
  * Points are marginalized with closed-form 3x3 inverses and the reduced
    camera system is solved matrix-free by block-Jacobi PCG (Ceres'
    SCHUR_JACOBI): one damping (_damped), one preconditioner
    (_block_jacobi) and one PCG loop (_Pcg) serve both layouts.
  * Huber robustness is IRLS re-weighting; the reference's negative-depth
    guard (constant residual (12, 12), cost_factor_ceres.h:29-32) becomes
    zero IRLS weight and a constant cost.  With the intrinsics free, a
    candidate never carries a point from in front of a camera that sees
    it onto or behind that camera's plane: such a point keeps its place
    (_keep_in_front).
  * Gauge freedom is fixed by masking Jacobian columns: frozen cameras,
    frozen translations (ba_solver.cc:610-614) and frozen points; frozen
    rotations (fix_rot) let a settling solve keep averaged rotations
    while translations and points re-fit.
  * Intrinsics refinement (optimize_intrinsics; reference: GBA frees
    camera_param per physical camera, ba_solver.cc:330-356) widens the
    camera tangent from 6 to 14: pose, then log fx, log fy, cx, cy, k1,
    k2, p1, p2.  Cameras that share a physical camera share one intrinsic
    block (cam_kam): PCG vectors stay per camera, [C, 14], with their
    intrinsic part constant within a block, and the preconditioner has a
    6x6 pose block per camera and an 8x8 intrinsic block per block.

The LM and PCG loops run on the host: each stop test reads one scalar
from the device.  On a GPU each PCG iteration of the ELL solve is one
CUDA graph, captured once an LM step and replayed an iteration (_Pcg);
the COO solve's sums may cross devices and processes, so its PCG runs
eagerly.  solve_ba runs on a stream of its own (_on_ba_stream).
Everything solve_ba runs is float32, on a GPU inside
`device.full_precision()` (no TF32); the functions work in the dtype of
the problem they are given (the JAX package's bf16 Schur operands are
not ported).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import numpy as np
import torch

from ..device import full_precision
from ..ops import linalg
from ..utils import camera as Cam
from ..utils import geometry as G
from ..utils.profiling import span

_BAD_RESIDUAL = 12.0  # the reference's negative-depth guard constant

# Solves and iterations since the last reset_counts(), by the device the
# solve ran on (dist_solves_*: parallel/dist_ba's, by its home device;
# row_solves_*: the solves among solves_* that took the camera-major row
# layout): shows that a run's bundle adjustment ran on the card, in which
# layout, and what its host loops cost.  lm_accepts: the LM candidates
# accepted among lm_iters (a stalled solve rejects nearly every one),
# summed on the device and read with the final cost.  pcg_graph_captures /
# pcg_graph_replays: the ELL solve's PCG iterations captured as a CUDA
# graph (one an LM step that iterates) and replayed (one an iteration);
# both stay 0 on the CPU.  packs_*: pack_camera_major calls by the device
# the tables were built on.
COUNTS = {"solves_cuda": 0, "solves_cpu": 0, "intri_solves_cuda": 0,
          "intri_solves_cpu": 0, "row_solves_cuda": 0, "row_solves_cpu": 0,
          "dist_solves_cuda": 0, "dist_solves_cpu": 0,
          "lm_iters": 0, "cg_iters": 0, "lm_accepts": 0,
          "pcg_graph_captures": 0, "pcg_graph_replays": 0,
          "packs_cuda": 0, "packs_cpu": 0}

# Launches of the two row kernels by route, since reset_launch_counts():
# the wrappers cam_rows / pt_rows count the kernel where they launch it and
# the plain version where a CPU tensor sends them to it.
LAUNCHES = {"ba_cam_rows_cuda": 0, "ba_cam_rows_plain": 0,
            "ba_pt_rows_cuda": 0, "ba_pt_rows_plain": 0}
# The shapes cam_rows / pt_rows were called at since reset_launch_counts(),
# either route: calls by (C, Rc, Mc) (cameras, camera rows, slots a row)
# and by (P, Rp, Lw) (points, point rows, slots a row).
ROW_SHAPES = {"cam": collections.Counter(), "pt": collections.Counter()}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for tally in ROW_SHAPES.values():
        tally.clear()


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
    # [C] bool, freeze the rotation only (None: no rotation frozen beyond
    # fix_cam)
    fix_rot: torch.Tensor | None = None

    @classmethod
    def from_numpy(cls, device, **arrays):
        """Problem on `device` from numpy arrays named as the fields:
        floats to float32, indices to int64, flags to bool; the
        intrinsics fields and fix_rot may be left out."""
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


# ---------------------------------------------------------------------------
# The camera-major ELL layout (built where the tables are used: on the
# problem's target device, by sorts, prefix sums, gathers and scatters)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowIndex:
    """One side (camera or point) of the ELL observation layout.

    The observations of each segment (camera / point) are packed into
    rows of a fixed width M; a heavy segment spans several consecutive
    rows, so padding is at most M - 1 a segment.  A per-segment reduction
    is then a per-row reduction and a sum over the segment's rows.  The
    observation table itself is stored in the camera side's row order
    (pack_camera_major), so the camera-row view of a per-observation
    array is a reshape."""

    slots: torch.Tensor  # [R, M] int32 flat observation index, O on padding
    seg: torch.Tensor  # [R] int32 segment id of each row (non-decreasing)
    other: torch.Tensor  # [R, M] int32 the other side's id per slot, 0 pad
    # [n_seg + 1] int32: the rows of segment s are starts[s]..starts[s+1]-1
    # (every segment has at least one row); the row kernels loop over them
    starts: torch.Tensor


@dataclasses.dataclass
class EllIndex:
    """ELL slot tables of a problem packed by pack_camera_major.

    pt_uv / pt_w are point-major copies of the pixel observations and base
    weights, from which the point blocks are recomputed in point order
    (_build_pt_blocks_native); they mirror obs_uv / obs_w at pack time.
    pt_pos maps each camera-major slot to its position in the flat
    point-major order (Rp * Lw on padding), so that small per-slot results
    computed point-major cross back to the camera rows."""

    cam: RowIndex  # camera-major rows
    pt: RowIndex  # point-major rows
    pt_uv: torch.Tensor  # [Rp, Lw, 2]
    pt_w: torch.Tensor  # [Rp, Lw]
    pt_pos: torch.Tensor  # [Rc, Mc] int32


def _counts(ids, n_seg: int):
    """Observations a segment, [n_seg] int64 on ids' device (bincount
    without its read of the largest id)."""
    return torch.zeros(n_seg, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def _row_shape(counts, max_width: int, bucket_lo: int):
    """Row width M = min(bucket(largest count), max_width), bucket(c) the
    least bucket_lo * 2^k >= c, and row count R = the sum over segments of
    max(ceil(count / M), 1): exactly the rows the segments need (the JAX
    package rounds R up to a bucket of XLA shapes; no kernel here needs
    that).  0-dim tensors on counts' device, so that a pack reads all its
    sizes in one fetch."""
    widths = bucket_lo * 2 ** torch.arange(max_width.bit_length() + 1,
                                           device=counts.device)
    M = torch.where(widths >= counts.amax(), widths, max_width).amin(
        ).clamp_max(max_width)
    return M, ((counts + M - 1) // M).clamp_min(1).sum()


def _build_rows(ids, counts, M: int, R: int):
    """Pack per-segment observation lists into R rows of width M (the
    sizes _row_shape gives), each segment's observations in their order in
    `ids` (a stable sort, so numpy's kind="stable" argsort exactly).
    Returns (sorted ids, order: the index into ids of each sorted entry,
    flat: its slot in the [R * M] table, seg [R] int32, starts [n_seg + 1]
    int32)."""
    rows = ((counts + M - 1) // M).clamp_min(1)
    starts = torch.cat([rows.new_zeros(1), rows.cumsum(0)])
    seg = torch.repeat_interleave(rows, output_size=R).int()
    sorted_ids, order = torch.sort(ids, stable=True)
    base = starts[:-1] * M - (counts.cumsum(0) - counts)
    flat = base[sorted_ids] + torch.arange(len(ids), device=ids.device)
    return sorted_ids, order, flat, seg, starts.int()


def _scatter(flat, values, size: int, fill):
    """[size] table of values.dtype, values at the (unique) slots flat,
    fill elsewhere."""
    out = values.new_full((size,) + tuple(values.shape[1:]), fill)
    out[flat] = values
    return out


def pack_camera_major(p: BAProblem, n_valid=None, bucket_lo: int = 8,
                      cam_width: int = 128, pt_width: int = 32, device=None):
    """Reorder and physically pad the observation table camera-major (the
    JAX package's pack_camera_major).  Returns (packed problem, EllIndex)
    whose camera rows are consecutive slices of the table, with the
    point-major index, pt_uv / pt_w and pt_pos.  Padding slots carry
    obs_w = 0 and point id 0, so they vanish from every reduction.

    p's fields move to `device` (by default p's) as they are, and every
    table is built there: two stable sorts, prefix sums, gathers and
    scatters to unique slots, O(n log n), with one read of the four table
    sizes (Mc, Rc, Lw, Rp).  Counted in COUNTS["packs_cuda" / "packs_cpu"]
    by that device."""
    with span("xrsfm.ba.pack"):
        dev = torch.device(device) if device is not None else p.cam_q.device
        COUNTS["packs_cuda" if dev.type == "cuda" else "packs_cpu"] += 1
        # pageable host memory is staged before the copy call returns
        fields = {f.name: getattr(p, f.name).to(
                      dev, non_blocking=dev.type == "cuda")
                  for f in dataclasses.fields(p)
                  if getattr(p, f.name) is not None}
        O_full = len(fields["obs_cam"])
        n = O_full if n_valid is None else int(n_valid)
        oc, op = fields["obs_cam"][:n], fields["obs_pt"][:n]
        cam_counts = _counts(oc, fields["cam_q"].shape[0])
        pt_counts = _counts(op, fields["points"].shape[0])
        Mc, Rc, Lw, Rp = torch.stack(
            _row_shape(cam_counts, cam_width, bucket_lo)
            + _row_shape(pt_counts, pt_width, bucket_lo)).tolist()
        O2, Np = Rc * Mc, Rp * Lw
        # camera rows: fc, the packed slot of each observation in camera
        # order, ascends, so the real slots keep camera-major order below
        cam_of, order, fc, cam_seg, cam_starts = _build_rows(
            oc, cam_counts, Mc, Rc)
        pt_of = op[order]
        packed = dict(
            obs_uv=_scatter(fc, fields["obs_uv"][order], O2, 0),
            obs_w=_scatter(fc, fields["obs_w"][order], O2, 0),  # pad: 0
            obs_cam=cam_seg.long()[:, None].expand(Rc, Mc).reshape(-1),
            obs_pt=_scatter(fc, pt_of, O2, 0))
        # point rows over the real slots, in camera-major order
        _, pt_order, fp, pt_seg, pt_starts = _build_rows(
            pt_of, pt_counts, Lw, Rp)
        src = fc[pt_order]  # the packed slot of each point-major entry
        # static point-major copies of (uv, w), from which the point blocks
        # are recomputed in point order every LM iteration
        ell = EllIndex(
            cam=RowIndex(torch.arange(O2, dtype=torch.int32, device=dev
                                      ).view(Rc, Mc), cam_seg,
                         packed["obs_pt"].int().view(Rc, Mc), cam_starts),
            pt=RowIndex(_scatter(fp, src.int(), Np, O2).view(Rp, Lw),
                        pt_seg,
                        _scatter(fp, cam_of[pt_order].int(), Np, 0
                                 ).view(Rp, Lw), pt_starts),
            pt_uv=_scatter(fp, packed["obs_uv"][src], Np, 0).view(Rp, Lw, 2),
            pt_w=_scatter(fp, packed["obs_w"][src], Np, 0).view(Rp, Lw),
            # reverse map: camera-major slot -> flat point-major position
            pt_pos=_scatter(src, fp.int(), O2, Np).view(Rc, Mc))
        return dataclasses.replace(p, **dict(fields, **packed)), ell


def _gather_obs(a, slots):
    """A per-observation array gathered by an ELL slot table; padding
    slots (index O, past the end) read as zero rows."""
    O = a.shape[0]
    g = a[slots.clamp_max(O - 1)]
    valid = (slots < O).to(a.dtype)
    return g * valid.reshape(valid.shape + (1,) * (a.dim() - 1))


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
    reference's constant residual and zero weight.  An observation of
    weight 0 takes the guard's constant too, so it costs 0 even where its
    residual overflows (a padding slot's point near the camera's plane,
    with k1, k2 set), not 0 x inf."""
    bad = (z <= 1e-3).logical_or_(obs_w == 0)
    rn2 = (r * r).sum(dim=-1)
    rn2 = torch.where(bad, 2.0 * _BAD_RESIDUAL**2, rn2)
    rn = torch.sqrt(rn2.clamp_min(1e-18))
    in_quad = rn <= huber_px
    cost = torch.where(in_quad, rn2, huber_px * (2.0 * rn - huber_px))
    wirls = torch.where(in_quad, 1.0, huber_px / rn)
    wirls = torch.where(bad, 0.0, wirls)
    return (obs_w * cost).sum(), obs_w * wirls


# ---------------------------------------------------------------------------
# Camera-row evaluation (the camera-major packed table)
# ---------------------------------------------------------------------------
#
# With pack_camera_major the observation table IS the camera rows [Rc, Mc]
# flattened, and every slot of a row shares one camera: camera data (q, t,
# intrinsics) is read once a row instead of once an observation.


def _row_project(p: BAProblem, ell: EllIndex):
    """The camera-row projection chain: (R [Rc,3,3], pc [Rc,Mc,3], z, safe
    z, proj [Rc,Mc,2], intri [Rc,8], residual [Rc,Mc,2])."""
    Rc, Mc = ell.cam.slots.shape
    seg = ell.cam.seg
    q, t, intri = p.cam_q[seg], p.cam_t[seg], p.cam_intri[seg]
    xyz = p.points[ell.cam.other]  # [Rc,Mc,3]
    R = G.quat_to_rotmat(q)  # [Rc,3,3]
    # the rotation as a broadcast multiply and sum, not a matrix product:
    # O(100) world coordinates must not go through a reduced-precision
    # matrix unit (the JAX package's MXU-bf16 hazard; TF32 on a GPU)
    pc = (R[:, None, :, :] * xyz[:, :, None, :]).sum(dim=-1) + t[:, None, :]
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    pix = Cam.normalized_to_image(intri[:, None, :], proj)
    return R, pc, z, zs, proj, intri, pix - p.obs_uv.reshape(Rc, Mc, 2)


def _residuals_only_rows(p: BAProblem, ell: EllIndex):
    """Row-layout residuals [Rc,Mc,2] and depths [Rc,Mc]."""
    _, _, z, _, _, _, r = _row_project(p, ell)
    return r, z


def _proj_jacobian(A, pc, inv_z):
    """d pix / d pc [..., 2, 3] from A = diag(f) Jdist [..., 2, 2]: the
    projection Jacobian's sparsity folded in (columns 0-1 are A / z,
    column 2 is -(A.0 x + A.1 y) / z^2)."""
    B01 = A * inv_z[..., None, None]
    B2 = -(A[..., 0] * pc[..., None, 0] + A[..., 1] * pc[..., None, 1]) \
        * (inv_z * inv_z)[..., None]
    return torch.cat([B01, B2[..., None]], dim=-1)


def _residuals_and_jacobians_rows(p: BAProblem, ell: EllIndex,
                                  with_intri: bool = False):
    """Row-layout residuals [Rc,Mc,2], depths [Rc,Mc], Jc [Rc,Mc,2,D] (D = 6
    pose, 14 with intrinsics) and Jp [Rc,Mc,2,3]: the chain of
    _residuals_and_jacobians with the camera factors at row rank."""
    R, pc, z, zs, proj, intri, r = _row_project(p, ell)
    xyz = p.points[ell.cam.other]
    A = intri[:, None, :2, None] * Cam.distort_jacobian(intri[:, None, :],
                                                         proj)
    B = _proj_jacobian(A, pc, 1.0 / zs)  # [Rc,Mc,2,3]
    Jp = B @ R[:, None]  # [Rc,Mc,2,3]
    # Jw = B (-R [x]x) = -(B R) [x]x: each row through skew(x) is a cross
    # product, so no [Rc,Mc,3,3] intermediate
    Jw = -G._cross(Jp, xyz[:, :, None, :])
    Jc = torch.cat([Jw, B], dim=-1)
    if not with_intri:
        return r, z, Jc, Jp
    tie = (p.tie_f[ell.cam.seg].to(r.dtype)[:, None]
           if p.tie_f is not None else torch.zeros_like(z))
    Ji = _intri_jacobian(intri[:, None, :], proj, tie)  # [Rc,Mc,2,8]
    return r, z, torch.cat([Jc, Ji], dim=-1), Jp


def _mv(M, x):  # batched matrix-vector product
    return (M @ x[..., None])[..., 0]


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


def _rot_frozen(p: BAProblem):
    """[C] bool: cameras whose rotation stays as it is."""
    return p.fix_cam if p.fix_rot is None else p.fix_cam | p.fix_rot


def _cam_colmask(p: BAProblem, with_intri: bool):
    """Per-camera tangent mask [C, 6] (or [C, 14]): rotation columns free
    unless the camera or its rotation is frozen (fix_cam, fix_rot),
    translation columns free unless fix_cam or fix_trans."""
    dt = p.cam_q.dtype
    cam_free = (~_rot_frozen(p)).to(dt)
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

    def dot(self, a, b, out=None):
        return torch.add((a[:, :6] * b[:, :6]).sum(),
                         (a[:, 6:] * b[:, 6:] * self.wred).sum(), out=out)

    def reduce(self, x):
        """One copy of each block's intrinsic value: [C(blocks), 8]."""
        return segment_sum(x[:, 6:] * self.wred, self.kam, self.C)


class _PlainSpace:
    """The camera space of a pose-only solve: no tying."""

    @staticmethod
    def proj(y):
        return y

    @staticmethod
    def dot(a, b, out=None):
        return torch.sum(a * b, dim=None, out=out)


def _damped(U, V, lam):
    """Multiplicative LM damping on the block diagonals.  Returns (Ud, the
    inverse of the damped V, eye(D) in U's dtype)."""
    D = U.shape[-1]
    eyeD = torch.eye(D, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
    Ud = U + lam * (U * eyeD) + 1e-8 * eyeD
    Vd = V + lam * (V * eye3) + 1e-8 * eye3
    return Ud, _inv3x3(Vd), eyeD


def _jacobi_blocks(ps, Ud, Vinv, W, reduce_fn=_single):
    """The diagonal blocks of the COO layout's reduced camera system,
    Sdiag = Ud - Σ W Vinv Wᵀ + 1e-7 I [C, D, D], which _block_jacobi
    inverts.  The W Vinv Wᵀ sum crosses shards (reduce_fn)."""
    C, D = Ud.shape[0], Ud.shape[-1]
    eyeD = torch.eye(D, dtype=Ud.dtype, device=Ud.device)
    WVW = reduce_fn([
        segment_sum((Ws @ Vinv.to(Ws.device)[p.obs_pt]) @ Ws.transpose(1, 2),
                    p.obs_cam, C)
        for p, Ws in zip(ps, W)])
    return Ud - WVW + 1e-7 * eyeD


def _block_jacobi(Sdiag, space, eyeD):
    """The block-Jacobi preconditioner x -> M⁻¹ x of a reduced camera
    system from its diagonal blocks Sdiag [C, D, D]: each camera's block
    inverted; with intrinsics (D = 14) a 6x6 pose block per camera and an
    8x8 intrinsic block per intrinsic block (its cameras' blocks summed).
    Batched LU (ops/linalg.solve): the JAX package's closed-form _inv_spd
    avoids XLA's batched LU on a TPU, and costs about 75 small launches a
    6x6 batch here."""
    C = Sdiag.shape[0]

    def inverse(M):
        n = M.shape[-1]
        return linalg.solve(M, eyeD[:n, :n].expand(C, n, n))

    if Sdiag.shape[-1] == 6:
        Minv = inverse(Sdiag)
        return lambda x: _mv(Minv, x)
    Minv_p = inverse(Sdiag[:, :6, :6])
    Minv_i = inverse(segment_sum(Sdiag[:, 6:, 6:], space.kam, C)
                     + 1e-7 * eyeD[:8, :8])

    def precond(x):
        xi = _mv(Minv_i, space.reduce(x))
        return torch.cat([_mv(Minv_p, x[:, :6]), xi[space.kam]], dim=1)

    return precond


def _schur_solve(ps, U, V, W, bc, bp, lam, cg_iters, cg_tol,
                 reduce_fn=_single):
    """Marginalize the points, block-Jacobi PCG on the reduced camera
    system (in the tied space of the intrinsic blocks when the tangent
    has them), back-substitute.  ps and W hold one entry per observation
    shard (see _build_normal_blocks); every sum over observations is
    summed over shards by reduce_fn: the rhs, the Jacobi blocks, the
    back-substituted W^T dx, and in each matvec the point sum (before
    Vinv is applied) and the camera sum.  The tied space's sums act on
    reduced [C, ...] vectors and cross no shard.  A CUDA graph cannot
    capture sums that cross devices or processes, so _Pcg runs eagerly
    here."""
    with span("xrsfm.ba.schur"):
        C, D = U.shape[0], U.shape[-1]
        P = ps[0].points.shape[0]
        space = _TiedSpace(ps[0].cam_kam, C) if D > 6 else _PlainSpace()
        Ud, Vinv, eyeD = _damped(U, V, lam)

        def pt_sum(x):  # sum over observations of W^T x_cam, into points
            return reduce_fn([
                segment_sum(_mv(Ws.transpose(1, 2),
                                x.to(Ws.device)[p.obs_cam]),
                            p.obs_pt, P)
                for p, Ws in zip(ps, W)])

        def cam_sum(y):  # sum over observations of W y_pt, into cameras
            return reduce_fn([
                segment_sum(_mv(Ws, y.to(Ws.device)[p.obs_pt]), p.obs_cam, C)
                for p, Ws in zip(ps, W)])

        def S_matvec(x, ypx):  # x [C, D], ypx = pt_sum(x)
            return space.proj(_mv(Ud, x) - cam_sum(_mv(Vinv, ypx)))

        # rhs = bc - W Vinv bp
        rhs = space.proj(bc - cam_sum(_mv(Vinv, bp)))
        precond = _block_jacobi(_jacobi_blocks(ps, Ud, Vinv, W, reduce_fn),
                                space, eyeD)

    with span("xrsfm.ba.pcg"):
        pcg = _Pcg(rhs, P, pt_sum, S_matvec, precond, space.dot, cg_tol)
        pcg.run(cg_iters, graph=False)
        # back-substitute the points: dp = Vinv (bp - W^T dx_c)
        return pcg.x, _mv(Vinv, bp - pt_sum(pcg.x))


# ---------------------------------------------------------------------------
# ELL normal blocks and Schur solve
# ---------------------------------------------------------------------------


def _build_normal_blocks_ell(p: BAProblem, ell: EllIndex, r, Jc, w):
    """The camera side of the normal equations in the camera rows (r
    [Rc,Mc,2] and Jc [Rc,Mc,2,D] from _residuals_and_jacobians_rows, IRLS
    weights w [Rc,Mc]): with the √w-scaled Jcw = √w Jc, U = Jcwᵀ Jcw and
    bc = -Jcwᵀ (√w r), per-row products over the fused (slot x residual
    row) axis summed into cameras over each camera's rows.  Gauge masks
    are applied after the sums (a camera row is mask-uniform: U_masked =
    m mᵀ ⊙ U).  The point side is _build_pt_blocks_native's.  Returns
    (U [C,D,D], bc [C,D], Jcw [Rc,Mc,2,D] unmasked) in Jc's dtype."""
    C = p.cam_q.shape[0]
    D = Jc.shape[-1]
    Rc, Mc = ell.cam.slots.shape
    sw = torch.sqrt(w.clamp_min(0.0))
    Jcw = Jc * sw[..., None, None]
    swr = r * sw[..., None]  # [Rc,Mc,2]
    A = Jcw.reshape(Rc, Mc * 2, D)
    U_rows = A.transpose(1, 2) @ A
    bc_rows = -_mv(A.transpose(1, 2), swr.reshape(Rc, Mc * 2))
    U = segment_sum(U_rows, ell.cam.seg, C)
    bc = segment_sum(bc_rows, ell.cam.seg, C)
    m = _cam_colmask(p, D > 6)
    return U * (m[:, :, None] * m[:, None, :]), bc * m, Jcw


def _pt_reduce(p: BAProblem, ell: EllIndex, Jpg, spg):
    """V = Σ w Jpᵀ Jp and bp = -Σ Jpᵀ (w r) of each point from its rows of
    (Jpg [Rp,Lw,2,3], spg [Rp,Lw,4]), frozen points zeroed."""
    Rp, Lw = ell.pt.slots.shape
    P = p.points.shape[0]
    A2 = (Jpg * spg[..., 0][..., None, None]).reshape(Rp, Lw * 2, 3)
    B2 = Jpg.reshape(Rp, Lw * 2, 3)
    V_rows = A2.transpose(1, 2) @ B2
    bp_rows = -_mv(B2.transpose(1, 2), spg[..., 1:3].reshape(Rp, -1))
    V = segment_sum(V_rows, ell.pt.seg, P)
    bp = segment_sum(bp_rows, ell.pt.seg, P)
    ptm = (~p.fix_pt).to(V.dtype)
    return V * ptm[:, None, None], bp * ptm[:, None]


def _build_pt_blocks_native(p: BAProblem, ell: EllIndex, huber_px):
    """Point blocks recomputed in the point-major layout: per-slot camera
    parameters from the small [C, 15] table, the point row-uniform, pixels
    and weights from the static point-major copies pt_uv / pt_w, so no
    observation-sized array is gathered from the camera-major table.
    Returns V [P,3,3], bp [P,3] and (Jpg [Rp,Lw,2,3], spg [Rp,Lw,4]) in
    the problem's dtype, as _schur_solve_ell's pt_gathers wants them; a
    slot of weight 0 has Jpg and spg zero."""
    g = ell.pt.other  # [Rp,Lw] camera id per slot (0 on padding)
    gt = torch.cat([p.cam_q, p.cam_t, p.cam_intri], dim=1)[g]  # [Rp,Lw,15]
    q, t, intri = gt[..., :4], gt[..., 4:7], gt[..., 7:15]
    xyz = p.points[ell.pt.seg]  # [Rp,3] row-uniform
    # the quaternion rotation itself (an elementwise chain), no per-slot
    # rotation matrices
    pc = G.quat_rotate(q, xyz[:, None, :].expand(g.shape + (3,))) + t
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    r = Cam.normalized_to_image(intri, proj) - ell.pt_uv
    _, w = _robust_cost_and_weight(r, z, ell.pt_w, huber_px)
    A = intri[..., :2, None] * Cam.distort_jacobian(intri, proj)
    B = _proj_jacobian(A, pc, 1.0 / zs)  # [Rp,Lw,2,3]
    # Jp rows = B rows R = Rᵀ b: the inverse rotation of each row of B
    Jp = G.quat_rotate(G.quat_conj(q)[..., None, :], B)
    # a slot of weight 0 (padding, evaluated against camera 0; the guard)
    # carries zeros: with k1, k2 set, a point near that camera's plane
    # gives it a Jacobian and a residual that overflow, and 0 x inf would
    # reach V, bp and the Schur solve
    live = (w != 0)[..., None]
    Jpg = torch.where(live[..., None], Jp, 0.0)
    spg = torch.cat([w[..., None], torch.where(live, r * w[..., None], 0.0),
                     torch.zeros_like(w)[..., None]], dim=-1)
    V, bp = _pt_reduce(p, ell, Jpg, spg)
    return V, bp, (Jpg, spg)


def _chol3x3(M):
    """Batched closed-form lower Cholesky factor of SPD 3x3 blocks
    (guarded)."""
    l00 = torch.sqrt(M[..., 0, 0].clamp_min(1e-12))
    l10 = M[..., 1, 0] / l00
    l20 = M[..., 2, 0] / l00
    l11 = torch.sqrt((M[..., 1, 1] - l10 * l10).clamp_min(1e-12))
    l21 = (M[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt((M[..., 2, 2] - l20 * l20 - l21 * l21).clamp_min(1e-12))
    zero = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, zero, zero], -1),
                        torch.stack([l10, l11, zero], -1),
                        torch.stack([l20, l21, l22], -1)], dim=-2)


def _schur_solve_ell(p: BAProblem, ell: EllIndex, U, V, bc, bp, lam,
                     cg_iters, cg_tol, pt_gathers, cam_w):
    """ELL Schur solve: points marginalized in closed form, PCG on the
    reduced camera system, back-substitution.

    With L = chol(V⁻¹), Y_o = w_o Jc_oᵀ Jp_o L_p absorbs the point
    marginalization (G V⁻¹ Gᵀ = (G L)(G L)ᵀ).  Y = Jcᵀ Z with Z = w Jp L
    [.,2,3] is never built: Yᵀx = Zᵀ(Jc x), Y z = Jcᵀ(Z z), Σ Y Yᵀ =
    Jcᵀ (Z Zᵀ) Jc.  The √w of each slot is split between the two sides
    (the JAX package's weighted point-major mode): every camera-side
    product uses cam_w = √w Jc (cam_rows' Jcw, gauge masks applied per
    camera after each sum), and Z' = √w Jp L lives only in point order,
    from pt_gathers = (Jpg, spg) (pt_rows'), with L row-uniform there; the
    small per-slot results b = Z' z [2] and Z' Z'ᵀ [2,2] cross to the
    camera rows through ell.pt_pos.  With a 14-column cam_w the
    tied-intrinsics space of _TiedSpace holds the PCG vectors.  Every
    operand is in U's dtype.  PCG (_Pcg) reads its stop test on the host
    once an iteration, on a GPU after replaying the iteration as a CUDA
    graph captured for this call, and carries Σ alpha ypt(p_k), so the
    back-substitution needs no further point sum.  Returns (dx_c [C,D],
    dx_p [P,3])."""
    with span("xrsfm.ba.schur"):
        C = p.cam_q.shape[0]
        P = p.points.shape[0]
        D = U.shape[-1]
        Rc, Mc = ell.cam.slots.shape
        Rp, Lw = ell.pt.slots.shape
        Ud, Vinv, eyeD = _damped(U, V, lam)
        L = _chol3x3(Vinv)  # [P,3,3]
        ptm = (~p.fix_pt).to(U.dtype)
        m = _cam_colmask(p, D > 6)  # [C,D]
        # Z' = √w Jp L from the point-order gathers: L and the fix_pt mask
        # are row-uniform in point order
        Jpg, spg = pt_gathers
        sw = torch.sqrt(spg[..., 0].clamp_min(0.0))
        wrow = sw * ptm[ell.pt.seg][:, None]
        Zpt = (Jpg @ L[ell.pt.seg][:, None]) * wrow[..., None, None]
        Zrows = Zpt.reshape(Rp, Lw * 2, 3)
        Jrows = cam_w.reshape(Rc, Mc * 2, D)
        space = _TiedSpace(p.cam_kam, C) if D > 6 else _PlainSpace()

        def ypt_reduce(x):
            """yp[p] = Σ_{o in p} Y_oᵀ x_cam(o) = Σ Z_oᵀ (Jc_o x)  -> [P,3]"""
            a = _mv(Jrows, x[ell.cam.seg])
            apt = _gather_obs(a.reshape(-1, 2), ell.pt.slots)
            yrow = _mv(Zrows.transpose(1, 2), apt.reshape(Rp, Lw * 2))
            return segment_sum(yrow, ell.pt.seg, P)

        def cam_reduce(b):
            """Σ_{o in c} Jc_oᵀ b_o -> [C,D], masked per camera"""
            trow = _mv(Jrows.transpose(1, 2), b.reshape(Rc, Mc * 2))
            return segment_sum(trow, ell.cam.seg, C) * m

        def ycam_reduce(zp):
            """t[c] = Σ_{o in c} Y_o z_pt(o) = Σ Jc_oᵀ (Z_o z)  -> [C,D]:
            z is row-uniform in point order; only the [2]-vector result
            crosses the layouts"""
            b_pt = _mv(Zrows, zp[ell.pt.seg])
            return cam_reduce(_gather_obs(b_pt.reshape(-1, 2), ell.pt_pos))

        def S_matvec(x, ypx):
            return space.proj(_mv(Ud, x) - ycam_reduce(ypx))

        # rhs = bc - Σ_o Y_o (Lᵀ bp)_pt(o), and the per-slot 2x2 Gram of Z
        # that the preconditioner needs: both cross to the camera rows in
        # one 6-wide payload gather
        u = _mv(L.transpose(1, 2), bp)  # Lᵀ bp [P,3]
        b_pt = _mv(Zrows, u[ell.pt.seg]).reshape(Rp, Lw, 2)
        Gz_pt = Zpt @ Zpt.transpose(-1, -2)  # [Rp,Lw,2,2]
        payload = torch.cat([b_pt, Gz_pt.reshape(Rp, Lw, 4)], dim=-1)
        pay = _gather_obs(payload.reshape(-1, 6), ell.pt_pos)  # [Rc,Mc,6]
        Gz = pay[..., 2:].reshape(Rc, Mc, 2, 2)
        rhs = space.proj(bc - cam_reduce(pay[..., :2]))
        Hz = Gz @ cam_w  # [Rc,Mc,2,D]
        S_rows = Jrows.transpose(1, 2) @ Hz.reshape(Rc, Mc * 2, D)
        # masked blocks kept exactly Ud's (SPD)
        corr = segment_sum(S_rows, ell.cam.seg, C) \
            * (m[:, :, None] * m[:, None, :])
        precond = _block_jacobi(Ud - corr + 1e-7 * eyeD, space, eyeD)

    with span("xrsfm.ba.pcg"):
        pcg = _Pcg(rhs, P, ypt_reduce, S_matvec, precond, space.dot, cg_tol)
        pcg.run(cg_iters, graph=True)
        # dp = V⁻¹ bp - L Σ_{o in p} Y_oᵀ dx_cam(o)
        return pcg.x, _mv(Vinv, bp) - _mv(L, pcg.ypx)


class _Pcg:
    """Block-Jacobi PCG on one LM step's reduced camera system S x = rhs
    (_schur_solve_ell, _schur_solve), held in state tensors that `step`
    updates in place: x; ypx = Σ alpha_k ypt(p_k), which is ypt(x) by
    linearity (x starts at 0) and spares the ELL back-substitution a point
    sum; the residual r (rhs itself, overwritten); the direction pk; rz =
    rᵀ M⁻¹ r; and go, the next iteration's stop test sqrt(rᵀ r) > cg_tol
    |rhs|.  ypt_reduce(x) is the matvec's point sum and S_matvec(x,
    ypt_reduce(x)) the matvec.  The in-place and out= operations compute
    what an out-of-place loop computes, in the same order, bit for bit.

    Since the state keeps its addresses, `run` on a GPU can capture the
    step once as a CUDA graph (_pcg_graph) and replay it each iteration:
    one graph launch in place of the step's ~45 kernels.  The graph reads
    the setup's tensors (Jacobians, Z, the preconditioner) by address,
    with no copy, so it is never replayed after run returns."""

    def __init__(self, rhs, n_pts, ypt_reduce, S_matvec, precond, dot,
                 cg_tol):
        self.ypt_reduce, self.S_matvec = ypt_reduce, S_matvec
        self.precond, self.dot = precond, dot
        self.x = torch.zeros_like(rhs)
        self.r = rhs
        self.pk = precond(rhs)
        self.rz = dot(rhs, self.pk)
        self.thr = cg_tol * (torch.sqrt(dot(rhs, rhs)) + 1e-30)
        self.ypx = rhs.new_zeros((n_pts, 3))
        self.go = None

    def test(self, out=None):
        """sqrt(rᵀ r) > cg_tol |rhs|: another iteration is due."""
        return torch.gt(torch.sqrt(self.dot(self.r, self.r)), self.thr,
                        out=out)

    def step(self):
        """One iteration, in place; ends with the next stop test in go."""
        ypp = self.ypt_reduce(self.pk)  # the matvec's point sum
        Ap = self.S_matvec(self.pk, ypp)
        denom = self.dot(self.pk, Ap)
        alpha = self.rz / torch.where(denom.abs() < 1e-30, 1e-30, denom)
        self.x.add_(alpha * self.pk)
        self.ypx.add_(alpha * ypp)
        self.r.sub_(alpha * Ap)
        z = self.precond(self.r)
        rz_den = torch.where(self.rz.abs() < 1e-30, 1e-30, self.rz)
        self.dot(self.r, z, out=self.rz)
        beta = self.rz / rz_den
        torch.add(z, beta * self.pk, out=self.pk)
        self.test(out=self.go)

    def run(self, cg_iters, graph):
        """At most cg_iters iterations while the stop test holds, read on
        the host before each (none when cg_iters is 0).  graph: replay
        the step as a CUDA graph where the state lies on a GPU (False
        where the matvec's sums may cross devices)."""
        if cg_iters <= 0:
            return
        self.go = self.test()
        if not bool(self.go):
            return
        replay = (_pcg_graph(self.step, self.r.device).replay
                  if graph and self.r.is_cuda else None)
        for k in range(cg_iters):
            COUNTS["cg_iters"] += 1
            if replay is None:
                self.step()
            else:
                COUNTS["pcg_graph_replays"] += 1
                replay()
            if k + 1 == cg_iters or not bool(self.go):
                break


# A stream a device for bundle adjustment, and the PCG graph captured last
# on it (never replayed again; it holds the graphs' memory pool, which
# PyTorch frees once no graph uses it), kept for the process.
_BA_STREAMS = {}
_LAST_GRAPH = {}


@contextlib.contextmanager
def _on_ba_stream(device):
    """Run the block on the device's BA stream, after the work queued so
    far on the current stream, which then waits for the block's work; a
    no-op on the CPU and on the BA stream itself.  cuBLAS keeps a
    workspace (32 MiB on an H100) for each stream it runs on, so the
    solve's eager work and its graphs share this one stream, and one
    workspace."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev):
        idx = torch.cuda.current_device()
        if idx not in _BA_STREAMS:
            _BA_STREAMS[idx] = torch.cuda.Stream()
        cur, side = torch.cuda.current_stream(), _BA_STREAMS[idx]
        if cur == side:
            yield
            return
        side.wait_stream(cur)
        try:
            with torch.cuda.stream(side):
                yield
        finally:
            cur.wait_stream(side)


def _pcg_graph(step, device):
    """step() captured as a CUDA graph on the device's BA stream, not run.
    Unlike torch.cuda.graph, no device-wide synchronise and no cache flush;
    thread_local mode, so that the profiler's own threads may call CUDA
    meanwhile.  The graph's temporaries come from one pool that every PCG
    graph of the device shares, so a capture allocates nothing new once
    the pool holds an iteration.  An operation of step that reads the
    device on the host fails the capture."""
    with _on_ba_stream(device):
        idx = torch.cuda.current_device()
        last = _LAST_GRAPH.get(idx)
        graph = torch.cuda.CUDAGraph()
        with span("xrsfm.ba.pcg.capture"):
            graph.capture_begin(
                pool=(last.pool() if last is not None
                      else torch.cuda.graph_pool_handle()),
                capture_error_mode="thread_local")
            try:
                step()
            finally:
                graph.capture_end()
        _LAST_GRAPH[idx] = graph
    COUNTS["pcg_graph_captures"] += 1
    return graph


# ---------------------------------------------------------------------------
# The row kernels (csrc/ba_cam_rows.cu, csrc/ba_pt_rows.cu)
# ---------------------------------------------------------------------------


def cam_rows_plain(p: BAProblem, ell: EllIndex, huber_px,
                   with_intri: bool = False):
    """Plain version of the camera-row kernel, in the problem's dtype:
    _residuals_and_jacobians_rows, _robust_cost_and_weight and
    _build_normal_blocks_ell.  Returns (robust cost of the table, U
    [C,D,D] and bc [C,D] gauge-masked, Jcw [Rc,Mc,2,D])."""
    r, z, Jc, _ = _residuals_and_jacobians_rows(p, ell, with_intri)
    cost, w = _robust_cost_and_weight(
        r, z, p.obs_w.reshape(ell.cam.slots.shape), huber_px)
    return (cost,) + _build_normal_blocks_ell(p, ell, r, Jc, w)


def pt_rows_plain(p: BAProblem, ell: EllIndex, huber_px):
    """Plain version of the point-row kernel: _build_pt_blocks_native.
    Returns (V [P,3,3], bp [P,3], (Jpg [Rp,Lw,2,3], spg [Rp,Lw,4]))."""
    return _build_pt_blocks_native(p, ell, huber_px)


def _check_cuda(dev, **tensors):
    """Raise unless each (tensor, dtype, shape) lies on dev, contiguous,
    with that dtype and shape."""
    for name, (t, dt, shape) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, not {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(source, symbol, args, dev):
    """Call csrc/<source>'s C launcher on dev's current stream (tensors and
    None as pointers, ints as c_int, floats as c_float); raise on a
    non-zero cudaError_t."""
    import ctypes

    from ..kernels import build

    fn = getattr(build.load(source), symbol)
    types = {int: ctypes.c_int, float: ctypes.c_float}
    fn.argtypes = [types.get(type(a), ctypes.c_void_p) for a in args] \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vals = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*vals, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{source} launch failed: cudaError_t {err}")


def _row_masks(p: BAProblem, with_intri: bool):
    """The problem's own freeze flags as the camera-row kernel reads them
    (fix_cam, fix_rot, fix_trans, fix_intri, tie_f: bool tensors, None
    where the problem has none or D = 6 does not read them).  The kernel
    forms _cam_colmask(p, with_intri) from them: rotation columns free
    unless fix_cam or fix_rot, translation columns unless fix_cam or
    fix_trans, intrinsic column k unless fix_intri[:, k], and the log fy
    column also unless tie_f."""
    return (p.fix_cam, p.fix_rot, p.fix_trans,
            p.fix_intri if with_intri else None,
            p.tie_f if with_intri else None)


def cam_rows_cuda(p: BAProblem, ell: EllIndex, huber_px,
                  with_intri: bool = False):
    """The kernel csrc/ba_cam_rows.cu: cam_rows_plain's contract for a
    camera-major packed problem (pack_camera_major) on a CUDA device, whose
    ids the kernel trusts.  Rows at most 128 slots wide.  Two launches (the
    rows, then the cameras with the gauge masks and the cost); the row
    partials go to scratch allocated here.  Builds the kernel on first use;
    raises on a bad input, a failed build or a refused launch."""
    dev = p.cam_q.device
    C, P = p.cam_q.shape[0], p.points.shape[0]
    Rc, Mc = ell.cam.slots.shape
    D = 14 if with_intri else 6
    if not (1 <= Mc <= 128 and C >= 1):
        raise ValueError(f"cam_rows: needs camera rows of 1..128 slots and "
                         f"a camera, got {Rc}x{Mc}, C={C}")
    if with_intri and p.fix_intri is None:
        raise ValueError("cam_rows: D = 14 needs fix_intri")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    _check_cuda(dev, cam_q=(p.cam_q, f32, (C, 4)),
                cam_t=(p.cam_t, f32, (C, 3)),
                cam_intri=(p.cam_intri, f32, (C, 8)),
                points=(p.points, f32, (P, 3)),
                obs_uv=(p.obs_uv, f32, (Rc * Mc, 2)),
                obs_w=(p.obs_w, f32, (Rc * Mc,)),
                other=(ell.cam.other, i32, (Rc, Mc)),
                seg=(ell.cam.seg, i32, (Rc,)),
                starts=(ell.cam.starts, i32, (C + 1,)))
    masks = _row_masks(p, with_intri)
    for name, m, shape in zip(("fix_cam", "fix_rot", "fix_trans",
                               "fix_intri", "tie_f"), masks,
                              ((C,), (C,), (C,), (C, 8), (C,))):
        if m is not None:
            _check_cuda(dev, **{name: (m, b8, shape)})
    NV = D * (D + 1) // 2 + D + 1
    U = torch.empty((C, D, D), dtype=f32, device=dev)
    bc = torch.empty((C, D), dtype=f32, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    Jcw = torch.empty((Rc, Mc, 2, D), dtype=f32, device=dev)
    part = torch.empty((Rc, NV), dtype=f32, device=dev)  # row partials
    _launch("ba_cam_rows.cu", "ba_cam_rows_launch",
            [p.cam_q, p.cam_t, p.cam_intri, p.points, p.obs_uv, p.obs_w,
             ell.cam.other, ell.cam.seg, ell.cam.starts, *masks, C, Rc, Mc,
             D, float(huber_px), U, bc, cost, Jcw, part], dev)
    LAUNCHES["ba_cam_rows_cuda"] += 1
    return cost, U, bc, Jcw


def pt_rows_cuda(p: BAProblem, ell: EllIndex, huber_px):
    """The kernel csrc/ba_pt_rows.cu: pt_rows_plain's contract for a
    camera-major packed problem on a CUDA device, whose ids the kernel
    trusts.  Point rows 8, 16 or 32 slots wide (the widths
    pack_camera_major gives).  Builds the kernel on first use; raises on a
    bad input, a failed build or a refused launch."""
    dev = p.cam_q.device
    C, P = p.cam_q.shape[0], p.points.shape[0]
    Rp, Lw = ell.pt.slots.shape
    if Lw not in (8, 16, 32) or P < 1:
        raise ValueError(f"pt_rows: needs pack_camera_major's point rows "
                         f"of 8, 16 or 32 slots and a point, got {Rp}x{Lw}, "
                         f"P={P}")
    f32, i32 = torch.float32, torch.int32
    _check_cuda(dev, cam_q=(p.cam_q, f32, (C, 4)),
                cam_t=(p.cam_t, f32, (C, 3)),
                cam_intri=(p.cam_intri, f32, (C, 8)),
                points=(p.points, f32, (P, 3)),
                pt_uv=(ell.pt_uv, f32, (Rp, Lw, 2)),
                pt_w=(ell.pt_w, f32, (Rp, Lw)),
                other=(ell.pt.other, i32, (Rp, Lw)),
                starts=(ell.pt.starts, i32, (P + 1,)),
                fix_pt=(p.fix_pt, torch.bool, (P,)))
    V = torch.empty((P, 3, 3), dtype=f32, device=dev)
    bp = torch.empty((P, 3), dtype=f32, device=dev)
    Jpg = torch.empty((Rp, Lw, 2, 3), dtype=f32, device=dev)
    spg = torch.empty((Rp, Lw, 4), dtype=f32, device=dev)
    _launch("ba_pt_rows.cu", "ba_pt_rows_launch",
            [p.cam_q, p.cam_t, p.cam_intri, p.points, ell.pt_uv, ell.pt_w,
             ell.pt.other, ell.pt.starts, p.fix_pt, P, Lw, float(huber_px),
             V, bp, Jpg, spg], dev)
    LAUNCHES["ba_pt_rows_cuda"] += 1
    return V, bp, (Jpg, spg)


def cam_rows(p: BAProblem, ell: EllIndex, huber_px, with_intri: bool = False):
    """Camera side of one LM iteration in the camera-row layout: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    ROW_SHAPES["cam"][(p.cam_q.shape[0],) + tuple(ell.cam.slots.shape)] += 1
    if p.cam_q.device.type == "cuda":
        return cam_rows_cuda(p, ell, huber_px, with_intri)
    if p.cam_q.device.type != "cpu":
        raise ValueError(f"unsupported device {p.cam_q.device}")
    LAUNCHES["ba_cam_rows_plain"] += 1
    return cam_rows_plain(p, ell, huber_px, with_intri)


def pt_rows(p: BAProblem, ell: EllIndex, huber_px):
    """Point side of one LM iteration in the point-row layout: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    ROW_SHAPES["pt"][(p.points.shape[0],) + tuple(ell.pt.slots.shape)] += 1
    if p.cam_q.device.type == "cuda":
        return pt_rows_cuda(p, ell, huber_px)
    if p.cam_q.device.type != "cpu":
        raise ValueError(f"unsupported device {p.cam_q.device}")
    LAUNCHES["ba_pt_rows_plain"] += 1
    return pt_rows_plain(p, ell, huber_px)


def _apply_step(p: BAProblem, dx_c, dx_p) -> BAProblem:
    """Retract the free parameters; frozen ones (fix_cam, fix_rot,
    fix_trans, fix_pt) are kept bit for bit (the JAX package re-normalizes
    frozen quaternions, a last-bit change).
    With intrinsics: f exp(dlog f) per axis (both from column 0 when
    tied), additive cx, cy, k1, k2, p1, p2."""
    q2, t2 = G.pose_retract(p.cam_q, p.cam_t, dx_c[:, :6])
    fix_c = p.fix_cam[:, None]
    out = dataclasses.replace(
        p,
        cam_q=torch.where(_rot_frozen(p)[:, None], p.cam_q, q2),
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


def solve_ba(p: BAProblem, opts: BAOptions = BAOptions(),
             ell: EllIndex | None = None):
    """Run LM.  Returns (solved problem, info dict with float
    initial_cost, final_cost, lam and int iters).

    ell: None runs the COO solver; the EllIndex of p that
    pack_camera_major returned with it runs the ELL solver through the
    camera rows (the row kernels on a GPU)."""
    if opts.optimize_intrinsics and (p.cam_kam is None
                                     or p.fix_intri is None):
        raise ValueError("optimize_intrinsics requires cam_kam and "
                         "fix_intri on the problem")
    dev = "cuda" if p.cam_q.is_cuda else "cpu"
    COUNTS[f"solves_{dev}"] += 1
    if opts.optimize_intrinsics:
        COUNTS[f"intri_solves_{dev}"] += 1
    if ell is not None:
        COUNTS[f"row_solves_{dev}"] += 1
    with span("xrsfm.ba.solve"), full_precision(), \
            _on_ba_stream(p.cam_q.device):
        if ell is None:
            return _solve(p, opts)
        return _solve_ell(p, opts, ell)


def _solve(p: BAProblem, opts: BAOptions):
    def cost_of(prob):
        r, z = _residuals_only(prob)
        return _robust_cost_and_weight(r, z, prob.obs_w, opts.huber_px)[0]

    def step(prob, lam):
        with span("xrsfm.ba.rows"):
            r, z, Jc, Jp = _residuals_and_jacobians(
                prob, with_intri=opts.optimize_intrinsics)
            _, w = _robust_cost_and_weight(r, z, prob.obs_w, opts.huber_px)
            U, V, W, bc, bp = _build_normal_blocks([prob], [r], [Jc], [Jp],
                                                   [w])
        return _schur_solve([prob], U, V, W, bc, bp, lam, opts.cg_iters,
                            opts.cg_tol)

    return _lm(p, opts, cost_of, step)


def _solve_ell(p: BAProblem, opts: BAOptions, ell: EllIndex):
    with_intri = opts.optimize_intrinsics

    def cost_of(prob):
        r, z = _residuals_only_rows(prob, ell)
        return _robust_cost_and_weight(
            r, z, prob.obs_w.reshape(ell.cam.slots.shape), opts.huber_px)[0]

    def step(prob, lam):
        with span("xrsfm.ba.rows"):
            # the camera side from the camera rows, the point side
            # recomputed in point order; √w Jc shared with the Schur solve
            _, U, bc, camw = cam_rows(prob, ell, opts.huber_px, with_intri)
            V, bp, ptg = pt_rows(prob, ell, opts.huber_px)
        return _schur_solve_ell(prob, ell, U, V, bc, bp, lam, opts.cg_iters,
                                opts.cg_tol, ptg, camw)

    return _lm(p, opts, cost_of, step)


def _depths(p: BAProblem):
    """The depth of every observation [O]: the third row of its camera's
    rotation times its point, plus t_z (the z of _project / _row_project)."""
    R = G.quat_to_rotmat(p.cam_q)
    return (R[p.obs_cam, 2] * p.points[p.obs_pt]).sum(dim=-1) \
        + p.cam_t[p.obs_cam, 2]


def _keep_in_front(p: BAProblem, cand: BAProblem):
    """The candidate with every point put back where it is in p whose step
    carries one of its observations from in front of the camera (a depth
    above the guard's 1e-3) onto or behind the camera's plane.

    The linearized step knows nothing of that plane: a point two views
    barely fix in depth can be sent tens of metres, through both cameras'
    planes, while the rest of the step lowers the cost enough to be
    accepted.  The guard (_robust_cost_and_weight) then gives its
    observations a constant cost and no weight, and every later step that
    moves those cameras brings the point back just in front of a plane,
    where its residual is millions of pixels: every candidate is rejected
    and LM stalls.  The cost is unchanged; only the candidate is.  Padding
    and weight-0 observations take no part.  The crossings are counted per
    point with float adds of 0 and 1, exact in any order."""
    cross = (_depths(p) > 1e-3) & (_depths(cand) <= 1e-3) & (p.obs_w > 0)
    n = torch.zeros(p.points.shape[0], dtype=p.points.dtype,
                    device=p.points.device)
    back = n.index_add_(0, p.obs_pt, cross.to(n.dtype)) > 0
    return dataclasses.replace(
        cand, points=torch.where(back[:, None], p.points, cand.points))


def _lm(p: BAProblem, opts: BAOptions, cost_of, step):
    """The LM loop: step(problem, lambda) -> (dx_c, dx_p), accepted when
    cost_of the candidate is lower.  With the intrinsics free the
    candidate goes through _keep_in_front: without it such solves stall.
    Pose-only solves take the step as it is, as the reference does: there
    the rule would hold a point that each step sends across a plane at
    its large residual where the reference lets the guard take it, and
    move the result off the reference's (local BA at Dubrovnik's shape:
    19 of 32 problems moved, their costs a median 4e-4 and up to 4.2e-3
    from the reference's, against 1e-6 and 1.5e-4 without the rule; CPU,
    tests/test_torch_ba_stall.py).  Each iteration is a span
    xrsfm.ba.lm_step: the step's spans (rows, schur, pcg), then
    xrsfm.ba.cost around the candidate's cost, the accept and the stop
    test's read.  The accepted candidates are summed on the device and
    read with the final cost (info["accepts"], COUNTS["lm_accepts"])."""
    keep = opts.optimize_intrinsics
    with span("xrsfm.ba.cost"):
        c0 = cost_of(p)
    cost = c0
    lam = torch.tensor(opts.lam_init, dtype=p.cam_q.dtype,
                       device=p.cam_q.device)
    accepts = torch.zeros((), dtype=torch.int64, device=p.cam_q.device)
    it = 0
    done = False
    while it < opts.max_iters and not done:
        with span("xrsfm.ba.lm_step"):
            COUNTS["lm_iters"] += 1
            dx_c, dx_p = step(p, lam)
            with span("xrsfm.ba.cost"):
                cand = _apply_step(p, dx_c, dx_p)
                if keep:
                    cand = _keep_in_front(p, cand)
                new_cost = cost_of(cand)
                accept = new_cost < cost
                p = dataclasses.replace(
                    p,
                    cam_q=torch.where(accept, cand.cam_q, p.cam_q),
                    cam_t=torch.where(accept, cand.cam_t, p.cam_t),
                    cam_intri=(torch.where(accept, cand.cam_intri,
                                           p.cam_intri)
                               if opts.optimize_intrinsics
                               else p.cam_intri),
                    points=torch.where(accept, cand.points, p.points),
                )
                accepts += accept
                cost2 = torch.where(accept, new_cost, cost)
                lam2 = torch.where(accept, lam * opts.lam_down,
                                   lam * opts.lam_up)
                lam2 = lam2.clamp(1e-10, opts.lam_max)
                rel = (cost - cost2).abs() / cost.clamp_min(1e-12)
                # early stop only when damping is back near nominal: a
                # tiny accepted step at high lambda is a plateau, not
                # convergence
                done = bool(accept & (rel < 1e-6)
                            & (lam <= 10.0 * opts.lam_init))
                it += 1
                cost, lam = cost2, lam2
    # one read for every number the caller gets (float64 holds the float32
    # values and the count exactly)
    c0, cost, lam, n_acc = torch.stack(
        [c0.double(), cost.double(), lam.double(), accepts.double()]).tolist()
    COUNTS["lm_accepts"] += int(n_acc)
    info = dict(initial_cost=c0, final_cost=cost, iters=it, lam=lam,
                accepts=int(n_acc))
    return p, info
