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
    packs every single-device problem).  The table is reordered so that
    each camera's observations are consecutive rows of at most 128 slots,
    and a point-major index (rows of at most 32 slots) maps each point's
    observations into it.  Camera data is read once a row, the camera
    blocks are reductions over consecutive rows, and the point blocks are
    recomputed in point order (_build_pt_blocks_native).  On a GPU the two
    per-iteration block builds are the hand-written kernels
    csrc/ba_cam_rows.cu and csrc/ba_pt_rows.cu (cam_rows / pt_rows: the
    kernel for CUDA tensors, the plain composition of this module's
    functions for CPU tensors).  The Schur solve keeps the factored
    Y = Jcᵀ Z form (_schur_solve_ell) and never builds the [O, D, 3]
    coupling blocks.  A flat ELL (build_ell, contig False) runs the same
    solve through gathers.

Common to both:
  * Points are marginalized with closed-form 3x3 inverses and the reduced
    camera system is solved matrix-free by block-Jacobi PCG (Ceres'
    SCHUR_JACOBI).
  * Huber robustness is IRLS re-weighting; the reference's negative-depth
    guard (constant residual (12, 12), cost_factor_ceres.h:29-32) becomes
    zero IRLS weight and a constant cost.
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
from the device.  Everything solve_ba runs is float32, on a GPU inside
`device.full_precision()` (no TF32).  The ELL functions keep the JAX
package's pt_dtype / compute_dtype arguments (bfloat16 there by default,
the JAX package's bf16 Schur operands); solve_ba and the tools pass
float32.
"""

from __future__ import annotations

import collections
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
# layout, and what its host loops cost.
COUNTS = {"solves_cuda": 0, "solves_cpu": 0, "intri_solves_cuda": 0,
          "intri_solves_cpu": 0, "row_solves_cuda": 0, "row_solves_cpu": 0,
          "dist_solves_cuda": 0, "dist_solves_cpu": 0,
          "lm_iters": 0, "cg_iters": 0}

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
# The camera-major ELL layout (host-side numpy, then one transfer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowIndex:
    """One side (camera or point) of the ELL observation layout.

    The observations of each segment (camera / point) are packed into
    rows of a fixed width M; a heavy segment spans several consecutive
    rows, so padding is at most M - 1 a segment.  A per-segment reduction
    is then a per-row reduction and a sum over the segment's rows.  With
    `contig` (pack_camera_major's camera side) the observation table
    itself is stored in this row order, and the row view of a
    per-observation array is a reshape."""

    slots: torch.Tensor  # [R, M] int32 flat observation index, O on padding
    seg: torch.Tensor  # [R] int32 segment id of each row (non-decreasing)
    other: torch.Tensor  # [R, M] int32 the other side's id per slot, 0 pad
    # [n_seg + 1] int32: the rows of segment s are starts[s]..starts[s+1]-1
    # (every segment has at least one row); the row kernels loop over them
    starts: torch.Tensor
    contig: bool = False


@dataclasses.dataclass
class EllIndex:
    """ELL slot tables of a problem (build_ell, pack_camera_major).

    pt_uv / pt_w are pack_camera_major's point-major copies of the pixel
    observations and base weights, from which the point blocks are
    recomputed in point order (_build_pt_blocks_native); they mirror
    obs_uv / obs_w at pack time.  pt_pos maps each camera-major slot to
    its position in the flat point-major order (Rp * Lw on padding), so
    that small per-slot results computed point-major cross back to the
    camera rows."""

    cam: RowIndex  # camera-major rows
    pt: RowIndex  # point-major rows
    pt_uv: torch.Tensor | None = None  # [Rp, Lw, 2]
    pt_w: torch.Tensor | None = None  # [Rp, Lw]
    pt_pos: torch.Tensor | None = None  # [Rc, Mc] int32


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _build_rows(ids, other_ids, n_seg, O_full, max_width, bucket_lo):
    """Pack per-segment observation lists into rows of width
    min(bucket(largest count), max_width), exactly as many rows as the
    segments need (the JAX package rounds the row count up to a bucket of
    XLA shapes; no kernel here needs that).  Returns numpy (slots, seg,
    other, starts)."""
    n = len(ids)
    counts = np.bincount(ids, minlength=n_seg)
    maxc = int(counts.max()) if n else 1
    M = min(_bucket(max(maxc, 1), bucket_lo), max_width)
    rows_per_seg = np.maximum((counts + M - 1) // M, 1)
    starts = np.concatenate([[0], np.cumsum(rows_per_seg)])
    seg = np.repeat(np.arange(n_seg, dtype=np.int32), rows_per_seg)
    slots = np.full((int(starts[-1]), M), O_full, np.int32)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - seg_start[sorted_ids]
    slots[starts[sorted_ids] + pos // M, pos % M] = order
    other_pad = np.concatenate([np.asarray(other_ids, np.int32),
                                np.zeros(1, np.int32)])
    return slots, seg, other_pad[slots], starts.astype(np.int32)


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}


def _transfer(arrays, device):
    """numpy arrays -> tensors on `device` through ONE host-to-device copy:
    the arrays are laid end to end (8-byte aligned) in one byte buffer,
    copied, and viewed back as tensors of their types and shapes."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += (a.nbytes + 7) // 8 * 8
    buf = np.empty(max(n, 8), np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    return [dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
            for a, o in zip(arrays, offs)]


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def build_ell(obs_cam, obs_pt, n_cams: int, n_pts: int, n_valid=None,
              bucket_lo: int = 8) -> EllIndex:
    """ELL tables of a flat COO table (the JAX package's build_ell; numpy on
    the host).  Only the first n_valid observations take part (a padded
    table's weight-0 rows must not count).  Cameras get rows of at most
    256 slots, points of at most 32.  The tables go to obs_cam's device
    (the CPU for numpy input) in one transfer."""
    dev = obs_cam.device if torch.is_tensor(obs_cam) else "cpu"
    obs_cam, obs_pt = _np(obs_cam), _np(obs_pt)
    O_full = len(obs_cam)
    n = O_full if n_valid is None else int(n_valid)
    oc = obs_cam[:n].astype(np.int64)
    op = obs_pt[:n].astype(np.int64)
    # the `other` lookup spans the FULL table (slot O_full is padding)
    t = _transfer(_build_rows(oc, obs_pt, n_cams, O_full, 256, bucket_lo)
                  + _build_rows(op, obs_cam, n_pts, O_full, 32, bucket_lo),
                  dev)
    return EllIndex(cam=RowIndex(*t[:4]), pt=RowIndex(*t[4:]))


def pack_camera_major(p: BAProblem, n_valid=None, bucket_lo: int = 8,
                      cam_width: int = 128, pt_width: int = 32, device=None):
    """Reorder and physically pad the observation table camera-major (the
    JAX package's pack_camera_major).  Returns (packed problem, EllIndex)
    whose camera rows are consecutive slices of the table (contig), with
    the point-major index, pt_uv / pt_w and pt_pos.  Padding slots carry
    obs_w = 0 and point id 0, so they vanish from every reduction.  Host
    numpy, O(n log n); every tensor of the result goes to `device` (by
    default p's) in one transfer."""
    with span("xrsfm.ba.pack"):
        dev = device if device is not None else p.cam_q.device
        oc, op = _np(p.obs_cam), _np(p.obs_pt)
        O_full = len(oc)
        n = O_full if n_valid is None else int(n_valid)
        C = p.cam_q.shape[0]
        P = p.points.shape[0]
        slots, seg, _, cam_starts = _build_rows(
            oc[:n].astype(np.int64), op, C, O_full, cam_width, bucket_lo)
        Rc, Mc = slots.shape
        flat = slots.reshape(-1)
        real = flat < O_full
        O2 = Rc * Mc

        def take(a):
            a = _np(a)
            out = np.zeros((O2,) + a.shape[1:], a.dtype)
            out[real] = a[flat[real]]
            return out

        new_cam = np.repeat(seg, Mc).astype(np.int64)
        new_pt = np.zeros(O2, np.int64)
        new_pt[real] = op[flat[real]]
        packed = dict(obs_uv=take(p.obs_uv), obs_cam=new_cam, obs_pt=new_pt,
                      obs_w=take(p.obs_w))  # physical padding gets weight 0
        # point-side rows over the REAL slots of the packed table
        real_idx = np.nonzero(real)[0]
        nr = len(real_idx)
        cslots, pt_seg, _, pt_starts = _build_rows(
            new_pt[real_idx], new_cam[real_idx], P, nr, pt_width, bucket_lo)
        if nr:
            pt_slots = np.where(cslots < nr,
                                real_idx[np.minimum(cslots, nr - 1)],
                                O2).astype(np.int32)
        else:
            pt_slots = np.full_like(cslots, O2)
        pt_other = np.concatenate([new_cam, [0]]).astype(np.int32)[pt_slots]
        # static point-major copies of (uv, w), from which the point blocks
        # are recomputed in point order every LM iteration
        pvalid = pt_slots < O2
        pt_uv = np.zeros(pt_slots.shape + (2,), np.float32)
        pt_uv[pvalid] = packed["obs_uv"][pt_slots[pvalid]]
        pt_w = np.zeros(pt_slots.shape, np.float32)
        pt_w[pvalid] = packed["obs_w"][pt_slots[pvalid]]
        # reverse map: camera-major slot -> flat point-major position
        flat_pt = pt_slots.reshape(-1)
        pt_pos = np.full(O2, flat_pt.size, np.int32)  # sentinel on padding
        src = np.nonzero(flat_pt < O2)[0]
        pt_pos[flat_pt[src]] = src
        fields = {f.name: (packed[f.name] if f.name in packed
                           else _np(getattr(p, f.name)))
                  for f in dataclasses.fields(p)
                  if getattr(p, f.name) is not None}
        ell_arrays = [np.arange(O2, dtype=np.int32).reshape(Rc, Mc), seg,
                      new_pt.astype(np.int32).reshape(Rc, Mc), cam_starts,
                      pt_slots, pt_seg, pt_other, pt_starts,
                      pt_uv, pt_w, pt_pos.reshape(Rc, Mc)]
        t = _transfer(list(fields.values()) + ell_arrays, dev)
        p2 = dataclasses.replace(p, **dict(zip(fields, t)))
        e = t[len(fields):]
        return p2, EllIndex(cam=RowIndex(*e[:4], contig=True),
                            pt=RowIndex(*e[4:8]), pt_uv=e[8], pt_w=e[9],
                            pt_pos=e[10])


def _gather_obs(a, slots):
    """A per-observation array gathered by an ELL slot table; padding
    slots (index O, past the end) read as zero rows."""
    O = a.shape[0]
    g = a[slots.clamp_max(O - 1)]
    valid = (slots < O).to(a.dtype)
    return g * valid.reshape(valid.shape + (1,) * (a.dim() - 1))


def _gather_rows(a, ri: RowIndex):
    """A per-observation array in ELL row layout [R, M, ...]: a reshape
    when the table is stored in this order (contig)."""
    R, M = ri.slots.shape
    if ri.contig:
        return a.reshape((R, M) + tuple(a.shape[1:]))
    return _gather_obs(a, ri.slots)


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
    with span("xrsfm.ba.schur"):
        C, D = U.shape[0], U.shape[-1]
        P = ps[0].points.shape[0]
        eyeD = torch.eye(D, dtype=U.dtype, device=U.device)
        eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
        space = _TiedSpace(ps[0].cam_kam, C) if D > 6 else _PlainSpace()

        # multiplicative LM damping on the block diagonals
        Ud = U + lam * (U * eyeD) + 1e-8 * eyeD
        Vd = V + lam * (V * eye3) + 1e-8 * eye3
        Vinv = _inv3x3(Vd)

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

        def S_matvec(x):  # x [C, D]
            zp = _mv(Vinv, pt_sum(x))
            return space.proj(_mv(Ud, x) - cam_sum(zp))

        # rhs = bc - W Vinv bp
        rhs = space.proj(bc - cam_sum(_mv(Vinv, bp)))

        # block-Jacobi preconditioner, LU-inverted
        M_p, M_i = _jacobi_blocks(ps, Ud, Vinv, W, space, reduce_fn)
        n = M_p.shape[-1]
        Minv = linalg.solve(M_p, eyeD[:n, :n].expand(C, n, n))
        if M_i is None:
            def precond(x):
                return _mv(Minv, x)
        else:
            Minv_i = linalg.solve(M_i, eyeD[:8, :8].expand(C, 8, 8))

            def precond(x):
                xi = _mv(Minv_i, space.reduce(x))
                return torch.cat([_mv(Minv, x[:, :6]), xi[space.kam]], dim=1)

    with span("xrsfm.ba.pcg"):
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
        return x, _mv(Vinv, bp - pt_sum(x))


# ---------------------------------------------------------------------------
# ELL normal blocks and Schur solve
# ---------------------------------------------------------------------------


def _identity(x):
    return x


def _build_normal_blocks_ell(p: BAProblem, ell: EllIndex, r, Jc, Jp, w,
                             reduce_fn=None, return_pt_gathers=False,
                             pt_dtype=torch.bfloat16, cam_only=False,
                             return_cam_w=False):
    """Normal-equation blocks through ELL rows: per-row products over the
    fused (slot x residual row) axis, summed into segments over each
    segment's rows.  Gauge masks are applied after the sums (a camera row
    is mask-uniform: U_masked = m mᵀ ⊙ U; frozen points zero V and bp).

    Row-native input (Jc [Rc,Mc,2,D] from _residuals_and_jacobians_rows):
    the camera side uses the √w-scaled Jcw, U = Jcwᵀ Jcw and bc =
    -Jcwᵀ (√w r).  Flat input (Jc [O,2,D]) gathers the camera rows.  The
    point side gathers Jp and the packed scalars (w, w r0, w r1, 0) into
    point rows; return_pt_gathers hands those (Jpg, spg) to
    _schur_solve_ell, cam_only skips the point side (it then comes from
    _build_pt_blocks_native) and return_cam_w hands Jcw on (pt_dtype, no
    gauge mask).  Operands are cast to pt_dtype and products accumulate in
    float32; the JAX package's flat branch casts its camera operands to
    bfloat16 whatever pt_dtype says, the port to pt_dtype.  reduce_fn sums
    each segment reduction across shards (identity on one device)."""
    C = p.cam_q.shape[0]
    P = p.points.shape[0]
    red = reduce_fn if reduce_fn is not None else _identity
    row_native = Jc.dim() == 4
    sc_f = torch.cat([w[..., None], r * w[..., None],
                      torch.zeros_like(w)[..., None]], dim=-1)
    D = Jc.shape[-1]
    Rc, Mc = ell.cam.slots.shape
    if row_native:
        sw = torch.sqrt(w.clamp_min(0.0))
        Jcw = (Jc * sw[..., None, None]).to(pt_dtype)
        swr = (r * sw[..., None]).to(pt_dtype)  # [Rc,Mc,2]
        Jp16 = Jp.to(pt_dtype).reshape(-1, 2, 3)
        sc_flat = sc_f.to(pt_dtype).reshape(-1, 4)
        A = _acc(Jcw).reshape(Rc, Mc * 2, D)
        U_rows = A.transpose(1, 2) @ A
        bc_rows = -_mv(A.transpose(1, 2), _acc(swr).reshape(Rc, Mc * 2))
    else:
        Jc16 = Jc.to(pt_dtype)
        Jp16 = Jp.to(pt_dtype)
        sc_flat = sc_f.to(pt_dtype)
        Jcg = _gather_rows(Jc16, ell.cam)  # [Rc,Mc,2,D]
        scg = _gather_rows(sc_flat, ell.cam)  # [Rc,Mc,4]
        A = (Jcg * scg[..., 0][..., None, None]).float().reshape(Rc, Mc * 2, D)
        B = Jcg.float().reshape(Rc, Mc * 2, D)
        U_rows = A.transpose(1, 2) @ B
        bc_rows = -_mv(B.transpose(1, 2),
                       scg[..., 1:3].float().reshape(Rc, Mc * 2))
    U = red(segment_sum(U_rows, ell.cam.seg, C))
    bc = red(segment_sum(bc_rows, ell.cam.seg, C))
    m = _cam_colmask(p, D > 6)
    U = U * (m[:, :, None] * m[:, None, :])
    bc = bc * m
    if cam_only:
        return (U, bc, Jcw) if return_cam_w else (U, bc)

    Rp, Lw = ell.pt.slots.shape
    Jpg = _gather_rows(Jp16, ell.pt)  # [Rp,Lw,2,3]
    spg = _gather_rows(sc_flat, ell.pt)  # [Rp,Lw,4]
    V, bp = _pt_reduce(p, ell, Jpg, spg, red)
    if return_pt_gathers:
        return U, V, bc, bp, (Jpg, spg)
    return U, V, bc, bp


def _acc(x):
    """x in the accumulation type: float32, or float64 when x is (the row
    kernels' float64 reference runs)."""
    return x if x.dtype == torch.float64 else x.float()


def _pt_reduce(p: BAProblem, ell: EllIndex, Jpg, spg, red):
    """V = Σ w Jpᵀ Jp and bp = -Σ Jpᵀ (w r) of each point from its rows of
    (Jpg [Rp,Lw,2,3], spg [Rp,Lw,4]), frozen points zeroed."""
    Rp, Lw = ell.pt.slots.shape
    P = p.points.shape[0]
    A2 = _acc(Jpg * spg[..., 0][..., None, None]).reshape(Rp, Lw * 2, 3)
    B2 = _acc(Jpg).reshape(Rp, Lw * 2, 3)
    V_rows = A2.transpose(1, 2) @ B2
    bp_rows = -_mv(B2.transpose(1, 2), _acc(spg[..., 1:3]).reshape(Rp, -1))
    V = red(segment_sum(V_rows, ell.pt.seg, P))
    bp = red(segment_sum(bp_rows, ell.pt.seg, P))
    ptm = (~p.fix_pt).to(V.dtype)
    return V * ptm[:, None, None], bp * ptm[:, None]


def _build_pt_blocks_native(p: BAProblem, ell: EllIndex, huber_px,
                            reduce_fn=None, pt_dtype=torch.bfloat16):
    """Point blocks recomputed in the point-major layout (needs
    pack_camera_major's pt_uv / pt_w): per-slot camera parameters from the
    small [C, 15] table, the point row-uniform, pixels and weights from
    the static point-major copies, so no observation-sized array is
    gathered from the camera-major table.  Returns V [P,3,3], bp [P,3] and
    (Jpg [Rp,Lw,2,3], spg [Rp,Lw,4]) in pt_dtype, as _schur_solve_ell's
    pt_gathers wants them."""
    red = reduce_fn if reduce_fn is not None else _identity
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
    Jpg = Jp.to(pt_dtype)
    spg = torch.cat([w[..., None], r * w[..., None],
                     torch.zeros_like(w)[..., None]], dim=-1).to(pt_dtype)
    V, bp = _pt_reduce(p, ell, Jpg, spg, red)
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


def _schur_solve_ell(p: BAProblem, ell: EllIndex, U, V, bc, bp, Jc, Jp, w,
                     lam, cg_iters, cg_tol, reduce_fn=None,
                     compute_dtype=torch.bfloat16, pt_gathers=None,
                     cam_w=None):
    """ELL Schur solve: points marginalized in closed form, PCG on the
    reduced camera system, back-substitution.

    With L = chol(V⁻¹), Y_o = w_o Jc_oᵀ Jp_o L_p absorbs the point
    marginalization (G V⁻¹ Gᵀ = (G L)(G L)ᵀ).  Y = Jcᵀ Z with Z = w Jp L
    [.,2,3] is never built: Yᵀx = Zᵀ(Jc x), Y z = Jcᵀ(Z z), Σ Y Yᵀ =
    Jcᵀ (Z Zᵀ) Jc.  Modes, as in the JAX package:
      * pt_major (row-native Jc, pt_gathers and ell.pt_pos): Z lives only
        in point order (Zpt, from pt_gathers with L row-uniform), and the
        small per-slot results b = Z z [2] and Z Zᵀ [2,2] cross to the
        camera rows through pt_pos;
      * weighted (pt_major and cam_w = √w Jc from the normal-block build):
        every camera-side product uses cam_w with Z' = √w Jp L, and the
        gauge masks are applied per camera after each sum; Jc, Jp and w
        are then not read (may be None);
      * flat (Jc [O,2,D]): Z built in the flat table and gathered.
    With a 14-column Jc the tied-intrinsics space of _TiedSpace holds the
    PCG vectors.  Operands in compute_dtype, products accumulated in
    float32.  The PCG loop runs on the host (one scalar read an
    iteration) and carries Σ alpha ypt(p_k), so the back-substitution
    needs no further point sum.  Returns (dx_c [C,D], dx_p [P,3])."""
    with span("xrsfm.ba.schur"):
        C = p.cam_q.shape[0]
        P = p.points.shape[0]
        D = U.shape[-1]
        with_intri = D > 6
        red = reduce_fn if reduce_fn is not None else _identity
        eyeD = torch.eye(D, dtype=U.dtype, device=U.device)
        eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
        Ud = U + lam * (U * eyeD) + 1e-8 * eyeD
        Vd = V + lam * (V * eye3) + 1e-8 * eye3
        Vinv = _inv3x3(Vd)
        L = _chol3x3(Vinv)  # [P,3,3]

        cd = compute_dtype
        ptm = (~p.fix_pt).to(U.dtype)
        Rc, Mc = ell.cam.slots.shape
        Rp, Lw = ell.pt.slots.shape
        row_native = (Jc if Jc is not None else cam_w).dim() == 4
        pt_major = (row_native and pt_gathers is not None
                    and ell.pt_pos is not None)
        weighted = cam_w is not None and pt_major
        m_post = _cam_colmask(p, with_intri) if weighted else None  # [C,D]
        Z = Zpt = Jc_flat = None
        if row_native:
            if weighted:
                Jc16 = cam_w.to(cd)
            else:
                mg = _cam_colmask(p, with_intri).to(cd)[ell.cam.seg]
                Jc16 = Jc.to(cd) * mg[:, None, None, :]  # [Rc,Mc,2,D]
            if not pt_major:
                wm = (w * ptm[ell.cam.other]).to(cd)
                Z = (Jp.to(cd) @ L.to(cd)[ell.cam.other]) * wm[..., None, None]
        else:
            wm = (w * ptm[p.obs_pt]).to(cd)
            Z_flat = (Jp.to(cd) @ L.to(cd)[p.obs_pt]) * wm[:, None, None]
            mg = _cam_colmask(p, with_intri).to(cd)[p.obs_cam]  # [O,D]
            Jc_flat = Jc.to(cd) * mg[:, None, :]  # [O,2,D]
            # in the flat layout the slot tables index the ORIGINAL table
            Zpt = _gather_rows(Z_flat, ell.pt)  # [Rp,Lw,2,3]
            Jc16 = _gather_rows(Jc_flat, ell.cam)  # [Rc,Mc,2,D]
            Z = _gather_rows(Z_flat, ell.cam)  # [Rc,Mc,2,3]
        if Zpt is None:
            if pt_gathers is not None:
                # Zpt = Jp_pt L w from the point-order gathers: L and the
                # fix_pt mask are row-uniform in point order
                Jpg, spg = pt_gathers
                w_or_sw = spg[..., 0].float()
                if weighted:  # √w here when cam_w carries the other √w
                    w_or_sw = torch.sqrt(w_or_sw.clamp_min(0.0))
                wrow = (w_or_sw * ptm[ell.pt.seg][:, None]).to(cd)
                Zpt = (Jpg.to(cd) @ L.to(cd)[ell.pt.seg][:, None]) \
                    * wrow[..., None, None]
            else:
                Zpt = _gather_obs(Z.reshape(-1, 2, 3), ell.pt.slots)
        space = _TiedSpace(p.cam_kam, C) if with_intri else _PlainSpace()

        def ypt_reduce(x):
            """yp[p] = Σ_{o in p} Y_oᵀ x_cam(o) = Σ Z_oᵀ (Jc_o x)  -> [P,3]"""
            if row_native:
                a = _mv(Jc16.reshape(Rc, Mc * 2, D), x.to(cd)[ell.cam.seg])
                apt = _gather_obs(a.reshape(-1, 2), ell.pt.slots)
            else:
                a = _mv(Jc_flat, x.to(cd)[p.obs_cam])
                apt = _gather_rows(a, ell.pt)  # [Rp,Lw,2]
            yrow = _mv(Zpt.float().reshape(Rp, Lw * 2, 3).transpose(1, 2),
                       apt.float().reshape(Rp, Lw * 2))
            return red(segment_sum(yrow, ell.pt.seg, P))

        def cam_reduce(b):
            """Σ_{o in c} Jc_oᵀ b_o -> [C,D], masked per camera if weighted"""
            trow = _mv(Jc16.float().reshape(Rc, Mc * 2, D).transpose(1, 2),
                       b.float().reshape(Rc, Mc * 2))
            out = red(segment_sum(trow, ell.cam.seg, C))
            return out * m_post if weighted else out

        def ycam_reduce(zp):
            """t[c] = Σ_{o in c} Y_o z_pt(o) = Σ Jc_oᵀ (Z_o z)  -> [C,D]"""
            if pt_major:
                # z is row-uniform in point order; only the [2]-vector result
                # crosses the layouts
                b_pt = _mv(Zpt.reshape(Rp, Lw * 2, 3), zp[ell.pt.seg].to(cd))
                b = _gather_obs(b_pt.reshape(-1, 2), ell.pt_pos)
            else:
                b = _mv(Z, zp[ell.cam.other].to(cd))
            return cam_reduce(b)

        def S_matvec(x, ypx):
            return space.proj(_mv(Ud, x) - ycam_reduce(ypx))

        # rhs = bc - Σ_o Y_o (Lᵀ bp)_pt(o); the preconditioner needs the
        # per-slot 2x2 Gram of Z.  Point-major: both cross to the camera rows
        # in one 6-wide payload gather.
        u = _mv(L.transpose(1, 2), bp)  # Lᵀ bp [P,3]
        if pt_major:
            b_pt = _mv(Zpt.reshape(Rp, Lw * 2, 3), u[ell.pt.seg].to(cd)) \
                .reshape(Rp, Lw, 2)
            Gz_pt = Zpt.float() @ Zpt.float().transpose(-1, -2)  # [Rp,Lw,2,2]
            payload = torch.cat([b_pt.to(cd), Gz_pt.to(cd).reshape(Rp, Lw, 4)],
                                dim=-1)
            pay = _gather_obs(payload.reshape(-1, 6), ell.pt_pos)  # [Rc,Mc,6]
            Gz = pay[..., 2:].reshape(Rc, Mc, 2, 2)
            rhs = space.proj(bc - cam_reduce(pay[..., :2]))
        else:
            rhs = space.proj(bc - ycam_reduce(u))
            Gz = Z.float() @ Z.float().transpose(-1, -2)  # [Rc,Mc,2,2]
        Hz = (Gz.to(cd).float() @ Jc16.float()).to(cd)  # [Rc,Mc,2,D]
        S_rows = Jc16.float().reshape(Rc, Mc * 2, D).transpose(1, 2) \
            @ Hz.float().reshape(Rc, Mc * 2, D)  # [Rc,D,D]
        corr = red(segment_sum(S_rows, ell.cam.seg, C))
        if weighted:  # keep masked blocks exactly Ud's (SPD)
            corr = corr * (m_post[:, :, None] * m_post[:, None, :])
        Sdiag = Ud - corr + 1e-7 * eyeD

        def inverse(M):
            # batched LU, as _schur_solve inverts its Jacobi blocks (the JAX
            # package's closed-form _inv_spd avoids XLA's batched LU on a TPU,
            # and costs about 75 small launches a 6x6 batch here)
            n = M.shape[-1]
            return linalg.solve(M, eyeD[:n, :n].expand(M.shape[0], n, n))

        if with_intri:
            # a pose block per camera and an intrinsic block per block
            Minv_p = inverse(Sdiag[:, :6, :6])
            Minv_i = inverse(segment_sum(Sdiag[:, 6:, 6:], space.kam, C)
                             + 1e-7 * eyeD[:8, :8])

            def precond(x):
                xi = _mv(Minv_i, space.reduce(x))
                return torch.cat([_mv(Minv_p, x[:, :6]), xi[space.kam]], dim=1)
        else:
            Minv = inverse(Sdiag)

            def precond(x):
                return _mv(Minv, x)

    with span("xrsfm.ba.pcg"):
        dot = space.dot
        x = torch.zeros_like(rhs)
        r_ = rhs
        z_ = precond(r_)
        pk = z_
        rz = dot(r_, z_)
        bnorm = torch.sqrt(dot(rhs, rhs)) + 1e-30
        ypx = rhs.new_zeros((P, 3))
        for _ in range(cg_iters):
            if not bool(torch.sqrt(dot(r_, r_)) > cg_tol * bnorm):
                break
            COUNTS["cg_iters"] += 1
            # the matvec's point sum is ypt(pk); ypt(x) = Σ alpha_k ypt(p_k)
            # by linearity (x starts at 0), for the back-substitution
            ypp = ypt_reduce(pk)
            Ap = S_matvec(pk, ypp)
            denom = dot(pk, Ap)
            alpha = rz / torch.where(denom.abs() < 1e-30, 1e-30, denom)
            x = x + alpha * pk
            ypx = ypx + alpha * ypp
            r_ = r_ - alpha * Ap
            z_ = precond(r_)
            rz_new = dot(r_, z_)
            beta = rz_new / torch.where(rz.abs() < 1e-30, 1e-30, rz)
            pk = z_ + beta * pk
            rz = rz_new
        # dp = V⁻¹ bp - L Σ_{o in p} Y_oᵀ dx_cam(o)
        return x, _mv(Vinv, bp) - _mv(L, ypx)


# ---------------------------------------------------------------------------
# The row kernels (csrc/ba_cam_rows.cu, csrc/ba_pt_rows.cu)
# ---------------------------------------------------------------------------


def cam_rows_plain(p: BAProblem, ell: EllIndex, huber_px,
                   with_intri: bool = False):
    """Plain version of the camera-row kernel, float32:
    _residuals_and_jacobians_rows, _robust_cost_and_weight and
    _build_normal_blocks_ell(cam_only, return_cam_w).  Returns (robust cost
    of the table, U [C,D,D] and bc [C,D] gauge-masked, Jcw [Rc,Mc,2,D])."""
    r, z, Jc, Jp = _residuals_and_jacobians_rows(p, ell, with_intri)
    cost, w = _robust_cost_and_weight(
        r, z, p.obs_w.reshape(ell.cam.slots.shape), huber_px)
    U, bc, Jcw = _build_normal_blocks_ell(
        p, ell, r, Jc, Jp, w, pt_dtype=torch.float32, cam_only=True,
        return_cam_w=True)
    return cost, U, bc, Jcw


def pt_rows_plain(p: BAProblem, ell: EllIndex, huber_px):
    """Plain version of the point-row kernel: _build_pt_blocks_native in
    float32.  Returns (V [P,3,3], bp [P,3], (Jpg [Rp,Lw,2,3], spg
    [Rp,Lw,4]))."""
    return _build_pt_blocks_native(p, ell, huber_px, pt_dtype=torch.float32)


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
    if not (ell.cam.contig and 1 <= Mc <= 128 and C >= 1):
        raise ValueError(f"cam_rows: needs camera-major rows of 1..128 "
                         f"slots and a camera, got {Rc}x{Mc}, C={C}")
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
    camera-major packed problem (pt_uv / pt_w present) on a CUDA device,
    whose ids the kernel trusts.  Point rows 8, 16 or 32 slots wide (the
    widths pack_camera_major gives).  Builds the kernel on first use;
    raises on a bad input, a failed build or a refused launch."""
    dev = p.cam_q.device
    C, P = p.cam_q.shape[0], p.points.shape[0]
    Rp, Lw = ell.pt.slots.shape
    if ell.pt_uv is None or Lw not in (8, 16, 32) or P < 1:
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

    ell: None runs the COO solver; an EllIndex of p runs the ELL solver,
    through the camera rows when p was packed by pack_camera_major (the
    row kernels on a GPU), through gathers for build_ell's flat tables."""
    if opts.optimize_intrinsics and (p.cam_kam is None
                                     or p.fix_intri is None):
        raise ValueError("optimize_intrinsics requires cam_kam and "
                         "fix_intri on the problem")
    dev = "cuda" if p.cam_q.is_cuda else "cpu"
    COUNTS[f"solves_{dev}"] += 1
    if opts.optimize_intrinsics:
        COUNTS[f"intri_solves_{dev}"] += 1
    if ell is not None and ell.cam.contig:
        COUNTS[f"row_solves_{dev}"] += 1
    with span("xrsfm.ba.solve"), full_precision():
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
    row_native = ell.cam.contig
    with_intri = opts.optimize_intrinsics
    f32 = torch.float32

    def cost_of(prob):
        if row_native:
            r, z = _residuals_only_rows(prob, ell)
            w0 = prob.obs_w.reshape(ell.cam.slots.shape)
        else:
            r, z = _residuals_only(prob)
            w0 = prob.obs_w
        return _robust_cost_and_weight(r, z, w0, opts.huber_px)[0]

    def step(prob, lam):
        Jc = Jp = w = camw = None
        with span("xrsfm.ba.rows"):
            if row_native:
                # the camera side from the camera rows, the point side
                # recomputed in point order; √w Jc shared with the Schur
                # solve
                _, U, bc, camw = cam_rows(prob, ell, opts.huber_px,
                                          with_intri)
                V, bp, ptg = pt_rows(prob, ell, opts.huber_px)
            else:
                r, z, Jc, Jp = _residuals_and_jacobians(prob, with_intri)
                _, w = _robust_cost_and_weight(r, z, prob.obs_w,
                                               opts.huber_px)
                U, V, bc, bp, ptg = _build_normal_blocks_ell(
                    prob, ell, r, Jc, Jp, w, return_pt_gathers=True,
                    pt_dtype=f32)
        return _schur_solve_ell(prob, ell, U, V, bc, bp, Jc, Jp, w, lam,
                                opts.cg_iters, opts.cg_tol,
                                compute_dtype=f32, pt_gathers=ptg,
                                cam_w=camw)

    return _lm(p, opts, cost_of, step)


def _lm(p: BAProblem, opts: BAOptions, cost_of, step):
    """The LM loop: step(problem, lambda) -> (dx_c, dx_p), accepted when
    cost_of the candidate is lower.  Each iteration is a span
    xrsfm.ba.lm_step: the step's spans (rows, schur, pcg), then
    xrsfm.ba.cost around the candidate's cost, the accept and the stop
    test's read."""
    with span("xrsfm.ba.cost"):
        c0 = cost_of(p)
    cost = c0
    lam = torch.tensor(opts.lam_init, dtype=p.cam_q.dtype,
                       device=p.cam_q.device)
    it = 0
    done = False
    while it < opts.max_iters and not done:
        with span("xrsfm.ba.lm_step"):
            COUNTS["lm_iters"] += 1
            dx_c, dx_p = step(p, lam)
            with span("xrsfm.ba.cost"):
                cand = _apply_step(p, dx_c, dx_p)
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
    info = dict(initial_cost=float(c0), final_cost=float(cost), iters=it,
                lam=float(lam))
    return p, info
