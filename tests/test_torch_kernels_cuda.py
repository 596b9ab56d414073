"""The port's CUDA matcher kernel (u8 wgmma dots fed by TMA) against its
plain PyTorch version, and
the port's solvers (bundle adjustment with and without intrinsics, the
scale pose graph, rotation and translation averaging), VLAD retrieval, ORB
extraction, Hamming matching and the tags' joint scale refinement on the
card against the same work on the CPU, and the float32 inverse of the
intrinsics solve's 8x8 Jacobi blocks against float64; several shards
(parallel/): the kernel on a second card where there is one, sharded
matching bit-equal to one device, and a one-rank NCCL group's BA checksum
equal to one process's.

The bundle adjuster's row kernels (csrc/ba_cam_rows.cu,
csrc/ba_pt_rows.cu) against their plain versions, D = 6 and 14, and the
row-native solve on the card against the CPU.

Needs a CUDA device and nvcc; skips elsewhere.  On a machine with a GPU
(and no JAX, which the repo's conftest imports), run:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from xrsfm_tpu_torch.ops import matching as TM
from xrsfm_tpu_torch.utils import synth
from xrsfm_tpu_torch.utils.synth import descriptor_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, seed, B, N, M):
    return [torch.from_numpy(a).to(dev)
            for a in descriptor_case(seed, B, N, M)]


@pytest.mark.parametrize("B,N,M", [
    (2, 256, 256),     # the CPU tests' size
    (3, 200, 184),     # ragged: neither side a multiple of the tile
    (1, 1, 1),
    (2, 65, 4097),
    (16, 2048, 2048),  # the 48-image arc run's chunk
    (1, 64, 64),       # one tile, half of it past the end, on both sides
    (2, 129, 8192),    # 64 streamed tiles: the ring wraps 16 times
    (5, 8192, 128),    # one streamed tile in the row pass, 64 in the other
])
def test_topstats_kernel_bit_equal_to_plain(cuda_device, B, N, M):
    """All four outputs bit-equal (tolerance 0): both compute exact integer
    dots and the same f32 sentinel adds and tie rules."""
    args = _case(cuda_device, 7 + N, B, N, M)
    got = TM.topstats_cuda(*args)
    torch.cuda.synchronize()
    exp = TM.topstats_reference(*args)
    for g, e, name in zip(got, exp, ("best", "second", "best_j", "col_arg")):
        g, e = g.cpu().numpy(), e.cpu().numpy()
        assert g.dtype == e.dtype, name
        assert np.array_equal(g.view(np.uint32), e.view(np.uint32)), name


def test_topstats_kernel_on_planted_ties(cuda_device):
    """The ties of `synth.descriptor_tie_case` (across tiles, across the
    lanes of a quad, within a lane, an all-masked pair on either side)
    reach the kernel's own reduction: bit-equal, and the ties are there."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in synth.descriptor_tie_case()]
    got = TM.topstats_cuda(*args)
    torch.cuda.synchronize()
    exp = TM.topstats_reference(*args)
    for g, e, name in zip(got, exp, ("best", "second", "best_j", "col_arg")):
        assert torch.equal(g.view(torch.int32), e.view(torch.int32)), name
    assert (exp[0] == exp[1]).sum() >= 6


def test_topstats_kernel_on_slices_of_a_pool(cuda_device):
    """Inputs that are contiguous views into larger tensors at a non-zero
    storage offset (pairs 3..4 of a pool of 8): the tensor maps are made
    per call from the views' own pointers."""
    pool = _case(cuda_device, 11, 8, 384, 320)
    args = [t[3:5] for t in pool]
    assert all(t.storage_offset() > 0 and t.is_contiguous() for t in args)
    got = TM.topstats_cuda(*args)
    torch.cuda.synchronize()
    exp = TM.topstats_reference(*[t.clone() for t in args])
    for g, e, name in zip(got, exp, ("best", "second", "best_j", "col_arg")):
        assert torch.equal(g.view(torch.int32), e.view(torch.int32)), name
    # the neighbouring pairs of the pool must not leak into the result
    far = [t.clone() for t in pool]
    far[0][2], far[0][5], far[1][2], far[1][5] = 255, 255, 255, 255
    again = TM.topstats_cuda(*[t[3:5] for t in far])
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_topstats_dispatch_counts_kernel_launches(cuda_device):
    args = _case(cuda_device, 3, 2, 128, 128)
    before = dict(TM.LAUNCHES)
    TM.topstats(*args)
    assert TM.LAUNCHES["topstats_cuda"] == before["topstats_cuda"] + 1
    assert TM.LAUNCHES["topstats_plain"] == before["topstats_plain"]


def test_topstats_kernel_rejects_bad_inputs(cuda_device):
    d1, d2, m1, m2 = _case(cuda_device, 1, 2, 128, 128)
    with pytest.raises(ValueError):
        TM.topstats_cuda(d1[..., :64].contiguous(), d2[..., :64].contiguous(),
                         m1, m2)
    with pytest.raises(ValueError):
        TM.topstats_cuda(d1.transpose(0, 1), d2, m1, m2)
    with pytest.raises(TypeError):
        TM.topstats_cuda(d1.float(), d2, m1, m2)
    with pytest.raises(ValueError):
        TM.topstats_cuda(d1.cpu(), d2, m1, m2)


def _dlt_normals(n, seed):
    """A^T A of two-view DLT rows (float32) of a forward-moving pair with
    small parallax and 0.5 px noise at f = 700."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, 3))
    X[:, 2] += 15
    c2 = np.array([0.05, 0.0, 0.5])
    uv1 = X[:, :2] / X[:, 2:] + rng.normal(scale=0.5 / 700, size=(n, 2))
    Xc = X - c2
    uv2 = Xc[:, :2] / Xc[:, 2:] + rng.normal(scale=0.5 / 700, size=(n, 2))
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([np.eye(3), -c2[:, None]])
    A = np.stack([uv1[:, :1] * P1[2] - P1[0], uv1[:, 1:] * P1[2] - P1[1],
                  uv2[:, :1] * P2[2] - P2[0], uv2[:, 1:] * P2[2] - P2[1]],
                 axis=1).astype(np.float32)
    return np.einsum("nmi,nmj->nij", A, A)


def test_decompositions_on_cuda_as_accurate_as_float64(cuda_device):
    """ops/linalg on the card against float64 LAPACK on the same float32
    inputs: DLT depths from 4x4 eigh within 1e-5 relative (median 1e-6;
    cuSOLVER in float32 misses by about 1e-4) and 3x3 SVDs reconstructing
    within 5e-7 (float32 LAPACK: 2.6e-6), both returned in float32; the
    float32 LU solves, which stay float32, no further from float64 than
    the CPU's (6x6 SPD and 10x10 general, 99th percentile within 1.5x)."""
    from xrsfm_tpu_torch.ops import linalg

    AtA = _dlt_normals(20000, 0)
    _, v64 = np.linalg.eigh(AtA.astype(np.float64))
    vals, vecs = linalg.eigh(torch.from_numpy(AtA).to(cuda_device))
    assert vecs.dtype == torch.float32 and vals.dtype == torch.float32
    h = vecs[..., 0].double().cpu().numpy()
    z, z64 = h[:, 2] / h[:, 3], v64[:, 2, 0] / v64[:, 3, 0]
    rel = np.abs(z - z64) / np.abs(z64)
    assert np.median(rel) < 1e-6 and np.quantile(rel, 0.99) < 1e-5

    rng = np.random.default_rng(1)
    E = rng.normal(size=(5000, 3, 3)).astype(np.float32)
    out = linalg.svd(torch.from_numpy(E).to(cuda_device))
    assert all(a.dtype == torch.float32 for a in out)
    U, S, Vh = (a.double().cpu().numpy() for a in out)
    rec = np.abs(U @ (S[:, :, None] * Vh) - E).max(axis=(1, 2))
    assert rec.max() < 5e-7 * np.abs(E).max()

    for n in (6, 10):
        M = rng.normal(size=(4000, n, n))
        if n == 6:
            M = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(6)
        M = M.astype(np.float32)
        b = rng.normal(size=(4000, n, 1)).astype(np.float32)
        x64 = np.linalg.solve(M.astype(np.float64), b.astype(np.float64))
        scale = np.abs(x64).max(axis=1, keepdims=True)
        err = {}
        for dev in ("cpu", cuda_device):
            x = linalg.solve(torch.from_numpy(M).to(dev),
                             torch.from_numpy(b).to(dev)).cpu().numpy()
            err[str(dev)] = np.quantile(
                (np.abs(x - x64) / scale).max(axis=(1, 2)), 0.99)
        assert err[str(cuda_device)] <= 1.5 * err["cpu"]


def test_segment_sum_on_cuda_repeats_bit_for_bit(cuda_device):
    """optim/ba.segment_sum on the card: five runs over 140k rows of 6x6
    blocks into 200 segments give the same bits, within 1e-3 of the CPU's
    float64 sums."""
    from xrsfm_tpu_torch.optim import ba

    g = torch.Generator().manual_seed(0)
    x = torch.randn(140000, 6, 6, generator=g)
    idx = torch.randint(0, 200, (140000,), generator=g)
    want = ba.segment_sum(x.double(), idx, 200)
    xc, ic = x.to(cuda_device), idx.to(cuda_device)
    runs = [ba.segment_sum(xc, ic, 200) for _ in range(5)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    np.testing.assert_allclose(runs[0].cpu().double().numpy(), want.numpy(),
                               atol=1e-3)


def test_solve_ba_on_cuda_matches_cpu(cuda_device):
    """The port's BA (plain PyTorch ops; no hand kernel yet) on the card
    against the same solve on the CPU, 20 cameras and 500 points, bench
    settings: final cost, poses and points within rtol 1e-4 (the card sums
    segments in another order than the CPU)."""
    from xrsfm_tpu_torch.optim import ba

    d = synth.ba_problem(n_cams=20, n_pts=500, seed=0)
    opts = ba.BAOptions(max_iters=10, cg_iters=2, huber_px=4.0,
                        lam_init=1e-4)
    cpu, i_cpu = ba.solve_ba(ba.BAProblem.from_numpy("cpu", **d), opts)
    ba.reset_counts()
    gpu, i_gpu = ba.solve_ba(ba.BAProblem.from_numpy(cuda_device, **d), opts)
    assert ba.COUNTS["solves_cuda"] == 1 and ba.COUNTS["solves_cpu"] == 0
    assert i_gpu["final_cost"] == pytest.approx(i_cpu["final_cost"], rel=1e-4)
    for g, c in ((gpu.cam_q, cpu.cam_q), (gpu.cam_t, cpu.cam_t),
                 (gpu.points, cpu.points)):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _row_rel_err(got, exp, rows):
    """Largest |got - exp| of a row (a block or a slot) over the row's
    largest |exp|; all-zero rows must match exactly."""
    g = got.double().reshape(-1, rows).cpu()
    e = exp.double().reshape(-1, rows).cpu()
    diff = (g - e).abs().amax(dim=1)
    norm = e.abs().amax(dim=1)
    assert not bool((diff[norm == 0] > 0).any())
    return float((diff / norm.clamp_min(1e-300)).max())


def _row_problem(dev, size, with_intri):
    from xrsfm_tpu_torch.optim import ba
    from xrsfm_tpu_torch.utils import camera as Cam

    d = synth.ba_problem(**({"n_cams": 20, "n_pts": 500} if size == "small"
                            else {"n_cams": 200, "n_pts": 20000}), seed=0)
    d["cam_intri"][:, 4:] = [-0.05, 0.01, 1e-3, -5e-4]
    if with_intri:
        n = len(d["cam_q"])
        free, _ = Cam.intri_free_mask(Cam.PINHOLE)
        d.update(cam_kam=np.arange(n) // 2,
                 fix_intri=np.tile(~free[None], (n, 1)),
                 tie_f=np.arange(n) % 2 == 0)
    return ba.pack_camera_major(ba.BAProblem.from_numpy(dev, **d))


def _rows_f64(p, ell, with_intri):
    """The row kernels' plain compositions on float64 copies of the
    inputs: {output: tensor}."""
    from xrsfm_tpu_torch.optim import ba

    def f64(x):
        return dataclasses.replace(x, **{
            f.name: getattr(x, f.name).double()
            for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name))
            and getattr(x, f.name).is_floating_point()})

    p, ell = f64(p), f64(ell)
    r, z, Jc, _ = ba._residuals_and_jacobians_rows(p, ell, with_intri)
    cost, w = ba._robust_cost_and_weight(
        r, z, p.obs_w.reshape(ell.cam.slots.shape), 4.0)
    U, bc, Jcw = ba._build_normal_blocks_ell(p, ell, r, Jc, w)
    V, bp, (Jpg, spg) = ba._build_pt_blocks_native(p, ell, 4.0)
    return dict(cost=cost, U=U, bc=bc, Jcw=Jcw, V=V, bp=bp, Jpg=Jpg,
                spg=spg)


# chip_smoke.py phase 21's limits (float32 sums in other orders and fused
# multiply-adds; bc, bp and spg are linear in the residual pix - uv, whose
# float32 rounding differs), relative to a block's or slot's largest entry
ROW_TOLS = dict(U=1e-4, V=1e-4, Jcw=5e-5, Jpg=1e-5, bc=2e-4, bp=1e-2,
                spg=2.5e-4)


@pytest.mark.parametrize("with_intri", [False, True], ids=["D6", "D14"])
@pytest.mark.parametrize("size", ["small", "bench"])
def test_ba_row_kernels_match_plain(cuda_device, size, with_intri):
    """csrc/ba_cam_rows.cu and csrc/ba_pt_rows.cu against their plain
    versions at 20 cameras / 500 points and at bench.py's 139,265
    observations, D = 6 and 14, with distortion, at chip_smoke.py phase
    21's limits (ROW_TOLS, the cost within 1e-6); against the plain
    composition in float64 the kernel's error is at most twice the float32
    plain version's; a second launch gives U, bc, V and bp bit for bit (no
    atomics)."""
    from xrsfm_tpu_torch.optim import ba

    D = 14 if with_intri else 6
    p, ell = _row_problem(cuda_device, size, with_intri)
    width = dict(U=D * D, bc=D, Jcw=2 * D, V=9, bp=3, Jpg=6, spg=4)
    got = ba.cam_rows_cuda(p, ell, 4.0, with_intri)
    again = ba.cam_rows_cuda(p, ell, 4.0, with_intri)
    torch.cuda.synchronize()
    cost, U, bc, Jcw = got
    cost_e, U_e, bc_e, Jcw_e = ba.cam_rows_plain(p, ell, 4.0, with_intri)
    assert Jcw.shape == Jcw_e.shape == ell.cam.slots.shape + (2, D)
    assert abs(float(cost) - float(cost_e)) <= 1e-6 * float(cost_e)
    assert torch.equal(U, again[1]) and torch.equal(bc, again[2])
    V, bp, (Jpg, spg) = ba.pt_rows_cuda(p, ell, 4.0)
    V2, bp2, _ = ba.pt_rows_cuda(p, ell, 4.0)
    torch.cuda.synchronize()
    V_e, bp_e, (Jpg_e, spg_e) = ba.pt_rows_plain(p, ell, 4.0)
    assert torch.equal(V, V2) and torch.equal(bp, bp2)
    kern = dict(U=U, bc=bc, Jcw=Jcw, V=V, bp=bp, Jpg=Jpg, spg=spg)
    plain = dict(U=U_e, bc=bc_e, Jcw=Jcw_e, V=V_e, bp=bp_e, Jpg=Jpg_e,
                 spg=spg_e)
    ref = _rows_f64(p, ell, with_intri)
    for k, tol in ROW_TOLS.items():
        assert _row_rel_err(kern[k], plain[k], width[k]) <= tol, k
        assert (_row_rel_err(kern[k], ref[k], width[k])
                <= 2 * _row_rel_err(plain[k], ref[k], width[k])), k


def _width_problem(Mc, Lw, with_intri, seed):
    """numpy problem fields whose pack_camera_major rows are Mc (camera)
    and Lw (point) slots wide, with random subsets of fix_cam, fix_trans,
    fix_rot, fix_pt (and, with intrinsics, fix_intri and tie_f), a last
    camera and a last point without observations (a padding-only row
    each), at Mc = 128 a first camera of 41 rows and at Lw = 32 a point of
    several rows.  Cameras look down +z from (0, 0, 0.1 c); points lie 5
    to 40 beyond the last; as in bench.py's problem the pixels carry 0.5
    px of noise and the points then move by 0.05; OPENCV distortion
    set."""
    rng = np.random.default_rng(seed)
    C = 13  # the last one unobserved
    if Mc == 128:
        cam_n = rng.integers(1, 129, C - 1)
        cam_n[0] = 40 * 128 + 7
    else:
        cam_n = rng.integers(1, Mc + 1, C - 1)
        cam_n[1] = Mc
    O = int(cam_n.sum())
    pt_n = []
    while sum(pt_n) < O:
        pt_n.append(int(rng.integers(1, Lw + 1)))
    pt_n[0] = 2 * 32 + 5 if Lw == 32 else Lw
    pt_n = np.asarray(pt_n)
    excess = int(pt_n.sum()) - O
    while excess > 0:  # trim from the end, every point keeping one
        i = len(pt_n) - 1
        take = min(excess, int(pt_n[i]) - 1)
        pt_n[i] -= take
        excess -= take
        if pt_n[i] == 1 and excess:
            pt_n, excess = pt_n[:-1], excess - 1
    P = len(pt_n) + 1  # the last one unobserved
    obs_cam = np.repeat(np.arange(C - 1), cam_n)
    obs_pt = rng.permutation(np.repeat(np.arange(P - 1), pt_n))
    f, cx, cy = 718.0, 607.0, 185.0
    centers = np.zeros((C, 3))
    centers[:, 2] = 0.1 * np.arange(C)
    xyz = np.concatenate([rng.uniform(-4.0, 4.0, (P, 2)),
                          rng.uniform(6.0, 41.0, (P, 1))], 1)
    pc = xyz[obs_pt] - centers[obs_cam]
    uv = pc[:, :2] / pc[:, 2:3] * f + np.array([cx, cy])
    uv += rng.normal(scale=0.5, size=uv.shape)
    xyz += rng.normal(scale=0.05, size=xyz.shape)
    q = np.zeros((C, 4), np.float32)
    q[:, 0] = 1.0
    intri = np.tile(np.array([f, f, cx, cy, -0.05, 0.01, 1e-3, -5e-4],
                             np.float32), (C, 1))
    d = dict(cam_q=q, cam_t=(-centers).astype(np.float32), cam_intri=intri,
             points=xyz.astype(np.float32), obs_uv=uv.astype(np.float32),
             obs_cam=obs_cam, obs_pt=obs_pt,
             obs_w=np.ones(O, np.float32),
             fix_cam=rng.random(C) < 0.2, fix_trans=rng.random(C) < 0.2,
             fix_rot=rng.random(C) < 0.2, fix_pt=rng.random(P) < 0.2)
    if with_intri:
        d.update(cam_kam=np.arange(C) // 2,
                 fix_intri=rng.random((C, 8)) < 0.3,
                 tie_f=rng.random(C) < 0.5)
    return d


def _check_rows(dev, p, ell, with_intri):
    """Both row kernels within ROW_TOLS of the float64 run of the plain
    composition (the cost within 1e-6), and against it at most twice the
    float32 plain version's error (on these sub-pixel problems the plain
    version's own bc and cost error can pass ROW_TOLS, so float64 is the
    reference), and a second launch bit-equal.  Returns the kernels'
    outputs."""
    from xrsfm_tpu_torch.optim import ba

    D = 14 if with_intri else 6
    width = dict(U=D * D, bc=D, Jcw=2 * D, V=9, bp=3, Jpg=6, spg=4)
    cost, U, bc, Jcw = ba.cam_rows_cuda(p, ell, 4.0, with_intri)
    V, bp, (Jpg, spg) = ba.pt_rows_cuda(p, ell, 4.0)
    again = ba.cam_rows_cuda(p, ell, 4.0, with_intri)
    V2, bp2, _ = ba.pt_rows_cuda(p, ell, 4.0)
    torch.cuda.synchronize()
    assert torch.equal(cost, again[0]) and torch.equal(U, again[1])
    assert torch.equal(bc, again[2]) and torch.equal(Jcw, again[3])
    assert torch.equal(V, V2) and torch.equal(bp, bp2)
    cost_e, U_e, bc_e, Jcw_e = ba.cam_rows_plain(p, ell, 4.0, with_intri)
    V_e, bp_e, (Jpg_e, spg_e) = ba.pt_rows_plain(p, ell, 4.0)
    assert Jcw.shape == Jcw_e.shape == ell.cam.slots.shape + (2, D)
    ref = _rows_f64(p, ell, with_intri)
    assert abs(float(cost) - float(ref["cost"])) <= 1e-6 * float(ref["cost"])
    kern = dict(U=U, bc=bc, Jcw=Jcw, V=V, bp=bp, Jpg=Jpg, spg=spg)
    plain = dict(U=U_e, bc=bc_e, Jcw=Jcw_e, V=V_e, bp=bp_e, Jpg=Jpg_e,
                 spg=spg_e)
    for k, tol in ROW_TOLS.items():
        err = _row_rel_err(kern[k], ref[k], width[k])
        assert err <= tol, k
        assert err <= 2 * _row_rel_err(plain[k], ref[k], width[k]), k
    return kern


def _plane_problem(dev):
    """Three cameras with k1 = -0.05, k2 = 0.01: camera 0 at the origin,
    cameras 1 and 2 300 m along x and 20 m back, all looking along z; 12
    points 20 m in front of cameras 1 and 2, seen by both (point rows of 8
    slots, 6 of them padding against camera 0).  Point 10 lies 0.05 m in
    front of camera 0's plane, 300 m to its side; point 11 0.5 mm in front,
    seen by camera 0 too (camera 0's one observation, a slot the guard
    holds).  In both, the slots
    against camera 0 weigh 0 and their Jacobian entries' products overflow
    float."""
    from xrsfm_tpu_torch.optim import ba

    C, P = 3, 12
    rng = np.random.default_rng(5)
    centers = np.array([[0.0, 0, 0], [300, 0, -20], [301, 0, -20]])
    X = np.stack([300.5 + rng.uniform(-3, 3, P), rng.uniform(-3, 3, P),
                  rng.uniform(-1, 1, P)], axis=1)
    X[10] = [300.5, 0.5, 0.05]
    X[11] = [300.5, 1.0, 5e-4]
    obs_cam = np.concatenate([np.repeat([1, 2], P), [0]])
    obs_pt = np.concatenate([np.tile(np.arange(P), 2), [11]])
    f, k1, k2 = 500.0, -0.05, 0.01
    pc = X[obs_pt] - centers[obs_cam]
    u = pc[:, :2] / pc[:, 2:]
    r2 = (u * u).sum(1, keepdims=True)
    uv = f * u * (1 + k1 * r2 + k2 * r2 * r2) + rng.normal(0, 0.5, u.shape)
    d = dict(cam_q=np.tile([1.0, 0, 0, 0], (C, 1)), cam_t=-centers,
             cam_intri=np.tile([f, f, 0, 0, k1, k2, 0, 0], (C, 1)),
             points=X, obs_uv=uv, obs_cam=obs_cam, obs_pt=obs_pt,
             obs_w=np.ones(len(obs_cam)), fix_cam=np.arange(C) == 0,
             fix_trans=np.arange(C) == 1, fix_pt=np.zeros(P, bool),
             cam_kam=np.arange(C), fix_intri=np.tile(
                 [False, False, True, True, False, False, True, True], (C, 1)),
             tie_f=np.ones(C, bool))
    return ba.pack_camera_major(ba.BAProblem.from_numpy(dev, **d))


def test_ba_pt_rows_zero_weight_slots_add_nothing(cuda_device):
    """ba_pt_rows on _plane_problem, where the projection Jacobian of point
    10 in camera 0 squares past float: V and bp finite, Jpg and spg zero
    on every slot of weight 0, all four within ROW_TOLS of the plain
    version's, and V and bp bit for bit from run to run."""
    from xrsfm_tpu_torch.optim import ba
    from xrsfm_tpu_torch.utils import camera as Cam
    from xrsfm_tpu_torch.utils import geometry as G

    p, ell = _plane_problem(cuda_device)
    assert ell.pt.slots.shape[1] == 8
    pc = G.quat_to_rotmat(p.cam_q[0]) @ p.points[10] + p.cam_t[0]
    proj = pc[:2] / pc[2]
    A = p.cam_intri[0, :2, None] * Cam.distort_jacobian(p.cam_intri[0], proj)
    B = ba._proj_jacobian(A, pc, 1.0 / pc[2])
    assert float(B.abs().amax()) ** 2 > torch.finfo(torch.float32).max
    V, bp, (Jpg, spg) = ba.pt_rows_cuda(p, ell, 4.0)
    V2, bp2, _ = ba.pt_rows_cuda(p, ell, 4.0)
    V_e, bp_e, (Jpg_e, spg_e) = ba.pt_rows_plain(p, ell, 4.0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(V).all() and torch.isfinite(bp).all())
    dead = spg[..., 0] == 0
    assert bool(dead.any()) and not Jpg[dead].any() and not spg[dead].any()
    assert torch.equal(V, V2) and torch.equal(bp, bp2)
    for got, want, width, tol in ((V, V_e, 9, "V"), (bp, bp_e, 3, "bp"),
                                  (Jpg, Jpg_e, 6, "Jpg"),
                                  (spg, spg_e, 4, "spg")):
        assert _row_rel_err(got, want, width) <= ROW_TOLS[tol], tol


def test_ba_pt_rows_on_the_stalled_cut_every_lm_step(cuda_device,
                                                      monkeypatch):
    """tests/test_torch_ba_stall.py's cut problem (cameras 105-124 of seed
    1000004's BAL-shaped problem) solved on the card with intrinsics free:
    at every LM step ba_pt_rows' V, bp and Jpg are finite, V and Jpg
    within ROW_TOLS of pt_rows_plain on the same state, and bp, which
    cancels across a point's slots, no further from the float64 plain
    composition than twice the float32 plain version (the kernel forms
    the residual in double precision; test_ba_row_kernels_match_plain's
    rule); the solve accepts at least 18 of its 20 steps."""
    from perfbench.gen import bal
    from test_torch_ba_stall import CAMS, OPTS, _config, cut_problem
    from xrsfm_tpu_torch.optim import ba

    arr = cut_problem(bal.make_problem(_config(), 1000004)["start"], *CAMS)
    p, ell = ba.pack_camera_major(ba.BAProblem.from_numpy(cuda_device, **arr))
    kernel = ba.pt_rows
    errs = []

    def f64(x):
        return dataclasses.replace(x, **{
            f.name: getattr(x, f.name).double()
            for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name))
            and getattr(x, f.name).is_floating_point()})

    def checked(prob, e, huber):
        V, bp, (Jpg, spg) = kernel(prob, e, huber)
        V_e, bp_e, (Jpg_e, _) = ba.pt_rows_plain(prob, e, huber)
        _, bp_64, _ = ba._build_pt_blocks_native(f64(prob), f64(e), huber)
        assert all(bool(torch.isfinite(x).all()) for x in (V, bp, Jpg))
        errs.append((_row_rel_err(V, V_e, 9), _row_rel_err(Jpg, Jpg_e, 6),
                     _row_rel_err(bp, bp_64, 3), _row_rel_err(bp_e, bp_64, 3)))
        return V, bp, (Jpg, spg)

    monkeypatch.setattr(ba, "pt_rows", checked)
    _, info = ba.solve_ba(p, ba.BAOptions(**OPTS), ell)
    assert len(errs) == info["iters"] == 20 and info["accepts"] >= 18
    for v, j, b, b_plain in errs:
        assert v <= ROW_TOLS["V"] and j <= ROW_TOLS["Jpg"]
        assert b <= ROW_TOLS["bp"] or b <= 2 * b_plain


# LBA problem 0 of perfbench's bal-dubrovnik356.lba cell for seed
# 3100000015 (D = 6, 5 LM steps), solved on an "NVIDIA H100 80GB HBM3"
# (torch 2.11.0+cu128) by the solver before ba_pt_rows skipped weight-0
# slots and before the accepted-step count: final cost, PCG iterations, and
# the first 16 hex digits of sha1(cam_q, cam_t, points bytes).
LBA_RECORDED = (132530.328125, 39, "dcdcd22eb831863f")


def test_pose_only_solve_bit_equal_to_recorded(cuda_device):
    """A D = 6 solve on a fixed problem gives the recorded cost, PCG count
    and state, bit for bit: the changes for the intrinsics solve leave the
    pose-only solve's bits alone (on a problem whose point rows hold no
    overflowing weight-0 slot)."""
    import hashlib

    from perfbench.gen import bal
    from test_torch_ba_stall import _config
    from xrsfm_tpu_torch.optim import ba

    cfg = _config()
    prob = bal.make_problem(cfg, 3100000015)
    start = dict(prob["start"], cam_intri=prob["truth"]["cam_intri"])
    c = bal.local_centers(cfg["n_cameras"], 32, 3100000015)[0]
    arr = bal.local_problem(start, bal.covisibility(start), int(c), 5)
    p, ell = ba.pack_camera_major(ba.BAProblem.from_numpy("cpu", **arr),
                                  device=cuda_device)
    cg0 = ba.COUNTS["cg_iters"]
    sol, info = ba.solve_ba(p, ba.BAOptions(max_iters=5, huber_px=4.0,
                                            cg_iters=15, cg_tol=0.01), ell)
    h = hashlib.sha1(b"".join(getattr(sol, k).cpu().numpy().tobytes()
                              for k in ("cam_q", "cam_t", "points")))
    assert (info["final_cost"], ba.COUNTS["cg_iters"] - cg0,
            h.hexdigest()[:16]) == LBA_RECORDED


def test_ba_row_wrappers_device_operations(cuda_device):
    """One call of cam_rows_cuda makes at most 2 device operations (its two
    launches: no mask, cost or copy op around them) and one of
    pt_rows_cuda 1: chip_smoke.row_wrapper_ops (D = 14, every freeze flag
    set somewhere, counted with dispatch_counter), run in a fresh
    interpreter.  In this process a profiled block around the row kernels
    made the later test_dispatch_counter_counts_launches_and_fetches miss
    its first kernel on an H100."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c",
         "import json, chip_smoke; print(json.dumps(chip_smoke."
         "row_wrapper_ops()))"],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    ops = json.loads(res.stdout.strip().splitlines()[-1])
    assert 0 < ops["ba_cam_rows"] <= 2 and 0 < ops["ba_pt_rows"] <= 1, ops


@pytest.mark.parametrize("with_intri", [False, True], ids=["D6", "D14"])
@pytest.mark.parametrize("Lw", [8, 16, 32])
@pytest.mark.parametrize("Mc", [8, 32, 128])
def test_ba_row_kernels_masks_and_widths(cuda_device, Mc, Lw, with_intri):
    """The row kernels at camera rows of 8, 32 and 128 slots and point rows
    of 8, 16 and 32, with random fix_cam, fix_trans, fix_rot, fix_pt
    (fix_intri and tie_f at D = 14), a camera of 41 rows (Mc = 128) and a
    point of several rows (Lw = 32): the checks of
    test_ba_row_kernels_match_plain (against float64), and the blocks of
    the camera and the point that have only a padding row exactly
    zero."""
    from xrsfm_tpu_torch.optim import ba

    d = _width_problem(Mc, Lw, with_intri, seed=Mc + Lw + with_intri)
    p, ell = ba.pack_camera_major(ba.BAProblem.from_numpy(cuda_device, **d))
    assert ell.cam.slots.shape[1] == Mc and ell.pt.slots.shape[1] == Lw
    starts = ell.cam.starts.cpu()
    if Mc == 128:
        assert int(starts[1] - starts[0]) == 41
    kern = _check_rows(cuda_device, p, ell, with_intri)
    assert not bool(kern["U"][-1].any()) and not bool(kern["bc"][-1].any())
    assert not bool(kern["V"][-1].any()) and not bool(kern["bp"][-1].any())


@pytest.mark.parametrize("spec", [["cam", 2, 4, 128], ["pt", 168, 168, 8]],
                         ids=["cam", "pt"])
def test_ba_row_kernels_at_smallest_main_shape(cuda_device, spec):
    """Both row kernels on problems whose camera rows (2 cameras, 4 rows
    of 128) or point rows (168 points, 168 rows of 8) have the smallest
    shapes chip_smoke.py's main-path phases (7, 8, 17, 20(b)) called them
    at on an H100, with OPENCV distortion and random freeze flags: the
    checks of test_ba_row_kernels_masks_and_widths."""
    from xrsfm_tpu_torch.optim import ba
    from xrsfm_tpu_torch.kernels import rows_timing

    d = rows_timing.problem(spec)
    rng = np.random.default_rng(3)
    for k, n in (("fix_cam", len(d["cam_q"])), ("fix_trans", len(d["cam_q"])),
                 ("fix_rot", len(d["cam_q"])), ("fix_pt", len(d["points"]))):
        d[k] = rng.random(n) < 0.2
    p, ell = ba.pack_camera_major(ba.BAProblem.from_numpy(cuda_device, **d))
    side = ell.cam if spec[0] == "cam" else ell.pt
    assert (len(side.starts) - 1, *side.slots.shape) == tuple(spec[1:])
    _check_rows(cuda_device, p, ell, False)


def test_ba_row_kernels_reject_bad_inputs(cuda_device):
    """The wrappers raise on a CPU table, a wrong index type, camera rows
    wider than 128 slots and point rows of a width other than 8, 16 or
    32; the public wrappers count the kernel's launches on CUDA and the
    plain version's on the CPU."""
    from xrsfm_tpu_torch.optim import ba

    p, ell = _row_problem(cuda_device, "small", False)
    bad = dataclasses.replace(ell.cam, other=ell.cam.other.long())
    with pytest.raises(TypeError):
        ba.cam_rows_cuda(p, dataclasses.replace(ell, cam=bad), 4.0)
    with pytest.raises(ValueError):
        ba.pt_rows_cuda(p, dataclasses.replace(ell, pt_uv=ell.pt_uv.cpu()),
                        4.0)
    p256, ell256 = ba.pack_camera_major(p, cam_width=256)
    assert ell256.cam.slots.shape[1] == 256
    with pytest.raises(ValueError):
        ba.cam_rows_cuda(p256, ell256, 4.0)
    p4, ell4 = ba.pack_camera_major(p, pt_width=4)  # point rows of 4 slots
    with pytest.raises(ValueError):
        ba.pt_rows_cuda(p4, ell4, 4.0)
    ba.reset_launch_counts()
    ba.cam_rows(p, ell, 4.0)
    ba.pt_rows(p, ell, 4.0)
    p_cpu, ell_cpu = _row_problem("cpu", "small", False)
    ba.cam_rows(p_cpu, ell_cpu, 4.0)
    assert ba.LAUNCHES == {"ba_cam_rows_cuda": 1, "ba_cam_rows_plain": 1,
                           "ba_pt_rows_cuda": 1, "ba_pt_rows_plain": 0}


def test_row_solve_on_cuda_matches_cpu(cuda_device):
    """solve_ba(p, opts, ell) on the card (through the row kernels)
    against the same solve on the CPU (through their plain versions), 20
    cameras and 500 points, bench settings: final cost, poses and points
    within rtol 1e-4; a row solve counted on CUDA, every LM iteration
    through both kernels."""
    from xrsfm_tpu_torch.optim import ba

    opts = ba.BAOptions(max_iters=10, cg_iters=2, huber_px=4.0,
                        lam_init=1e-4)
    p_cpu, ell_cpu = _row_problem("cpu", "small", False)
    cpu, i_cpu = ba.solve_ba(p_cpu, opts, ell_cpu)
    ba.reset_counts()
    ba.reset_launch_counts()
    p, ell = _row_problem(cuda_device, "small", False)
    gpu, i_gpu = ba.solve_ba(p, opts, ell)
    assert ba.COUNTS["row_solves_cuda"] == 1 and ba.COUNTS["solves_cpu"] == 0
    assert (ba.LAUNCHES["ba_cam_rows_cuda"] == ba.LAUNCHES["ba_pt_rows_cuda"]
            == ba.COUNTS["lm_iters"] > 0)
    assert ba.LAUNCHES["ba_cam_rows_plain"] == 0
    assert ba.LAUNCHES["ba_pt_rows_plain"] == 0
    assert i_gpu["final_cost"] == pytest.approx(i_cpu["final_cost"], rel=1e-4)
    for g, c in ((gpu.cam_q, cpu.cam_q), (gpu.cam_t, cpu.cam_t),
                 (gpu.points, cpu.points)):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4)


# seeds of the GBA cell's problem and of the LBA cell's local problems
GBA_SEED, LBA_SEED = 1000001, 3100000015


@pytest.fixture(scope="module")
def bal_problems():
    """numpy problems of perfbench's BAL-shaped generator: the GBA cell's
    whole problem ("gba", 1.26M observations, intrinsics fields set) and
    4 of the LBA cell's local problems ("lba0".."lba3", about 48k
    observations each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.gen import bal
    from test_torch_ba_stall import _config

    cfg = _config()
    out = {"gba": bal.make_problem(cfg, GBA_SEED)["start"]}
    prob = bal.make_problem(cfg, LBA_SEED)
    start = dict(prob["start"], cam_intri=prob["truth"]["cam_intri"])
    covis = bal.covisibility(start)
    for k, c in enumerate(bal.local_centers(cfg["n_cameras"], 4, LBA_SEED)):
        out[f"lba{k}"] = bal.local_problem(start, covis, int(c), 5)
    return out


def _pack_tensors(p, ell):
    """Every tensor of a pack by name."""
    out = {f"p.{f.name}": getattr(p, f.name) for f in dataclasses.fields(p)
           if getattr(p, f.name) is not None}
    for side in ("cam", "pt"):
        ri = getattr(ell, side)
        out.update({f"{side}.{f.name}": getattr(ri, f.name)
                    for f in dataclasses.fields(ri)})
    out.update({k: getattr(ell, k) for k in ("pt_uv", "pt_w", "pt_pos")})
    return out


def _moved(x, dev):
    """x (a tensor, a dataclass of them, nested, or a tuple) with every
    tensor moved to dev."""
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_moved(v, dev) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _moved(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name))
            or dataclasses.is_dataclass(getattr(x, f.name))})
    return x


@pytest.mark.parametrize("name", ["gba", "lba0", "lba1", "lba2", "lba3"])
def test_pack_on_cuda_equals_cpu_pack(cuda_device, bal_problems, name):
    """pack_camera_major of a CPU problem onto the card (tables built on
    the card) against the same pack built on the CPU and then moved: every
    tensor equal in dtype, shape and value, each pack counted by its
    device; on lba0, solve_ba from either pack gives the same final state
    and info, bit for bit."""
    from xrsfm_tpu_torch.optim import ba

    p = ba.BAProblem.from_numpy("cpu", **bal_problems[name])
    c0 = dict(ba.COUNTS)
    got = ba.pack_camera_major(p, device=cuda_device)
    want = ba.pack_camera_major(p)
    assert ba.COUNTS["packs_cuda"] - c0["packs_cuda"] == 1
    assert ba.COUNTS["packs_cpu"] - c0["packs_cpu"] == 1
    g, w = _pack_tensors(*got), _pack_tensors(*want)
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].device.type == "cuda", k
        assert (g[k].dtype, g[k].shape) == (w[k].dtype, w[k].shape), k
        assert torch.equal(g[k].cpu(), w[k]), k
    if name == "lba0":
        moved = _moved(want, cuda_device)
        opts = ba.BAOptions(max_iters=5, huber_px=4.0, cg_iters=15,
                            cg_tol=0.01)
        s1, i1 = ba.solve_ba(got[0], opts, got[1])
        s2, i2 = ba.solve_ba(moved[0], opts, moved[1])
        assert i1 == i2
        for f in ("cam_q", "cam_t", "cam_intri", "points"):
            assert torch.equal(getattr(s1, f), getattr(s2, f)), f


def test_pack_on_cuda_reads_the_card_once(cuda_device, bal_problems):
    """Under torch.cuda.set_sync_debug_mode, a pack of a CPU problem onto
    the card makes exactly one synchronising operation: the read of the
    four table sizes (the inputs cross by non-blocking copies)."""
    import warnings

    from xrsfm_tpu_torch.optim import ba

    p = ba.BAProblem.from_numpy("cpu", **bal_problems["lba1"])
    ba.pack_camera_major(p, device=cuda_device)  # first-use set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ba.pack_camera_major(p, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(x.message) for x in caught
             if "synchroniz" in str(x.message)]
    assert len(syncs) == 1, syncs


def test_pack_on_cuda_leaves_only_its_result(cuda_device, bal_problems):
    """The GBA problem (1.26M observations) packed onto the card: the
    pack's own peak stays under 1 GiB above what was allocated before it;
    after it returns, the allocated bytes have grown by the returned
    tensors' bytes, rounded up to the allocator's 512-byte blocks, plus at
    most 1 MiB for each tensor of 1 MiB or more (a cached block reused
    unsplit), and fall back to where they were once the result is
    dropped."""
    from xrsfm_tpu_torch.optim import ba

    p = ba.BAProblem.from_numpy("cpu", **bal_problems["gba"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ba.pack_camera_major(p, device=cuda_device)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    grown = torch.cuda.memory_allocated() - base
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in _pack_tensors(*out).values() if torch.is_tensor(t)}
    held = sum((b + 511) // 512 * 512 for b in storages.values())
    large = sum(b >= 1 << 20 for b in storages.values())
    assert peak < 1 << 30, peak
    assert held <= grown <= held + large * (1 << 20), (grown, held)
    del out
    assert torch.cuda.memory_allocated() == base


def _circle(n, radius):
    from xrsfm_tpu_torch.utils import geometry as G

    qs, ts = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        c = np.array([radius * np.cos(ang), 0.0, radius * np.sin(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        qs.append(G.rotmat_to_quat_np(R))
        ts.append(-R @ c)
    return np.asarray(qs, np.float32), np.asarray(ts, np.float32)


def test_solve_pose_graph_on_cuda_matches_cpu(cuda_device):
    """The scale pose graph on the card against the CPU: a 24-node noisy
    chain with 1- and 2-hop edges and loop edges; final cost within rtol
    1e-3 (or both under 1e-8), translations within atol 1e-3, and the solve
    counted on CUDA."""
    from xrsfm_tpu_torch.optim import pose_graph as PG

    n = 24
    q, t = _circle(n, 5.0)
    pairs = ([(i, i + k) for k in (1, 2) for i in range(n - k)]
             + [(n - 1, 0), (n - 2, 0), (n - 1, 1)])
    e = PG.build_edges_from_poses(q, t, pairs)
    t_bad = (t + np.random.default_rng(5).normal(scale=0.2, size=t.shape)
             ).astype(np.float32)
    arrays = dict(q=q, t=t_bad, log_s=np.zeros(n, np.float32), e_i=e[0],
                  e_j=e[1], e_rot=e[2], e_trans=e[3], e_logs=e[4], e_w=e[5],
                  fixed=np.eye(1, n, 0, dtype=bool)[0])
    cpu = [a.numpy() for a in PG.solve_pose_graph(
        PG.PoseGraphProblem.from_numpy("cpu", **arrays))]
    PG.reset_counts()
    gpu = [a.cpu().numpy() for a in PG.solve_pose_graph(
        PG.PoseGraphProblem.from_numpy(cuda_device, **arrays))]
    assert PG.COUNTS["solves_cuda"] == 1 and PG.COUNTS["solves_cpu"] == 0
    assert gpu[4] == pytest.approx(cpu[4], rel=1e-5)
    if cpu[3] > 1e-8:
        assert gpu[3] == pytest.approx(cpu[3], rel=1e-3)
    else:
        assert gpu[3] < 1e-8
    np.testing.assert_allclose(gpu[1], cpu[1], atol=1e-3)
    np.testing.assert_allclose(gpu[2], cpu[2], atol=1e-3)


def test_rotation_and_translation_averaging_on_cuda_match_cpu(cuda_device):
    """Rotation averaging over a drifted 60-frame chain with 1/2/3-hop and
    loop edges, and translation averaging over its centers, on the card
    against the CPU: rotations within 0.01 deg, centers within 1e-3 of the
    span, and both solves counted on CUDA."""
    from xrsfm_tpu_torch.optim import global_pose as GP
    from xrsfm_tpu_torch.optim import rot_avg as RA
    from xrsfm_tpu_torch.utils import geometry as G

    rng = np.random.default_rng(0)
    n = 60
    q_gt, t_gt = _circle(n, 20.0)
    c_gt = G.pose_center_np(q_gt, t_gt)
    drift = G.so3_exp_quat(torch.tensor(
        rng.normal(size=(n, 3)) * 0.01, dtype=torch.float32)).numpy()
    q0 = np.asarray(G.quat_mul_np(drift, q_gt), np.float32)
    conj = np.array([1.0, -1, -1, -1], np.float32)
    ei, ej = [], []
    for i in range(n):
        for k in (1, 2, 3):
            ei.append(i)
            ej.append((i + k) % n)
    ei, ej = np.asarray(ei, np.int32), np.asarray(ej, np.int32)
    qm = np.asarray(G.quat_mul_np(q_gt[ej], q_gt[ei] * conj), np.float32)
    w = np.full(len(ei), 10.0, np.float32)
    q_cpu, med_cpu = RA.solve_rotation_averaging(q0, ei, ej, qm, w,
                                                 device="cpu")
    RA.reset_counts()
    q_gpu, med_gpu = RA.solve_rotation_averaging(q0, ei, ej, qm, w,
                                                 device=cuda_device)
    assert RA.COUNTS["solves_cuda"] == 1 and RA.COUNTS["solves_cpu"] == 0
    dq = G.quat_mul_np(q_gpu.astype(np.float64),
                       q_cpu.astype(np.float64) * conj)
    ang = np.rad2deg(2 * np.arctan2(np.linalg.norm(dq[:, 1:], axis=1),
                                    np.abs(dq[:, 0])))
    assert ang.max() < 0.01 and abs(med_gpu - med_cpu) < 1e-4

    d = c_gt[ej] - c_gt[ei]
    s = np.linalg.norm(d, axis=1)
    d = d / s[:, None]
    c0 = c_gt + rng.normal(scale=0.05, size=c_gt.shape)
    c_cpu, _ = GP.solve_translation_averaging(c0, ei, ej, d, s, np.ones(len(s)),
                                              device="cpu")
    GP.reset_counts()
    c_gpu, _ = GP.solve_translation_averaging(c0, ei, ej, d, s, np.ones(len(s)),
                                              device=cuda_device)
    assert GP.COUNTS == {"solves_cuda": 1, "solves_cpu": 0}
    span = float(np.linalg.norm(c_gt.max(0) - c_gt.min(0)))
    np.testing.assert_allclose(c_gpu, c_cpu, atol=1e-3 * span)


def _intri_problem_np(n_cams=8, n_pts=200, seed=60, k1=-0.08):
    """tests/test_ba.py's per-image intrinsics problem without JAX: a
    make_scene rig seen through SIMPLE_RADIAL cameras (f 500, k1) with
    0.3 px noise, each frame its own intrinsic block, focals off by up to
    5% and k1 by up to 0.04."""
    from synthetic import make_scene
    from xrsfm_tpu_torch.utils import camera as Cam

    s = make_scene(n_cams=n_cams, n_pts=n_pts, seed=seed)
    rng = np.random.default_rng(seed + 1)
    gt = Cam.canonicalize_params(Cam.SIMPLE_RADIAL, [500.0, 320.0, 240.0, k1])
    uv = Cam.normalized_to_image(torch.tensor(gt), torch.tensor(s["uv"]))
    uv = uv.numpy() + rng.normal(scale=0.3, size=uv.shape)
    intri = np.tile(gt, (n_cams, 1))
    per = 1.0 + rng.uniform(-0.05, 0.05, n_cams)
    intri[:, :2] *= per[:, None]
    intri[:, 4] += rng.uniform(-0.04, 0.04, n_cams)
    free, tie = Cam.intri_free_mask(Cam.SIMPLE_RADIAL)
    fix_cam = np.zeros(n_cams, bool)
    fix_cam[0] = True
    fix_trans = np.zeros(n_cams, bool)
    fix_trans[1] = True
    return dict(
        cam_q=s["q"], cam_t=s["t"], cam_intri=intri, points=s["xyz"],
        obs_uv=uv.reshape(-1, 2), obs_cam=np.repeat(np.arange(n_cams), n_pts),
        obs_pt=np.tile(np.arange(n_pts), n_cams),
        obs_w=np.ones(n_cams * n_pts), fix_cam=fix_cam, fix_trans=fix_trans,
        fix_pt=np.zeros(n_pts, bool), cam_kam=np.arange(n_cams),
        fix_intri=np.tile(~free, (n_cams, 1)), tie_f=np.full(n_cams, tie),
    ), gt


def test_intrinsics_solve_on_cuda_matches_cpu(cuda_device):
    """An intrinsics-refining solve (per-image blocks, 40 LM iterations) on
    the card against the same solve on the CPU: final cost within rtol
    1e-3, focals within rtol 1e-4 and k1 within 1e-3, counted as an
    intrinsics solve on CUDA."""
    from xrsfm_tpu_torch.optim import ba

    d, _ = _intri_problem_np()
    opts = ba.BAOptions(max_iters=40, huber_px=4.0, optimize_intrinsics=True)
    cpu, i_cpu = ba.solve_ba(ba.BAProblem.from_numpy("cpu", **d), opts)
    ba.reset_counts()
    gpu, i_gpu = ba.solve_ba(ba.BAProblem.from_numpy(cuda_device, **d), opts)
    assert ba.COUNTS["intri_solves_cuda"] == 1
    assert ba.COUNTS["solves_cpu"] == ba.COUNTS["intri_solves_cpu"] == 0
    assert i_gpu["final_cost"] == pytest.approx(i_cpu["final_cost"], rel=1e-3)
    g, c = gpu.cam_intri.cpu().numpy(), cpu.cam_intri.numpy()
    np.testing.assert_allclose(g[:, :2], c[:, :2], rtol=1e-4)
    np.testing.assert_allclose(g[:, 4], c[:, 4], atol=1e-3)


def test_intrinsic_jacobi_blocks_float32_inverse_on_cuda(cuda_device):
    """The 8x8 intrinsic Jacobi blocks of that problem, LU-inverted in
    float32 on the card (ops/linalg.solve, as the solver does), against
    the float64 inverse, over the free entries (f, cx, cy, k1): no worse
    than 2x the CPU's float32 LAPACK inverse of the same blocks (+1e-7)."""
    from xrsfm_tpu_torch.ops import linalg
    from xrsfm_tpu_torch.optim import ba

    d, _ = _intri_problem_np()
    errs = []
    for dev in ("cpu", cuda_device):
        p = ba.BAProblem.from_numpy(dev, **d)
        r, z, Jc, Jp = ba._residuals_and_jacobians(p, with_intri=True)
        _, w = ba._robust_cost_and_weight(r, z, p.obs_w, 4.0)
        U, V, W, _, _ = ba._build_normal_blocks([p], [r], [Jc], [Jp], [w])
        eye14 = torch.eye(14, device=U.device)
        eye3 = torch.eye(3, device=U.device)
        Ud = U + 1e-4 * (U * eye14) + 1e-8 * eye14
        Vinv = ba._inv3x3(V + 1e-4 * (V * eye3) + 1e-8 * eye3)
        # the intrinsic blocks as optim/ba._block_jacobi sums them
        Sd = ba._jacobi_blocks([p], Ud, Vinv, W)
        Si = ba.segment_sum(Sd[:, 6:, 6:], p.cam_kam, len(p.cam_q)) \
            + 1e-7 * eye14[:8, :8]
        eye8 = torch.eye(8, device=U.device).expand(len(Si), 8, 8)
        inv64 = torch.linalg.solve(Si.double(), eye8.double())
        inv32 = linalg.solve(Si, eye8).double()
        free = [0, 2, 3, 4]
        sub = (slice(None), torch.tensor(free)[:, None],
               torch.tensor(free)[None, :])
        errs.append(float((torch.linalg.matrix_norm((inv32 - inv64)[sub])
                           / torch.linalg.matrix_norm(inv64[sub])).max()))
    assert errs[1] <= 2.0 * errs[0] + 1e-7, errs


def test_vlad_ranks_on_cuda_equal_cpu(cuda_device):
    """VLAD retrieval on the card against the CPU, on three scenes of
    seeded RootSIFT-like descriptors: the same ranks (a stable sort: ties
    to the lower index on both), vectors and similarities within 1e-5,
    counted by device."""
    from xrsfm_tpu_torch.feature import retrieval as RET

    rng = np.random.default_rng(1)
    descs = []
    for _ in range(3):
        words = np.abs(rng.normal(size=(6, 128)))
        words /= np.linalg.norm(words, axis=1, keepdims=True)
        for _ in range(5):
            x = np.abs(words[rng.integers(0, 6, 150)]
                       + rng.normal(scale=0.02, size=(150, 128)))
            x /= np.linalg.norm(x, axis=1, keepdims=True)
            descs.append(np.minimum(512.0 * x, 255.0).astype(np.uint8))
    descs.append(descs[4].copy())  # an exact duplicate: tied similarities
    r_cpu, v_cpu = RET.build_retrieval(descs, num_words=16, topk=6,
                                       device="cpu")
    RET.reset_counts()
    r_gpu, v_gpu = RET.build_retrieval(descs, num_words=16, topk=6,
                                       device=cuda_device)
    assert RET.COUNTS == {"vlad_cuda": 1, "vlad_cpu": 0}
    # before the signed square root, which amplifies the rounding of
    # components that are zero in exact arithmetic
    np.testing.assert_allclose(np.sign(v_gpu) * v_gpu * v_gpu,
                               np.sign(v_cpu) * v_cpu * v_cpu, atol=1e-5)
    np.testing.assert_allclose(v_gpu @ v_gpu.T, v_cpu @ v_cpu.T, atol=1e-5)
    np.testing.assert_array_equal(r_gpu, r_cpu)


def _bits_equal(a, b):
    return float(np.mean(np.unpackbits(a, axis=1) == np.unpackbits(b, axis=1)))


def test_orb_on_cuda_matches_cpu(cuda_device):
    """ORB at the default options on one 640x480 rendered arc image: the
    same pyramid (within 5e-5), FAST masks, scores within 1e-6 relative
    (the 16 taps are summed in another order: 8 ulps at a score of 3.5);
    the whole extraction finds the same keypoints (>= 99% of them: a score
    a few ulps off can move a tie across the pool's cut), >= 99% of their
    angles within 1e-4 rad and all within 1e-3 (where the centroid moments
    are near zero, atan2 feels their summation order: 3 of 2,046 angles
    differ by up to 4.3e-4 rad on an H100), and >= 99% equal descriptor
    bits on the shared keypoints."""
    from xrsfm_tpu_torch.ops import orb as TO

    img = _arc_image()
    cur_c = torch.from_numpy(img.astype(np.float32) / 255.0)
    cur_g = cur_c.to(cuda_device)
    for _ in range(3):
        h, w = cur_c.shape
        np.testing.assert_allclose(cur_g.cpu().numpy(), cur_c.numpy(),
                                   rtol=0, atol=5e-5)
        lv = cur_c
        cc, sc = TO._fast_score(lv, TO.OrbOptions().fast_threshold)
        cg, sg = TO._fast_score(lv.to(cuda_device),
                                TO.OrbOptions().fast_threshold)
        assert torch.equal(cg.cpu(), cc)
        np.testing.assert_allclose(sg.cpu().numpy(), sc.numpy(), rtol=1e-6,
                                   atol=0)
        nh, nw = int(round(h / 1.2)), int(round(w / 1.2))
        cur_c = TO._downscale(cur_c, nh, nw)
        cur_g = TO._downscale(cur_g, nh, nw)
    kc, dc = TO.OrbExtractor(device="cpu").extract(img)
    kg, dg = TO.OrbExtractor(device=cuda_device).extract(img)
    key_c = {tuple(k): i for i, k in enumerate(kc[:, :3].tolist())}
    shared = [(key_c[tuple(k)], j) for j, k in enumerate(kg[:, :3].tolist())
              if tuple(k) in key_c]
    assert len(kc) > 1000 and len(shared) >= 0.99 * len(kc)
    ic, ig = np.array(shared).T
    dtheta = np.abs(kg[ig, 3] - kc[ic, 3])
    assert np.mean(dtheta <= 1e-4) >= 0.99 and dtheta.max() < 1e-3
    assert _bits_equal(dg[ig], dc[ic]) >= 0.99


def _arc_image():
    import os
    import tempfile

    from xrsfm_tpu_torch.utils import image_io

    with tempfile.TemporaryDirectory() as d:
        names, _, _ = synth.write_arc_dataset(d, n_cams=2, w=640, h=480,
                                              f=562.5)
        return image_io.read_gray(os.path.join(d, "images", names[0]))


def test_hamming_matches_on_cuda_equal_cpu(cuda_device):
    """Bit-equal matches and distances on both devices, planted ties and
    the 4096 cap included."""
    rng = np.random.default_rng(3)
    for n, m in ((300, 500), (6000, 5000)):
        d1 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        d2 = rng.integers(0, 256, (m, 32), dtype=np.uint8)
        k = min(n, m) - 16
        d2[:k] = d1[:k] ^ ((rng.random((k, 32)) < 0.03)
                           * rng.integers(0, 256, (k, 32))).astype(np.uint8)
        d2[k: k + 8] = d2[:8]
        mc, dc = TM.match_pair_host_hamming(d1, d2, device="cpu")
        mg, dg = TM.match_pair_host_hamming(d1, d2, device=cuda_device)
        assert np.array_equal(mg, mc) and np.array_equal(dg, dc)
        if n > 4096:
            assert len(mg) == 4096


def test_joint_refine_scale_on_cuda_matches_cpu(cuda_device):
    """Tag corner triangulation and the joint scale refinement on both
    devices: the refined scale within 1e-4 relative."""
    from xrsfm_tpu_torch.base.map import SfMMap
    from xrsfm_tpu_torch.feature import tags as TT
    from xrsfm_tpu_torch.utils import geometry as G

    rng = np.random.default_rng(0)
    m = SfMMap()
    m.add_camera(0, 1, [500.0, 500.0, 320.0, 240.0], 640, 480)
    for i in range(8):
        ang = (i / 7 - 0.5) * 1.2
        c = np.array([4 * np.sin(ang), 0.3 * rng.normal(), -4 * np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        f = m.add_frame(f"im{i}.png", 0, np.zeros((1, 2), np.float32))
        m.q[f] = G.rotmat_to_quat_np(R)
        m.t[f] = -R @ c
        m.registered[f] = True
    centers = rng.uniform(-0.8, 0.8, (3, 3))
    det, _ = synth.tag_detections(m, centers, 0.113, 2.5, seed=0)
    scales = []
    for dev in ("cpu", cuda_device):
        corners = TT.triangulate_tag_corners(m, det, device=dev)
        s0, poses = TT.estimate_scale_from_corners(corners, 0.113)
        scales.append(TT.joint_refine_scale(m, det, corners, s0, poses,
                                            0.113, device=dev))
    a, b = scales
    assert abs(a - b) / a < 1e-4 and abs(a - 2.5) / 2.5 < 5e-3


def test_topstats_kernel_on_second_card(cuda_device):
    """On cuda:1 (where there is one) the kernel runs under that card's
    device guard and stream, interleaved with launches on cuda:0, bit-equal
    to the plain version, and its launches count under cuda:1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    cases = [_case(d, 40 + k, 3, 300, 700) for k, d in enumerate(devs)]
    TM.reset_launch_counts()
    got = [TM.topstats_cuda(*c) for c in cases + cases]
    for d in devs:
        torch.cuda.synchronize(d)
    assert TM.LAUNCHES_BY_DEVICE == {"cuda:0": 2, "cuda:1": 2}
    for g, c in zip(got, cases + cases):
        for a, b in zip(g, TM.topstats_reference(*c)):
            assert a.device == c[0].device
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_sharded_matching_on_cuda_bit_equal(cuda_device, tmp_path):
    """match_and_verify_pairs over 4 shards of the card (and over every
    card, where there are several) verifies the pairs of one device with
    the same matches, F and inlier masks, bit for bit, through the kernel
    on every shard device."""
    from xrsfm_tpu_torch.feature import matching as FM
    from xrsfm_tpu_torch.parallel.mesh import Mesh, make_mesh
    from xrsfm_tpu_torch.utils import io_features as IOF

    synth.write_unordered_workspace(str(tmp_path), "unordered", 16, 1)
    feats = IOF.read_features(str(tmp_path / "ftr.bin"))
    pairs = FM.sequential_pairs(len(feats), FM.MatchingOptions())
    one = FM.match_and_verify_pairs(feats, pairs, verbose=False,
                                    device=cuda_device)
    meshes = [Mesh([torch.device("cuda", 0)] * 4)]
    if torch.cuda.device_count() >= 2:
        meshes.append(make_mesh(torch.cuda.device_count(), "cuda"))

    def bits(ps):
        return [(p.id1, p.id2, p.matches.tobytes(), p.E.tobytes(),
                 p.inlier_mask.tobytes()) for p in ps]

    assert len(one) > 30
    for mesh in meshes:
        TM.reset_launch_counts()
        got = FM.match_and_verify_pairs(feats, pairs, verbose=False,
                                        mesh=mesh)
        assert bits(got) == bits(one)
        assert TM.LAUNCHES["topstats_plain"] == 0
        assert all(TM.LAUNCHES_BY_DEVICE.get(str(d), 0) > 0
                   for d in mesh.devices)


def test_one_rank_nccl_checksum_equals_one_process(cuda_device, tmp_path):
    """A one-rank NCCL group (file store) over the pod mesh (dcn 1, ici 4)
    gathers the shards' partials through NCCL and solves to the bits of
    the single-process 4-shard mesh."""
    import torch.distributed as dist

    from xrsfm_tpu_torch.optim import ba
    from xrsfm_tpu_torch.parallel import dist_ba, mesh as PM
    from xrsfm_tpu_torch.parallel.checksum import pytree_checksum

    dev = torch.device("cuda", 0)
    d = synth.ba_problem(n_cams=30, n_pts=2000, seed=4)
    prob = ba.BAProblem.from_numpy(dev, **d)

    def ck(p):
        return pytree_checksum({"q": p.cam_q, "t": p.cam_t, "x": p.points})

    one, cost1 = dist_ba.solve_distributed(PM.Mesh([dev] * 4), prob,
                                           max_iters=5)
    assert PM.initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                                     device=dev, timeout_s=120.0) == (1, 0)
    try:
        pod = PM.make_pod_mesh([dev] * 4)
        assert dist.get_backend() == "nccl" and pod.shape == {"dcn": 1,
                                                              "ici": 4}
        nccl, cost = dist_ba.solve_distributed(pod, prob, max_iters=5,
                                               axis=("dcn", "ici"))
    finally:
        dist.destroy_process_group()
    assert cost == cost1 and ck(nccl) == ck(one)


def test_dispatch_counter_counts_launches_and_fetches(cuda_device):
    """utils/profiling.dispatch_counter on a block of known work: one
    elementwise kernel, a reduction fetched by .item() (a kernel and a
    device-to-host copy) and an explicit synchronise; the counter's own
    synchronise and the profiler's are not counted."""
    from xrsfm_tpu_torch.utils.profiling import dispatch_counter

    x = torch.ones(1000, device=cuda_device)
    torch.cuda.synchronize()
    with dispatch_counter(cuda_device) as c:
        y = x * 2
        assert y.sum().item() == 2000.0
        torch.cuda.synchronize()
    assert c["dispatches"] == 3 and c["fetches"] == 2, c
    assert sum(c["by_name"].values()) == 2
    assert any(k.startswith("vectorized_elementwise_kernel")
               for k in c["by_name"]), c["by_name"]


def _pcg_problem(dev, intri, cg_iters=15):
    import pcg_reference as PR
    from xrsfm_tpu_torch.optim import ba

    d = PR.problem(intri, n_cams=20, n_pts=500)
    p, ell = ba.pack_camera_major(ba.BAProblem.from_numpy(dev, **d))
    return p, ell, PR.options(intri, cg_iters)


@pytest.mark.parametrize("route", ["graph", "eager"])
@pytest.mark.parametrize("intri", [False, True], ids=["D6", "D14"])
def test_pcg_graph_bit_equal_to_out_of_place(cuda_device, monkeypatch,
                                             intri, route):
    """On the card, solve_ba through the row kernels with each LM step's
    PCG iterations replayed as a CUDA graph, against the same solve with
    tests/pcg_reference.py's out-of-place loop in _Pcg's place, which runs
    the in-place step in lockstep from each LM step's setup, replayed from
    a capture of its own (graph) or called (eager): the largest difference
    of any iterate, the final state, the info dict and COUNTS["cg_iters"]
    bit for bit; a replay for every iteration."""
    import pcg_reference as PR
    from xrsfm_tpu_torch.optim import ba

    p, ell, opts = _pcg_problem(cuda_device, intri)
    ba.reset_counts()
    got, info = ba.solve_ba(p, opts, ell)
    counts = dict(ba.COUNTS)
    diffs = []
    monkeypatch.setattr(ba, "_Pcg", PR.lockstep(diffs, route))
    ba.reset_counts()
    want, info_ref = ba.solve_ba(p, opts, ell)
    assert len(diffs) == ba.COUNTS["cg_iters"] == counts["cg_iters"] > 0
    assert max(diffs) == 0.0, f"largest difference {max(diffs)!r}"
    assert info == info_ref and info["final_cost"] < info["initial_cost"]
    for f in ("cam_q", "cam_t", "cam_intri", "points"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert counts["pcg_graph_replays"] == counts["cg_iters"]
    assert 0 < counts["pcg_graph_captures"] <= counts["lm_iters"]


def test_pcg_graph_captures_and_replays(cuda_device, monkeypatch):
    """One capture for each LM step whose PCG iterates, none for one that
    stops at its first test (cg_tol 1e9) or has cg_iters 0, and one
    replay for each iteration: over a D = 6, a D = 14 and those solves."""
    from xrsfm_tpu_torch.optim import ba

    runs = []
    run = ba._Pcg.run

    def counted(self, cg_iters, graph):
        n0 = ba.COUNTS["cg_iters"]
        run(self, cg_iters, graph)
        runs.append(ba.COUNTS["cg_iters"] - n0)

    monkeypatch.setattr(ba._Pcg, "run", counted)
    ba.reset_counts()
    for intri, cg_iters, cg_tol in ((False, 15, 1e-2), (True, 15, 1e-2),
                                    (False, 15, 1e9), (False, 0, 1e-2)):
        p, ell, opts = _pcg_problem(cuda_device, intri, cg_iters)
        ba.solve_ba(p, dataclasses.replace(opts, cg_tol=cg_tol), ell)
    c = ba.COUNTS
    assert len(runs) == c["lm_iters"] and 0 in runs
    assert c["pcg_graph_captures"] == sum(1 for n in runs if n > 0) > 0
    assert c["pcg_graph_replays"] == c["cg_iters"] == sum(runs)


def test_pcg_graph_under_profiler(cuda_device):
    """A warm row solve under torch.profiler (tests/pcg_reference.
    profiled_solve, in a fresh interpreter so that it is the process's
    first profile): its graphs capture and replay, each replay is one
    cudaGraphLaunch on the host, every copy the host asked for pairs with
    one the device ran (no copy inside a graph), the PCG stop tests'
    fetches pin the clocks, and PCG issues under 20 launches an
    iteration (setup and capture included)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, 'tests'); "
         "import pcg_reference; "
         "print(json.dumps(pcg_reference.profiled_solve()))"],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    c = out["counts"]
    assert c["pcg_graph_captures"] > 0, out
    assert out["graph_launches"] == c["pcg_graph_replays"] == c["cg_iters"]
    assert out["host_copies"] == out["device_copies"] > 0, out
    assert out["fetches"] is not None and out["fetches"] >= c["cg_iters"]
    assert 0 < out["launches_per_iter"] < 20, out
