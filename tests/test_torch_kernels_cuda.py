"""The port's CUDA matcher kernel (u8 wgmma dots fed by TMA) against its
plain PyTorch version, and
the port's solvers (bundle adjustment with and without intrinsics, the
scale pose graph, rotation and translation averaging) and VLAD retrieval
on the card against the same work on the CPU, and the float32 inverse of
the intrinsics solve's 8x8 Jacobi blocks against float64.

Needs a CUDA device and nvcc; skips elsewhere.  On a machine with a GPU
(and no JAX, which the repo's conftest imports), run:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

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
        U, V, W, _, _ = ba._build_normal_blocks(p, r, Jc, Jp, w)
        eye14 = torch.eye(14, device=U.device)
        eye3 = torch.eye(3, device=U.device)
        Ud = U + 1e-4 * (U * eye14) + 1e-8 * eye14
        Vinv = ba._inv3x3(V + 1e-4 * (V * eye3) + 1e-8 * eye3)
        _, Si = ba._jacobi_blocks(p, Ud, Vinv, W,
                                  ba._TiedSpace(p.cam_kam, len(p.cam_q)))
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
