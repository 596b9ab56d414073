#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (xrsfm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernel csrc/topstats.cu with nvcc for sm_90a, from
     the sources in this checkout;
  3. the kernel against its plain PyTorch version on the card, on seeded
     descriptors with planted matches, exact ties and ragged masks, at the
     matching stage's chunk shapes: all four outputs must be bit-equal;
     median times of both;
  4. the matching stage through its entry point,
     pipelines.run_matching.main(..., "sequential", ..., device="cuda"),
     on 48 rendered 640x480 arc-scene images (722 candidate pairs);
  5. gates: the matcher went through the kernel (launches > 0, no plain
     launch), every adjacent pair is verified, >= 90% of each verified
     pair's inliers have a squared Sampson error below (4 px)^2 under the
     ground-truth F of the scene, and fp.bin reads back;
  6. bundle adjustment on the card: the port's solve_ba on bench.py's
     140k-observation problem (200 cameras, 20k points, seed 0; 30 LM
     iterations, 2 PCG iterations, Huber 4 px, lambda0 1e-4), regenerated
     in numpy; its final cost must lie in 54,200..54,600; LM iterations/s
     and the solve's device time;
  7. the reconstruction stage through its entry point,
     pipelines.run_reconstruction.main(<phase-4 bins>, camera.txt, ...,
     device="cuda"): initialization succeeds, 48/48 frames register, the
     sim(3)-aligned ATE is at most min(2x the median of the JAX package's
     ATEs on the same bins, 3% of the trajectory span), the written model's mean
     reprojection error is below 1 px, cameras.bin / images.bin /
     points3D.bin read back, and every BA solve ran on a CUDA tensor.

Any failure exits non-zero.  Without a CUDA device it exits 1 at once.
The last two lines of standard output are the kernel summary (JSON) and
{"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 48
WIDTH, HEIGHT, FOCAL = 640, 480, 562.5  # the arc scene's 512x384 f=450 FOV
PHASE3_SHAPES = [(16, 2048), (16, 4096), (4, 8192)]  # (pairs B, N = M)
SAMPSON_PX = 4.0  # MatchingOptions.f_ransac_px
MIN_GOOD_FRACTION = 0.9
# The JAX package's bf16 camera-major solver stops at 54,536..54,555
# (bench.py:126-127); its float32 COO solver, which the port follows,
# reaches 54,267.0 on this problem (on a CPU; tests/test_torch_ba.py), about
# the 54,334 +- 165 that 0.5 px noise leaves over 217,337 degrees of
# freedom.  The band admits both.
BA_COST_BAND = (54200.0, 54600.0)
BA_OPTS = dict(max_iters=30, cg_iters=2, huber_px=4.0, lam_init=1e-4)
# The JAX package's run_reconstruction on the CPU (xrsfm_tpu, default
# MapperOptions) on the ftr.bin / fp.bin that phase 4 wrote on an H100
# (files with these SHA-256 digests): 48/48 registered in every run, and a
# sim(3)-aligned ATE that is a draw over the RANSAC seeds: 0.042639% of the
# 3.1051 trajectory span with its own seeds, 0.18209, 0.11642, 0.03853,
# 0.07113, 0.36799, 0.06311 and 0.04770% with PRNGKey seeds re-salted.
# The gate takes the median of the eight.
JAX_ATE_PCT = 0.06712320
JAX_BINS_SHA256 = {
    "ftr.bin": "866ec61302dc726e8e829ccb1fe06476ec8bd0621cc304969724badb80130c4f",
    "fp.bin": "c11fac1723d0db54fa3fb9f28339bd9f8d745d332d34079936639a8ad2279c0c",
}
MAX_ATE_PCT = min(2.0 * JAX_ATE_PCT, 3.0)
MAX_REPROJ_PX = 1.0


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps):
    """Median milliseconds of fn over reps launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_kernel(TM, synth, B, N):
    """Kernel vs plain on one seeded case: (max_abs_err, kernel ms,
    plain ms); fails unless all four outputs are bit-equal."""
    args = [torch.from_numpy(a).cuda()
            for a in synth.descriptor_case(1000 + N, B, N, N)]
    got = TM.topstats_cuda(*args)
    torch.cuda.synchronize()
    exp = TM.topstats_reference(*args)
    err = 0.0
    for g, e, name in zip(got, exp, ("best", "second", "best_j", "col_arg")):
        if g.dtype != e.dtype or g.shape != e.shape:
            fail(f"topstats {name} at B={B} N=M={N}: {g.dtype}{tuple(g.shape)}"
                 f" vs {e.dtype}{tuple(e.shape)}")
        if not torch.equal(g.view(torch.int32), e.view(torch.int32)):
            bad = int((g.view(torch.int32) != e.view(torch.int32)).sum())
            fail(f"topstats {name} at B={B} N=M={N}: {bad} entries differ "
                 f"from the plain version")
        err = max(err, float((g.double() - e.double()).abs().max()))
    k_ms = time_ms(lambda: TM.topstats_cuda(*args), 20)
    p_ms = time_ms(lambda: TM.topstats_reference(*args), 5)
    del args, got, exp
    torch.cuda.empty_cache()
    return err, k_ms, p_ms


def sampson_sq(F, x1, x2):
    p1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    p2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    Fx1 = p1 @ F.T
    Ftx2 = p2 @ F
    num = np.sum(p2 * Fx1, 1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / np.maximum(den, 1e-300)


def match_phases(TM, RM, IOF, synth, work):
    """Phases 4 and 5: the matching stage through its entry point on the
    rendered arc scene in `work`, and its gates.  Leaves the scene and
    out/ftr.bin, out/fp.bin in `work`.  Returns (kernel launch counts,
    features per image)."""
    t0 = time.perf_counter()
    names, poses, K = synth.write_arc_dataset(
        work, n_cams=N_IMAGES, w=WIDTH, h=HEIGHT, f=FOCAL)
    print(f"[phase 4] rendered {N_IMAGES} arc images {WIDTH}x{HEIGHT} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    out = os.path.join(work, "out")
    stats = {}
    TM.reset_launch_counts()
    verified = RM.main(os.path.join(work, "images"), "", "sequential",
                       out, stats=stats, device="cuda")
    torch.cuda.synchronize()
    launches = dict(TM.LAUNCHES)
    feats = IOF.read_features(os.path.join(out, "ftr.bin"))
    back = IOF.read_frame_pairs(os.path.join(out, "fp.bin"))
    counts = [len(f.keypoints) for f in feats]
    print(f"[phase 4] extract {stats['extract_s']:.3f} s, match+verify "
          f"{stats['match_verify_s']:.3f} s; mean features "
          f"{float(np.mean(counts)):.1f} (min {min(counts)}, max "
          f"{max(counts)}); pairs proposed {stats['pairs_proposed']}, "
          f"verified {len(verified)}; launches kernel "
          f"{launches['topstats_cuda']}, plain {launches['topstats_plain']}",
          flush=True)

    # phase 5: gates
    if launches["topstats_cuda"] <= 0:
        fail("the matching stage launched the topstats kernel 0 times")
    if launches["topstats_plain"] != 0:
        fail(f"the matching stage ran the plain matcher "
             f"{launches['topstats_plain']} times")
    if len(feats) != N_IMAGES or not all(
            np.isfinite(f.keypoints).all() for f in feats):
        fail("ftr.bin: wrong frame count or non-finite keypoints")
    got = {(p.id1, p.id2): p for p in verified}
    missing = [(i, i + 1) for i in range(N_IMAGES - 1) if (i, i + 1) not in got]
    if missing:
        fail(f"adjacent pairs not verified: {missing}")
    worst = 1.0
    for p in verified:
        F = synth.fundamental_from_poses(K, poses[p.id1], poses[p.id2])
        m = p.matches[p.inlier_mask]
        x1 = feats[p.id1].keypoints[m[:, 0], :2].astype(np.float64)
        x2 = feats[p.id2].keypoints[m[:, 1], :2].astype(np.float64)
        good = float(np.mean(sampson_sq(F, x1, x2) < SAMPSON_PX**2))
        worst = min(worst, good)
        if good < MIN_GOOD_FRACTION:
            fail(f"pair {p.id1}-{p.id2}: only {good:.3f} of "
                 f"{len(m)} inliers under the ground-truth epipolar gate")
    if len(back) != len(verified) or any(
            (a.id1, a.id2) != (b.id1, b.id2)
            or not np.array_equal(a.matches, b.matches)
            or not np.array_equal(a.inlier_mask, b.inlier_mask)
            for a, b in zip(back, verified)):
        fail("fp.bin does not read back as the verified pairs")
    print(f"[phase 5] gates passed: {len(verified)} verified pairs, all "
          f"{N_IMAGES - 1} adjacent; worst ground-truth epipolar inlier "
          f"share {worst:.4f}", flush=True)
    return launches, counts


def ba_phase():
    """Phase 6: the port's solve_ba on bench.make_ba_problem's problem."""
    from xrsfm_tpu_torch.optim import ba
    from xrsfm_tpu_torch.utils import synth

    d = synth.ba_problem(n_cams=200, n_pts=20000, obs_per_pt=7, seed=0)
    prob = ba.BAProblem.from_numpy("cuda", **d)
    opts = ba.BAOptions(**BA_OPTS)
    ba.solve_ba(prob, ba.BAOptions(**dict(BA_OPTS, max_iters=2)))  # warm-up
    torch.cuda.synchronize()
    ba.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sol, info = ba.solve_ba(prob, opts)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    dev_ms = start.elapsed_time(end)
    cost = info["final_cost"]
    if not all(torch.isfinite(a).all() for a in (sol.cam_q, sol.cam_t,
                                                  sol.points)):
        fail("BA: non-finite parameters after the solve")
    if ba.COUNTS["solves_cuda"] != 1 or ba.COUNTS["solves_cpu"] != 0:
        fail(f"BA: solve counts {ba.COUNTS}")
    print(f"[phase 6] BA {len(d['obs_cam'])} observations, 200 cameras, "
          f"20000 points: cost {info['initial_cost']:.1f} -> {cost:.1f} in "
          f"{info['iters']} LM iterations ({ba.COUNTS['cg_iters']} PCG); "
          f"{info['iters'] / wall:.2f} LM iterations/s; device time "
          f"{dev_ms:.1f} ms (CUDA events), host {wall:.3f} s", flush=True)
    if not BA_COST_BAND[0] <= cost <= BA_COST_BAND[1]:
        fail(f"BA final cost {cost:.1f} outside {BA_COST_BAND}")


def _sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def recon_phase(work):
    """Phase 7: run_reconstruction.main on phase 4's bins, and its gates."""
    from xrsfm_tpu_torch.ops.umeyama import ate_rmse
    from xrsfm_tpu_torch.optim import ba
    from xrsfm_tpu_torch.pipelines import run_reconstruction as RR
    from xrsfm_tpu_torch.utils import camera as Cam
    from xrsfm_tpu_torch.utils import geometry as G
    from xrsfm_tpu_torch.utils import io_colmap as IOC

    bins = os.path.join(work, "out")
    same = all(_sha256(os.path.join(bins, n)) == h
               for n, h in JAX_BINS_SHA256.items())
    model = os.path.join(work, "model")
    ba.reset_counts()
    stats = {}
    t0 = time.perf_counter()
    m = RR.main(bins, os.path.join(work, "camera.txt"), model, stats=stats,
                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if m is None:
        fail("reconstruction: initialization failed")
    st = stats["mapper"]
    print("[phase 7] stage seconds " + json.dumps({
        "total": round(wall, 3), **{k[5:]: round(v, 3) for k, v in
                                    vars(st).items() if k.startswith("time_")}
    }), flush=True)
    print(f"[phase 7] BA solves {ba.COUNTS['solves_cuda']} on CUDA, "
          f"{ba.COUNTS['solves_cpu']} on the CPU; LM iterations "
          f"{ba.COUNTS['lm_iters']}, PCG iterations {ba.COUNTS['cg_iters']}",
          flush=True)
    if ba.COUNTS["solves_cuda"] == 0 or ba.COUNTS["solves_cpu"] != 0:
        fail(f"reconstruction: BA solve counts {ba.COUNTS}")

    cams = IOC.read_cameras_bin(os.path.join(model, "cameras.bin"))
    imgs = IOC.read_images_bin(os.path.join(model, "images.bin"))
    pts = IOC.read_points3d_bin(os.path.join(model, "points3D.bin"))
    gt = {}
    with open(os.path.join(work, "gt_poses.txt")) as f:
        for line in f:
            p = line.split()
            gt[p[0]] = (np.array(p[1:5], float), np.array(p[5:8], float))
    ims = sorted(imgs.values(), key=lambda im: im.name)
    if len(ims) != N_IMAGES or any(im.name not in gt for im in ims):
        fail(f"reconstruction: {len(ims)}/{N_IMAGES} frames registered")
    est = np.array([G.pose_center_np(im.qvec, im.tvec) for im in ims])
    ref = np.array([G.pose_center_np(*gt[im.name]) for im in ims])
    span = float(np.linalg.norm(ref.max(0) - ref.min(0)))
    ate_pct = 100.0 * ate_rmse(ref, est) / span

    uvn, xy, canon = [], [], []
    for im in ims:
        cam = cams[im.camera_id]
        R = G.quat_to_rotmat_np(im.qvec)
        for (x, y), pid in zip(im.xys, im.point3D_ids):
            if pid < 0:
                continue
            if pid not in pts:
                fail(f"reconstruction: image {im.name} observes missing "
                     f"point {pid}")
            pc = R @ pts[pid].xyz + im.tvec
            uvn.append(pc[:2] / pc[2])
            xy.append((x, y))
            canon.append(Cam.canonicalize_params(cam.model_id, cam.params))
    pix = Cam.normalized_to_image(torch.tensor(np.array(canon)),
                                  torch.tensor(np.array(uvn))).numpy()
    errs = np.linalg.norm(pix - np.array(xy), axis=1)
    mean_err = float(np.mean(errs)) if len(errs) else float("inf")
    print(f"[phase 7] {len(ims)}/{N_IMAGES} registered, {len(pts)} points, "
          f"{len(errs)} observations; ATE {ate_pct:.5f}% of span "
          f"{span:.4f} (limit {MAX_ATE_PCT:.5f}%: 2x the JAX package's median "
          f"{JAX_ATE_PCT:.5f}%, bins {'identical to' if same else 'differ from'}"
          f" the JAX measurement's); mean reprojection error "
          f"{mean_err:.4f} px", flush=True)
    if not ate_pct <= MAX_ATE_PCT:
        fail(f"reconstruction: ATE {ate_pct:.5f}% above {MAX_ATE_PCT:.5f}%")
    if not mean_err < MAX_REPROJ_PX:
        fail(f"reconstruction: mean reprojection error {mean_err:.4f} px")
    print("[phase 7] gates passed", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    from xrsfm_tpu_torch.kernels import build
    from xrsfm_tpu_torch.ops import matching as TM
    from xrsfm_tpu_torch.pipelines import run_matching as RM
    from xrsfm_tpu_torch.utils import io_features as IOF
    from xrsfm_tpu_torch.utils import synth

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"[phase 1] device {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # phase 2: build from the checkout's sources
    lib = build.library_path("topstats.cu")
    if os.path.exists(lib):
        os.remove(lib)
    t0 = time.perf_counter()
    build.load("topstats.cu")
    print(f"[phase 2] built topstats.cu with nvcc (sm_90a) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 3: kernel against plain, bit-equal, timed
    kstats = {}
    for B, N in PHASE3_SHAPES:
        err, k_ms, p_ms = compare_kernel(TM, synth, B, N)
        kstats[(B, N)] = (err, k_ms, p_ms)
        print(f"[phase 3] topstats B={B} N=M={N}: bit-equal to plain; "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median)",
              flush=True)

    # phases 4-7: the matching stage, BA, the reconstruction stage
    scratch = os.path.dirname(build.BUILD_DIR)  # build/, git-ignored
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        launches, counts = match_phases(TM, RM, IOF, synth, work)
        ba_phase()
        recon_phase(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    k_main = IOF.bucket(max(counts), lo=256)
    if (16, k_main) not in kstats:
        kstats[(16, k_main)] = compare_kernel(TM, synth, 16, k_main)
    err = max(v[0] for v in kstats.values())
    _, k_ms, p_ms = kstats[(16, k_main)]
    print(f"[summary] kernel summary below: times at the matching stage's chunk "
          f"shape B=16 N=M={k_main}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "topstats",
        "route": "cuda",
        "source": "xrsfm_tpu_torch/csrc/topstats.cu",
        "replaces": "xrsfm_tpu/ops/matching.py:33",
        "launches": launches["topstats_cuda"],
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
