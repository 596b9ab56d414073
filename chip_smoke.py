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
     ground-truth F of the scene, and fp.bin reads back.

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

    # phase 4: the matching stage through its entry point
    scratch = os.path.dirname(build.BUILD_DIR)  # build/, git-ignored
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
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
    finally:
        shutil.rmtree(work, ignore_errors=True)
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

    k_main = IOF.bucket(max(counts), lo=256)
    if (16, k_main) not in kstats:
        kstats[(16, k_main)] = compare_kernel(TM, synth, 16, k_main)
    err = max(v[0] for v in kstats.values())
    _, k_ms, p_ms = kstats[(16, k_main)]
    print(f"[phase 5] kernel summary below: times at the stage's chunk "
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
