"""SIFT extraction throughput breakdown on a device: the twin of
scripts/profile_sift.py.

Times ops/sift.SiftExtractor.extract_batch on bench.py's SIFT input (a
5x5-box-blurred noise image, 480x640, a batch of 16) while sweeping the
per-octave candidate pool.  Orientation and descriptor work is
proportional to pool slots, not to real keypoints, so images/s against
the pool separates the slot-proportional stage from the fixed pyramid,
detection, top-k and transfer cost.  Each rep's clock is read after a
torch.cuda.synchronize() on a GPU.  Prints one JSON line:
  {"size", "batch", "points": [{pool, images_per_s, s_per_batch,
   keypoints}], "us_per_slot_per_image", "fixed_s_per_image", "device"}

Usage: python -m xrsfm_tpu_torch.tools.profile_sift [--pools 512,1024,2048]
       [--reps 4] [--size 480,640] [--batch 16] [--device cuda]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sift import SiftExtractor, SiftOptions


def bench_image(h, w, seed=0):
    """bench.py's SIFT input: uniform noise blurred by a 5x5 box, uint8."""
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, size=(h, w)).astype(np.float32)
    k = np.ones((5, 5), np.float32) / 25.0
    sw = sliding_window_view(np.pad(img, 2, mode="edge"), (5, 5))
    return (sw * k).sum(axis=(2, 3)).astype(np.uint8)


def pool_slots(pool, n_octaves=4, floor=128):
    """Orientation/descriptor slots an image: sum over octaves of
    max(pool >> o, floor)."""
    return sum(max(pool >> o, floor) for o in range(n_octaves))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pools", default="512,1024,2048")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--size", default="480,640")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    h, w = map(int, a.size.split(","))
    imgs = [bench_image(h, w)] * a.batch
    out = {"size": [h, w], "batch": a.batch, "points": []}
    meds = []  # unrounded, for the slope
    for pool in map(int, a.pools.split(",")):
        ex = SiftExtractor(SiftOptions(
            num_octaves=4, features_per_octave=pool, max_features=4096,
            first_octave=0), device=dev)
        ex.extract_batch(imgs, batch=a.batch)  # warm-up
        times = []
        for _ in range(a.reps):
            sync()
            t0 = time.perf_counter()
            res = ex.extract_batch(imgs, batch=a.batch)
            sync()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        meds.append(med)
        n_kp = int(np.mean([len(kp) for kp, _ in res]))
        out["points"].append({
            "pool": pool,
            "images_per_s": round(a.batch / med, 2),
            "s_per_batch": round(med, 3),
            "keypoints": n_kp,
        })
        print(f"pool={pool}: {a.batch / med:.2f} img/s, {n_kp} kp",
              file=sys.stderr, flush=True)
    # slot-cost slope from the smallest and the largest pool
    pts = out["points"]
    if len(pts) >= 2:
        s0, s1 = pool_slots(pts[0]["pool"]), pool_slots(pts[-1]["pool"])
        per_slot = (meds[-1] - meds[0]) / max(s1 - s0, 1) / a.batch
        fixed = meds[0] / a.batch - per_slot * s0
        out["us_per_slot_per_image"] = round(1e6 * per_slot, 2)
        out["fixed_s_per_image"] = round(fixed, 4)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
