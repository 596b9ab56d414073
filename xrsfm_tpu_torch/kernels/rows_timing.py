"""Time the bundle adjuster's two row kernels (csrc/ba_cam_rows.cu,
csrc/ba_pt_rows.cu) on a CUDA card, in one checkout or in several in turns.

For each problem, each kernel is timed two ways: its raw launches alone
(the C launcher calls that one call of its wrapper, optim/ba.cam_rows_cuda
or pt_rows_cuda, makes, recorded and replayed with the same arguments) and
its wrapper as a whole.  Each is timed as one call between two CUDA events
(median of 20) and queued (device time a call, 20 calls enqueued behind a
sleep kernel, median of 5).  The wrapper's device operations a call are
counted with utils/profiling.dispatch_counter.

Problems: bench.py's two (139,265 and 1,114,041 observations, pose-only,
with k1, k2, p1, p2 set) and problems whose camera or point rows have a
given shape (`shaped_problem`; chip_smoke.py phase 21 times the main
path's median and largest shapes with it).

    python -m xrsfm_tpu_torch.kernels.rows_timing --trees A B B A \\
        --shapes '[["cam", 48, 60, 128], ["pt", 5000, 5000, 16]]' \\
        --out rows_timing.json

Each TREE is the root of a checkout: one process a tree, in the order
given, imports that checkout's xrsfm_tpu_torch (its kernels are built
there, under build/kernels) and times its kernels on the same problems,
which this file generates from fixed seeds.  Compare two checkouts in
turns (A B B A) within one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np

BENCH_SIZES = {"140k": dict(n_cams=200, n_pts=20000, obs_per_pt=7, seed=0),
               "1.1M": dict(n_cams=1024, n_pts=160000, obs_per_pt=7,
                            seed=0)}
DISTORTION = [-0.05, 0.01, 1e-3, -5e-4]
HUBER_PX = 4.0


def shaped_problem(side, n_seg, n_rows, width, seed=0):
    """numpy BAProblem fields whose pack_camera_major rows on `side`
    ("cam": n_seg cameras; "pt": n_seg points) come out as n_rows rows of
    `width` slots.  Every segment gets at least one row and the extra rows
    fall on random segments; a segment's last row holds 1..width slots and
    the segment with the most rows is full, so the width bucket is `width`.
    The other side is incidental: 4 observations a point on "cam", 64
    cameras on "pt".  Cameras look down +z from (0, 0, 0.1 c); points lie
    5 to 40 beyond the last.  As in bench.py's problem, the pixels are
    projections of the points with 0.5 px of noise and the points then
    move by 0.05 (a few pixels of residual)."""
    rng = np.random.default_rng(seed)
    cap = 128 if side == "cam" else 32
    if not (1 <= n_seg <= n_rows and 8 <= width <= cap
            and width & (width - 1) == 0
            and (n_rows == n_seg or width == cap)):
        raise ValueError(f"no {side} rows of shape ({n_seg}, {n_rows}, "
                         f"{width})")
    rows = 1 + np.bincount(rng.integers(0, n_seg, n_rows - n_seg),
                           minlength=n_seg)
    counts = (rows - 1) * width + rng.integers(1, width + 1, n_seg)
    counts[np.argmax(rows)] = rows.max() * width
    seg = np.repeat(np.arange(n_seg), counts)
    n_obs = len(seg)
    if side == "cam":
        n_cams, n_pts = n_seg, max(1, n_obs // 4)
        obs_cam = seg
        obs_pt = rng.permutation(np.arange(n_obs) % n_pts)
    else:
        n_cams, n_pts = 64, n_seg
        obs_cam = rng.integers(0, n_cams, n_obs)
        obs_pt = seg
    f, cx, cy = 718.0, 607.0, 185.0
    centers = np.zeros((n_cams, 3))
    centers[:, 2] = 0.1 * np.arange(n_cams)
    far = centers[-1, 2]
    xyz = np.concatenate([rng.uniform(-4.0, 4.0, (n_pts, 2)),
                          rng.uniform(far + 5.0, far + 40.0, (n_pts, 1))], 1)
    pc = xyz[obs_pt] - centers[obs_cam]
    uv = pc[:, :2] / pc[:, 2:3] * f + np.array([cx, cy])
    uv += rng.normal(scale=0.5, size=uv.shape)
    xyz += rng.normal(scale=0.05, size=xyz.shape)
    qs = np.zeros((n_cams, 4), np.float32)
    qs[:, 0] = 1.0
    fix_cam = np.zeros(n_cams, bool)
    fix_cam[0] = True
    fix_trans = np.zeros(n_cams, bool)
    fix_trans[min(1, n_cams - 1)] = True
    return dict(
        cam_q=qs, cam_t=(-centers).astype(np.float32),
        cam_intri=np.tile(np.array([f, f, cx, cy, 0, 0, 0, 0], np.float32),
                          (n_cams, 1)),
        points=xyz.astype(np.float32), obs_uv=uv.astype(np.float32),
        obs_cam=obs_cam.astype(np.int32), obs_pt=obs_pt.astype(np.int32),
        obs_w=np.ones(n_obs, np.float32), fix_cam=fix_cam,
        fix_trans=fix_trans, fix_pt=np.zeros(n_pts, bool))


def raw_launches(ba, call):
    """Run call() (a row-kernel wrapper on CUDA tensors) once, recording the
    C launcher calls it makes through ba._launch.  Returns (its result, a
    function that replays those launches alone, with the same arguments
    and into the same outputs)."""
    calls = []
    launch = ba._launch

    def record(*args):
        calls.append(args)
        return launch(*args)

    ba._launch = record
    try:
        out = call()
    finally:
        ba._launch = launch
    if not calls:
        raise RuntimeError("the wrapper launched no kernel")

    def replay():
        for args in calls:
            launch(*args)

    replay.launches = len(calls)
    return out, replay


def time_ms(fn, reps=20):
    """Median milliseconds of fn as one call between two CUDA events."""
    import torch

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


def queued_ms(fn, launches=20, rounds=5):
    """Median over `rounds` of the device time a call of fn, in ms:
    `launches` calls enqueued between two events behind a sleep kernel,
    so that nothing of the host is in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # about 10 ms: the host runs ahead
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per)


def wrapper_ops(wrapper, calls=20):
    """Device operations a call of wrapper: those of `calls` calls counted
    together (utils/profiling.dispatch_counter), over calls."""
    from xrsfm_tpu_torch.utils.profiling import dispatch_counter

    wrapper()
    with dispatch_counter("cuda") as c:
        for _ in range(calls):
            wrapper()
    return c["dispatches"] / calls


def kernel_split(fn, calls=20):
    """Device milliseconds a call of fn by kernel, from torch.profiler's
    CUDA events over `calls` calls: {kernel name: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            out[name] = out.get(name, 0.0) + t / 1e3 / calls
    return out


def time_kernel(ba, wrapper, split=False):
    """The four times of one row kernel and its wrapper's device
    operations a call: {raw_ms, raw_queued_ms, wrapper_ms,
    wrapper_queued_ms, launches, wrapper_ops}; with split, also the raw
    launches' device time by kernel (kernels_ms)."""
    _, raw = raw_launches(ba, wrapper)
    out = dict(raw_ms=time_ms(raw), raw_queued_ms=queued_ms(raw),
               wrapper_ms=time_ms(wrapper),
               wrapper_queued_ms=queued_ms(wrapper),
               launches=raw.launches, wrapper_ops=wrapper_ops(wrapper))
    if split:
        out["kernels_ms"] = kernel_split(raw)
    return out


def problem(spec):
    """numpy problem fields of a spec: ["bench", "140k" | "1.1M"] or
    [side, n_seg, n_rows, width]."""
    if spec[0] == "bench":
        from xrsfm_tpu_torch.utils import synth

        d = synth.ba_problem(**BENCH_SIZES[spec[1]])
    else:
        d = shaped_problem(*spec)
    d["cam_intri"] = d["cam_intri"].copy()
    d["cam_intri"][:, 4:] = DISTORTION
    return d


def run_worker(specs):
    """Time this process's checkout's kernels on every spec: a list of
    {spec, cam_shape, pt_shape, ba_cam_rows, ba_pt_rows}."""
    import torch

    from xrsfm_tpu_torch.optim import ba

    out = []
    for spec in specs:
        p, ell = ba.pack_camera_major(
            ba.BAProblem.from_numpy("cuda", **problem(spec)))
        res = {"spec": spec,
               "cam_shape": [p.cam_q.shape[0], *ell.cam.slots.shape],
               "pt_shape": [p.points.shape[0], *ell.pt.slots.shape]}
        kinds = {"bench": ("cam", "pt"), "cam": ("cam",), "pt": ("pt",)}
        if "cam" in kinds[spec[0]]:
            res["ba_cam_rows"] = time_kernel(
                ba, lambda: ba.cam_rows_cuda(p, ell, HUBER_PX), split=True)
        if "pt" in kinds[spec[0]]:
            res["ba_pt_rows"] = time_kernel(
                ba, lambda: ba.pt_rows_cuda(p, ell, HUBER_PX), split=True)
        out.append(res)
        del p, ell
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkout roots, timed in this order")
    ap.add_argument("--shapes", default="[]",
                    help="JSON list of [side, n_seg, n_rows, width], or a "
                         "file holding one (chip_smoke.py writes the main "
                         "path's to build/main_row_shapes.json)")
    ap.add_argument("--no_bench", action="store_true",
                    help="leave out bench.py's two problems")
    ap.add_argument("--out", default=None, help="write the results here")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(run_worker(json.loads(args.worker))), flush=True)
        return None
    specs = ([] if args.no_bench else [["bench", k] for k in BENCH_SIZES])
    shapes = args.shapes
    if os.path.isfile(shapes):
        with open(shapes) as f:
            shapes = f.read()
    specs += [list(s) for s in json.loads(shapes)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             json.dumps(specs)], cwd=root, env=env, capture_output=True,
            text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"worker for {tree} failed:\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"turn": i, "tree": tree, "results": res})
        for r in res:
            for k in ("ba_cam_rows", "ba_pt_rows"):
                if k in r:
                    t = r[k]
                    shape = r["cam_shape" if k == "ba_cam_rows"
                              else "pt_shape"]
                    print(f"turn {i} {tree} {k} {r['spec']} {shape}: raw "
                          f"{t['raw_queued_ms']:.5f} ms queued, "
                          f"{t['raw_ms']:.5f} single; wrapper "
                          f"{t['wrapper_queued_ms']:.5f} queued, "
                          f"{t['wrapper_ms']:.5f} single, "
                          f"{t['wrapper_ops']:g} device operations, "
                          f"{t['launches']} launcher calls; by kernel "
                          f"{json.dumps(t['kernels_ms'])}", flush=True)
    result = {"device": smi, "specs": specs, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
