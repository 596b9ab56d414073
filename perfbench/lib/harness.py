"""The benchmark's run: one cell, one seed, one window.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                           --trace <0|1>

1. Looks up the cell in BENCHMARK.json, its configuration, traffic mix and
   limits (lib/spec.py), and fails without as many CUDA devices as the cell
   asks for.
2. Set-up: the traffic mix's driver makes the inputs from the seed under
   $TMPDIR, and warms up on the cell's own shapes.  setup_s runs from the
   process's start to the first timed unit.
3. The window: units of work back to back until --seconds have passed; the
   unit running at that moment is finished and counted.
4. With --trace 1, one more unit runs after the window inside
   torch.profiler: the device metrics and the breakdown come from it, the
   host-clock per-layer metrics from the untraced window.
5. The peak of device memory is read, the program's state freed, and the
   driver's check compares the window's outputs with the plain reference:
   each number beside its limit (limits/<workload>.json).
6. Stops with no result if jax, jaxlib, flax or the JAX package was
   loaded; otherwise prints the check lines last on stderr and the
   result's JSON line last on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import spec, tracing

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "xrsfm_tpu"})


def process_age_s() -> float:
    """Seconds since this process started, from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def cpu_times() -> tuple:
    """(all, steal) jiffies of the machine's CPUs, from /proc/stat."""
    with open("/proc/stat") as f:
        v = [int(x) for x in f.readline().split()[1:]]
    return sum(v[:8]), v[7] if len(v) > 7 else 0


def host_line(before: tuple) -> str:
    """What the host did over the window: the share of CPU time the
    hypervisor stole, and the load average."""
    after = cpu_times()
    total = max(after[0] - before[0], 1)
    with open("/proc/loadavg") as f:
        load = " ".join(f.read().split()[:3])
    return (f"steal {100.0 * (after[1] - before[1]) / total:.2f}% of CPU "
            f"time, load average {load}")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load, compared
    whole (xrsfm_tpu_torch is not xrsfm_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@contextlib.contextmanager
def quiet():
    """The program's printing goes nowhere: the result line is the last
    line of standard output."""
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


class Run:
    """What the metric readers read: the window's unit records, its
    seconds, set-up seconds, the peak of device memory, and with --trace 1
    the traced unit's record and Trace."""

    def __init__(self, cell, units, window_s, setup_s, memory_peak_bytes,
                 trace=None, trace_unit=None):
        self.cell = cell
        self.units = units
        self.window_s = window_s
        self.setup_s = setup_s
        self.memory_peak_bytes = memory_peak_bytes
        self.trace = trace
        self.trace_unit = trace_unit


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, config_overrides=None) -> int:
    """Run one cell; returns the exit code.  device and config_overrides
    are for the benchmark's own CPU tests: they skip the look for a chip
    and shrink the configuration."""
    args = parse(argv)
    cell = spec.Cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
                  f"device(s), found {n}", file=sys.stderr)
            return 2
        device = torch.device("cuda:0")
    device = torch.device(device)
    on_card = device.type == "cuda"
    config = dict(cell.config, **(config_overrides or {}))
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        return _run(args, cell, config, device, on_card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, cell, config, device, on_card, workdir) -> int:
    import torch

    if on_card:
        print(f"perfbench: card {card_line()}", file=sys.stderr, flush=True)
    Driver = spec.driver_class(cell.traffic["driver"])
    drv = Driver(cell, config, args.seed, device, workdir)
    t0 = time.perf_counter()
    with quiet():
        drv.setup()
    t1 = time.perf_counter()
    with quiet():
        drv.warm()
    setup_s = process_age_s()
    print(f"perfbench: set-up {setup_s:.2f} s: inputs {t1 - t0:.2f} s, warm-up "
          f"{time.perf_counter() - t1:.2f} s", file=sys.stderr, flush=True)

    units = []
    host0 = cpu_times()
    t0 = time.perf_counter()
    while True:
        with quiet():
            units.append(drv.unit())
        if time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    work = {k: sum(u[k] for u in units) for k in ("lm_iters", "cg_iters")
            if all(k in u for u in units)}
    print(f"perfbench: window {host_line(host0)}; work {work}",
          file=sys.stderr, flush=True)

    trace = trace_unit = None
    if args.trace:
        with quiet():
            trace_unit, trace = tracing.capture(drv.unit, device)
    mem = torch.cuda.max_memory_allocated(device) if on_card else None

    drv.release()
    t0 = time.perf_counter()
    with quiet():
        readings = drv.check(units)
    print(f"perfbench: {len(units)} units in {window_s:.2f} s (each "
          f"{', '.join(f'{u['seconds']:.3f}' for u in units[:40])}); check "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    limits = cell.limits.get("numbers", {})
    checks = {}
    correct = True
    for name, value in readings.items():
        if name not in limits:  # read for the record, not compared
            print(f"perfbench: reading {name} {value!r} (not compared)",
                  file=sys.stderr)
            continue
        limit = limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            correct = False
    if set(limits) - set(readings):
        correct = False  # a number the limits name was not read
    failed = sum(1 for u in units if u.get("failed"))
    checks["units_failed"] = {"value": failed, "limit": 0}
    correct = correct and failed == 0

    run = Run(cell, units, window_s, setup_s, mem, trace, trace_unit)
    metrics = {}
    for m in cell.metrics(per_layer=bool(args.trace)):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": mem}
    result = {"correct": correct, "attempted": len(units), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr, flush=True)
        return 3
    for name, c in checks.items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
