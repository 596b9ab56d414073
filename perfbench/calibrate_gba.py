"""Readings from which a global-BA cell's limits are set (calibrate.py's
twin for the gba driver): the numbers its check compares, on many seeds,
for the program, the control and the planted faults.  Not run by the
benchmark's runs.

  python3 perfbench/calibrate_gba.py --workload <name> --seeds 1,2,3 \\
      --mode program|control|fault:<name>

mode program: per seed, one solve of the whole problem by the program,
  judged as the check judges the window's outputs (drivers/gba.py).
mode control: the plain reference solve computed in float32 with TF32
  operands (reference/ba.py, control=True) in the program's place, its
  own float32 cost the reported one (as calibrate.py's control).
mode fault:<name>: the program with one of lib/faults.py's faults planted.

Prints one JSON line per seed: {"seed", "mode", "numbers", "seconds"}, and
for the program its LM iterations and accepted candidates.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

if __name__ == "__main__":  # the checkout's root heads the import path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench.lib import faults, harness, spec  # noqa: E402


def numbers(drv, mode: str) -> dict:
    """The judged numbers of one seed's driver (set up) under `mode`, and
    the program's unit record (None for the control)."""
    if mode == "control":
        from perfbench.reference import ba as ref

        o = drv.tr["options"]
        s, own_cost, _ = ref.solve(
            drv.problems[0], drv.dev,
            optimize_intrinsics=o["optimize_intrinsics"],
            huber_px=o["huber_px"], max_iters=o["max_iters"], control=True)
        return drv.judge([(0, s.to_numpy(), own_cost)]), None
    patch = faults.Patch()
    try:
        if mode.startswith("fault:"):
            faults.inject("ba", mode[6:], patch)
        rec = drv._solve(0)
    finally:
        patch.undo()
    return drv.judge(drv.outputs), rec


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    help="program, control or fault:<name>")
    a = ap.parse_args(argv)
    cell = spec.Cell(a.workload)
    import torch

    dev = torch.device(device or "cuda:0")
    Driver = spec.driver_class(cell.traffic["driver"])
    for seed in [int(s) for s in a.seeds.split(",")]:
        ws = tempfile.mkdtemp(prefix="perfbench-cal-")
        t0 = time.perf_counter()
        try:
            with harness.quiet():
                drv = Driver(cell, cell.config, seed, dev, ws)
                drv.setup()
                nums, rec = numbers(drv, a.mode)
        finally:
            shutil.rmtree(ws, ignore_errors=True)
        line = {"seed": seed, "mode": a.mode, "numbers": nums,
                "seconds": time.perf_counter() - t0}
        if rec is not None:
            line.update(lm_iters=rec["lm_iters"],
                        lm_accepts=rec.get("lm_accepts"))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
