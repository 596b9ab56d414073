"""Readings from which a cell's limits are set: the numbers its check
compares, on many seeds, for the program and for the control.  Not run by
the benchmark's runs.

  python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
      --mode program|control

mode program: per seed, the cell's inputs and one unit of the program at
  the cell's own size (a bundle-adjustment cell: every problem its check
  would sample), judged as the check judges them.
mode control: the same inputs, with the control in the program's place:
  the plain reference solve computed in float32 with TF32 operands
  (reference/ba.py, control=True), the precision just below the
  configuration's float32 with TF32 off.  In a ba cell it replaces the
  program's solve; in the pipeline it replaces every bundle adjustment the
  mapper runs (mapper/ba_glue's solve_ba), the rest of the pipeline being
  the program's.
mode fault:<name>: the program with one of lib/faults.py's faults planted
  (unchanged, half_left_out, answer_altered), judged as the program is.

Prints one JSON line per seed: {"seed", "mode", "numbers"}; the lines go
to stdout, the program's own printing is dropped.
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


def reference_ba_in_tf32(setattr_):
    """Every bundle adjustment of the mapper solved by the plain reference
    in its TF32 form instead of the program's solve_ba."""
    import dataclasses

    import torch
    from xrsfm_tpu_torch.mapper import ba_glue

    from perfbench.reference import ba as ref

    def solve(p, opts, ell=None):
        arrays = {f.name: getattr(p, f.name).cpu().numpy()
                  for f in dataclasses.fields(p)
                  if getattr(p, f.name) is not None}
        s, cost, it = ref.solve(
            arrays, p.cam_q.device,
            optimize_intrinsics=opts.optimize_intrinsics,
            huber_px=opts.huber_px, max_iters=opts.max_iters, control=True)
        out = s.to_numpy()
        sol = dataclasses.replace(p, **{
            k: torch.as_tensor(out[k], dtype=torch.float32,
                               device=p.cam_q.device)
            for k in ("cam_q", "cam_t", "cam_intri", "points")})
        return sol, {"initial_cost": cost, "final_cost": cost, "iters": it,
                     "lam": 0.0}

    setattr_(ba_glue, "solve_ba", solve)


def ba_numbers(drv, control: bool) -> dict:
    """Every problem the cell's check samples, solved by the program or
    the control, compared with the reference."""
    import numpy as np

    ks = sorted(set(drv.order[:drv.tr["check_solves"]]))
    worst = {}
    for k in ks:
        ref_state, ref_cost = drv.reference(k)
        if control:
            from perfbench.reference import ba as ref

            o = drv.tr["options"]
            s, own_cost, _ = ref.solve(
                drv.problems[k], drv.dev,
                optimize_intrinsics=o["optimize_intrinsics"],
                huber_px=o["huber_px"], max_iters=o["max_iters"],
                control=True)
            state, reported = s.to_numpy(), own_cost
        else:
            drv.outputs.clear()
            drv._solve(k)
            _, state, reported = drv.outputs[-1]
        for name, v in drv.compare(k, state, reported, ref_state,
                                   ref_cost).items():
            worst[name] = max(worst.get(name, -np.inf), v)
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    help="program, control or fault:<name>")
    a = ap.parse_args(argv)
    cell = spec.Cell(a.workload)
    import torch

    dev = torch.device("cuda:0")
    Driver = spec.driver_class(cell.traffic["driver"])
    for seed in [int(s) for s in a.seeds.split(",")]:
        ws = tempfile.mkdtemp(prefix="perfbench-cal-")
        t0 = time.perf_counter()
        patch = faults.Patch()
        try:
            with harness.quiet():
                drv = Driver(cell, cell.config, seed, dev, ws)
                drv.setup()
                if a.mode == "control" and cell.traffic["driver"] != "ba":
                    reference_ba_in_tf32(patch)
                elif a.mode.startswith("fault:"):
                    faults.inject(cell.traffic["driver"], a.mode[6:], patch)
                if cell.traffic["driver"] == "ba":
                    nums = ba_numbers(drv, a.mode == "control")
                else:
                    rec = drv.unit()
                    nums = drv.check([rec])
        finally:
            patch.undo()
            shutil.rmtree(ws, ignore_errors=True)
        print(json.dumps({"seed": seed, "mode": a.mode, "numbers": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
