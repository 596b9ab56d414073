"""The global-BA cell (bal-dubrovnik356.gba, drivers/gba.py) on the CPU at
a cut size (120 cameras, 4,000 points, 22,000 observations, D = 14): a
sound run reads `correct`; each planted fault of lib/faults.py, a solve
that stalls (solve_ba handing back its state after its first accepted
step) and the control (the plain reference in TF32) fail a limit; and the
check judges the window's first and last outputs whatever their count."""

import dataclasses
import json

import pytest
import torch

from perfbench import calibrate_gba
from perfbench.lib import faults, harness, spec

torch.set_num_threads(2)

CELL = "bal-dubrovnik356.gba"
CUT = dict(n_cameras=120, n_points=4000, n_observations=22000)
SEED = 2147483713


def run(capsys):
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                       "0.1", "--trace", "0"], device="cpu",
                      config_overrides=CUT)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _stalled(solve_ba):
    """solve_ba that hands back its state after the first accepted step."""
    def solve(p, opts, ell=None):
        for n in range(1, opts.max_iters + 1):
            sol, info = solve_ba(p, dataclasses.replace(opts, max_iters=n),
                                 ell)
            if info["accepts"]:
                break
        return sol, info
    return solve


def test_sound_run_is_correct(capsys):
    res = run(capsys)
    assert res["correct"] is True
    assert set(res["checks"]) == {"cost_gap", "cost_report_gap",
                                  "units_failed"}


@pytest.mark.parametrize("fault", faults.FAULTS + ("stalled",))
def test_fault_is_caught(capsys, monkeypatch, fault):
    if fault == "stalled":
        from xrsfm_tpu_torch.optim import ba as BA

        monkeypatch.setattr(BA, "solve_ba", _stalled(BA.solve_ba))
    else:
        faults.inject("ba", fault, monkeypatch.setattr)
    assert run(capsys)["correct"] is False


def test_control_fails_a_limit(tmp_path):
    cell = spec.Cell(CELL)
    Driver = spec.driver_class(cell.traffic["driver"])
    limits = cell.limits["numbers"]
    nums = {}
    for mode in ("program", "control"):
        drv = Driver(cell, dict(cell.config, **CUT), SEED, "cpu",
                     str(tmp_path))
        drv.setup()
        got, _ = calibrate_gba.numbers(drv, mode)
        nums[mode] = [n for n, v in got.items()
                      if n in limits and not v <= limits[n]["limit"]]
    assert nums["control"] and not nums["program"]


def test_check_judges_first_and_last_output(tmp_path):
    """Of a window's outputs the driver keeps the first and the last, and
    its record counts the accepted steps."""
    cell = spec.Cell(CELL)
    drv = spec.driver_class("gba")(
        cell, dict(cell.config, n_cameras=20, n_points=600,
                   n_observations=3000), SEED, "cpu", str(tmp_path))
    drv.setup()
    recs = [drv.unit() for _ in range(3)]
    assert len(drv.outputs) == 2
    assert all(0 < r["lm_accepts"] <= r["lm_iters"] for r in recs)
    assert recs[0]["shape"]["D"] == 14
