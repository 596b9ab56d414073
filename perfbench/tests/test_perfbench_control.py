"""The control comes out not correct: the plain reference with TF32
operands (rounded to TF32's 10 mantissa bits in plain code, so on the CPU
too), one precision below the configuration's float32 with TF32 off, put
in the program's place fails at least one of the cell's limits, where the
program passes them.  In the image pipeline it takes the place of every
bundle adjustment the mapper runs; at a test's size it separates from the
program, and its failing readings come from the card."""

import torch

from perfbench import calibrate
from perfbench.lib import faults, harness, spec

torch.set_num_threads(2)
BAL_TEST = dict(n_cameras=120, n_points=4000, n_observations=22000)
SEQ_TEST = dict(n_frames=16, width=512, height=384, focal_px=450.0, cx=256.0,
                cy=192.0)


def _fails(cell, numbers):
    limits = cell.limits["numbers"]
    return [n for n, v in numbers.items() if n in limits
            and not v <= limits[n]["limit"]]


def test_ba_control_fails_a_limit(tmp_path):
    cell = spec.Cell("bal-dubrovnik356.lba")
    Driver = spec.driver_class(cell.traffic["driver"])
    drv = Driver(cell, dict(cell.config, **BAL_TEST), 2147483714, "cpu",
                 str(tmp_path))
    drv.setup()
    assert _fails(cell, calibrate.ba_numbers(drv, control=True))
    assert not _fails(cell, calibrate.ba_numbers(drv, control=False))


def _pipeline_numbers(cell, ws, control):
    Driver = spec.driver_class(cell.traffic["driver"])
    patch = faults.Patch()
    try:
        with harness.quiet():
            drv = Driver(cell, dict(cell.config, **SEQ_TEST), 2147483713,
                         "cpu", ws)
            drv.setup()
            if control:
                calibrate.reference_ba_in_tf32(patch)
            return drv.check([drv.unit()])
    finally:
        patch.undo()


def test_pipeline_control_separates(tmp_path):
    """At a test's size (16 frames at 512x384) the control's cost_gap is
    far below the cell's limit, which its readings at the cell's size
    on the card pass (limits/<cell>.json); here it reads over ten times
    the program's, which passes every limit."""
    cell = spec.Cell("kitti-corridor48.pipeline")
    ctl = _pipeline_numbers(cell, str(tmp_path / "c"), True)
    prog = _pipeline_numbers(cell, str(tmp_path / "p"), False)
    assert not _fails(cell, prog)
    assert ctl["cost_gap"] > 10 * prog["cost_gap"]
