"""A run with the timed path broken underneath reads `correct` false: once
for each fault a cell can have (lib/faults.py: a step that returns its
state unchanged, half of the work left out, an answer altered where it is
produced; no cell spans chips).  The runs skip the look for a card and go
through the harness on the CPU at a size a test can hold; a sound run of
each cell reads `correct` true."""

import json

import pytest
import torch

from perfbench.lib import faults, harness

torch.set_num_threads(2)

SMALL = {"bal-dubrovnik356.lba": dict(n_cameras=30, n_points=2000,
                                      n_observations=11073),
         "kitti-corridor48.pipeline": dict(n_frames=16, width=512, height=384,
                                           focal_px=450.0, cx=256.0,
                                           cy=192.0)}
DRIVER = {"bal-dubrovnik356.lba": "ba", "kitti-corridor48.pipeline": "pipeline"}


def run(capsys, cell, seed=2147483713):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.1", "--trace", "0"], device="cpu",
                      config_overrides=SMALL[cell])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(capsys, cell):
    assert run(capsys, cell)["correct"] is True


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_caught(capsys, monkeypatch, cell, fault):
    faults.inject(DRIVER[cell], fault, monkeypatch.setattr)
    assert run(capsys, cell)["correct"] is False
