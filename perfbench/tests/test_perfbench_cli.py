"""The command without a card, and in a directory that holds only the
benchmark: it exits with an error and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CELLS = ["kitti-corridor48.pipeline", "bal-dubrovnik356.lba"]


@pytest.mark.parametrize("cell", CELLS)
def test_fails_without_a_card(cell):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483712", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_fails_without_the_program(tmp_path):
    """Only BENCHMARK.json and perfbench/: the run cannot import the
    program, so it fails before printing a result (on the CPU here, past
    the look for a card)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from perfbench.lib import harness; "
            "sys.exit(harness.main(['--workload', 'bal-dubrovnik356.lba', "
            "'--seed', '1', '--seconds', '1', '--trace', '0'], "
            "device='cpu'))")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "xrsfm_tpu_torch" in out.stderr
