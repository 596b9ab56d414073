"""The command on the card: a short window of the local-BA cell prints one
correct result line for the card it ran on.  Needs a CUDA device (marker
cuda); skips elsewhere."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "bal-dubrovnik356.lba", "--seed", "2147483716", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert set(res["metrics"]) == {"ba_solve_s", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"
