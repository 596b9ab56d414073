"""The port's unordered regime at the reference's scale, on the CPU (slow
tier): tests/test_unordered_scale.py's two gates held against
xrsfm_tpu_torch.tools.run_unordered_bench.

1. Matching separation on the street tour at 85% junk (300 genuine + 1,700
   distractor frames, matching only): precision >= 0.95 in both arms,
   covisibility proposals <= 0.33x retrieval's, wall <= 0.45x, verified
   pairs >= 0.95x.
2. Reconstruction on the landmark ring at 500 + 500 (covisibility-matched
   pairs through rec_1dsfm): precision >= 0.95, >= 90% registered, ATE <
   0.5% of the span, median focal error < 1%.

Each runs the tool in a fresh process with --device cpu; the card runs
gate 1 in chip_smoke.py phase 18 and gate 2 in phase 11.  Slow: tens of
minutes each on a CPU host.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout):
    proc = subprocess.run(
        [sys.executable, "-m", "xrsfm_tpu_torch.tools.run_unordered_bench",
         "--device", "cpu"] + args,
        cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (
        f"unordered bench failed (rc={proc.returncode})\n"
        f"stdout tail:\n{proc.stdout[-3000:]}\n"
        f"stderr tail:\n{proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


@pytest.mark.slow
def test_port_unordered_matching_separation(tmp_path):
    r = _run(["--scene", "tour", "--n_frames", "300", "--distractors", "1700",
              "--matching_only", "--workdir", str(tmp_path / "ub")],
             timeout=7200)
    ret = r["matching"]["retrieval"]
    cov = r["matching"]["covisibility"]
    print(json.dumps(r))  # the arms' splits, shown by pytest -rA
    for mtype, mm in (("retrieval", ret), ("covisibility", cov)):
        assert mm["precision"] >= 0.95, (mtype, mm)
    assert cov["pairs_proposed"] <= 0.33 * ret["pairs_proposed"], (cov, ret)
    assert cov["wall_s"] <= 0.45 * ret["wall_s"], (cov, ret)
    assert cov["verified_pairs"] >= 0.95 * ret["verified_pairs"], (cov, ret)


@pytest.mark.slow
def test_port_unordered_reference_scale_reconstruction(tmp_path):
    r = _run(["--n_frames", "500", "--distractors", "500",
              "--strategies", "covisibility",
              "--workdir", str(tmp_path / "ub")],
             timeout=10800)
    cov = r["matching"]["covisibility"]
    assert cov["precision"] >= 0.95, cov
    rec = r["reconstruction"]
    assert rec["registered"] >= 0.90 * r["frames"], rec
    assert rec["ate_pct_span"] < 0.5, rec
    assert rec["focal_med_err"] < 0.01, rec
