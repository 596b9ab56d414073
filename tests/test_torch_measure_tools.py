"""The port's measurement tools (xrsfm_tpu_torch/tools: run_unordered_bench,
profile_sift, profile_ba, dist_scaling, dist_multiprocess) on the CPU: the
unordered bench's counts against scripts/run_unordered_bench.py on the
same small street tour, the instruments' JSON keys at small sizes, the
multi-process parity through Gloo, and initialize_distributed's default
device."""

import contextlib
import importlib.util
import io
import json
import math
import os

import pytest
import torch

import xrsfm_tpu
from xrsfm_tpu_torch.parallel import mesh as TMESH
from xrsfm_tpu_torch.tools import dist_multiprocess, dist_scaling
from xrsfm_tpu_torch.tools import profile_ba, profile_sift
from xrsfm_tpu_torch.tools import run_unordered_bench as TUB

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a street tour small enough for tier 1: 12 genuine frames (half a facade
# run) and 24 junk frames, where top-25 retrieval proposes 536 pairs and
# the expansion 129
TOUR = ["--scene", "tour", "--n_frames", "12", "--distractors", "24",
        "--seed", "1", "--matching_only"]
COUNTED = ("pairs_proposed", "verified_pairs", "precision", "recall")


@pytest.fixture(scope="module")
def tour_runs(tmp_path_factory):
    """(port's result, JAX script's result) on one tour: both arms each."""
    root = tmp_path_factory.mktemp("tour")
    with contextlib.redirect_stdout(io.StringIO()):
        port = TUB.main(TOUR + ["--workdir", str(root / "port"),
                                "--device", "cpu"])
    spec = importlib.util.spec_from_file_location(
        "scripts_run_unordered_bench",
        os.path.join(REPO, "scripts", "run_unordered_bench.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        # the JAX backend is already on the CPU (tests/conftest.py); keep
        # the script's persistent compilation cache out of the test
        mp.setattr(xrsfm_tpu, "enable_compilation_cache", lambda: None)
        mp.setattr("sys.argv", ["run_unordered_bench.py"] + TOUR
                   + ["--workdir", str(root / "jax")])
        script.main()
    line = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return port, json.loads(line[-1])


@pytest.mark.parametrize("arm", ["retrieval", "covisibility"])
def test_unordered_bench_counts_equal_script(tour_runs, arm):
    """The port's proposals, verified pairs, precision and recall equal the
    JAX script's on the same bytes, and so does the ground-truth count;
    the stage split adds up and the matcher ran its plain version."""
    port, ref = tour_runs
    assert port["gt_pairs"] == ref["gt_pairs"] > 0
    assert port["frames"] == ref["frames"]
    assert port["distractors"] == ref["distractors"]
    p, r = port["matching"][arm], ref["matching"][arm]
    assert {k: p[k] for k in COUNTED} == {k: r[k] for k in COUNTED}
    assert p["precision"] >= 0.95
    split = p["retrieval_s"] + p["search_s"] + p["match_s"]
    assert 0 < split <= p["wall_s"] + 0.1
    assert (arm == "retrieval") == (p["search_s"] == 0.0)
    assert p["topstats_launches"]["topstats_cuda"] == 0
    assert p["topstats_launches"]["topstats_plain"] > 0
    assert port["expansion_speedup"] > 0


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def _sift():
    out = profile_sift.main(["--size", "64,96", "--batch", "2", "--pools",
                             "128,256", "--reps", "1", "--device", "cpu"])
    assert out["size"] == [64, 96] and out["batch"] == 2
    assert [p["pool"] for p in out["points"]] == [128, 256]
    for p in out["points"]:
        assert all(_finite(p[k]) for k in ("images_per_s", "s_per_batch",
                                           "keypoints"))
        assert p["keypoints"] > 0
    assert _finite(out["us_per_slot_per_image"])
    assert _finite(out["fixed_s_per_image"])
    assert profile_sift.pool_slots(1024) == 1024 + 512 + 256 + 128


def _ba():
    out = profile_ba.main(["--cams", "20", "--pts", "500", "--iters", "2",
                           "--device", "cpu"])
    keys = ["residuals_ms", "cam_rows_ms", "pt_native_ms", "jac_normal_ms",
            "schur_setup_ms", "per_cg_iter_ms", "schur_setup_apply_ms",
            "iters_per_s_cg4"] + \
        [f"full_cg{k}_ms" for k in profile_ba.CG_KS]
    assert all(_finite(out[k]) for k in keys), out
    assert out["n_obs"] > 0
    # nothing launches on the CPU
    assert out["launches"] == dict.fromkeys(
        ["residuals", "cam_rows", "pt_native", "jac_normal", "schur_setup"]
        + [f"full_cg{k}" for k in profile_ba.CG_KS])


def _scaling():
    out = dist_scaling.main(["--cams", "20", "--pts", "1000", "--iters", "3",
                             "--device", "cpu"])
    assert sorted(out) == ["1", "2", "4", "8"]
    costs = [out[n]["final_cost"] for n in out]
    for n, rec in out.items():
        assert rec["n_devices"] == int(n)
        assert all(_finite(rec[k]) for k in ("iters_per_s", "final_cost",
                                             "n_obs"))
    assert max(costs) - min(costs) <= 0.01 * min(costs)


@pytest.mark.parametrize("check", [_sift, _ba, _scaling],
                         ids=["profile_sift", "profile_ba", "dist_scaling"])
def test_instrument_json_keys_finite(check, capsys):
    """The scripts' JSON keys are present and finite at small sizes on the
    CPU, and each tool prints its record as its last line."""
    check()
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_dist_multiprocess_two_gloo_processes(tmp_path, capsys):
    """Two Gloo processes of 4 CPU shards each against one process of 8:
    the parity record is ok (the sums fold in shard order: equal costs)."""
    out = dist_multiprocess.main([
        "--procs", "2", "--device", "cpu", "--cams", "20", "--pts", "1000",
        "--iters", "3", "--workdir", str(tmp_path), "--timeout", "120"])
    assert out["ok"] and out["procs"] == 2 and out["n_obs"] > 0
    assert out["cost_multi"] == out["cost_single"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert os.listdir(tmp_path) == []  # the stores are removed


def test_initialize_distributed_defaults_to_cuda(tmp_path):
    """With an init_method and no device, initialize_distributed asks for
    NCCL on the card, which raises without a GPU; the one-process no-op
    touches no device."""
    if torch.cuda.is_available():
        pytest.skip("needs a CPU-only host")
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TMESH.initialize_distributed(f"file://{tmp_path / 'store'}", 2, 0)
    assert not dist.is_initialized()
    assert TMESH.initialize_distributed() == (1, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist_multiprocess.main(["--procs", "2", "--workdir", str(tmp_path)])
