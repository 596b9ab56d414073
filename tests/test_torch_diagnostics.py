"""The circuit diagnostics' twins (xrsfm_tpu_torch.tools.exp_circuit and
.exp_edge_bias) against scripts/exp_circuit.py and exp_edge_bias.py: the
argument sets, the printed lines and JSON keys, the snapshot's
compatibility with the JAX package, the rotation-frozen settle, and the
per-edge measurement, on a small kitti-class circuit on the CPU.  A
250-frame run of both packages is in the slow tier."""

import ast
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from xrsfm_tpu_torch.tools import exp_circuit, exp_edge_bias
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 40  # exp_circuit's circuit
N_LOOP = 80  # exp_edge_bias's: the smallest circuit with loop-closure pairs
FLOAT = r"-?\d+\.\d+"


def _usage(help_text):
    """({option: metavar or choices, or ''}, [positionals]) from the usage
    paragraph of an argparse --help text."""
    u = " ".join(help_text.split("\n\n")[0].split()).split(" ", 2)[2]
    opts = dict(re.findall(r"\[(--?\w+)(?: ([^\]]+))?\]", u))
    return opts, re.sub(r"\[[^\]]*\]", "", u).split()


def _script_help(name):
    return subprocess.run([sys.executable, os.path.join("scripts", name),
                           "--help"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, check=True).stdout


def _tool_help(mod):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        mod.main(["--help"])
    return buf.getvalue()


@pytest.mark.parametrize("script,mod,extra", [
    ("exp_circuit.py", exp_circuit, {"--device"}),
    # the script's docstring names --seq_only, its parser lacks it
    ("exp_edge_bias.py", exp_edge_bias, {"--device", "--seq_only"}),
])
def test_tool_arguments_match_scripts(script, mod, extra):
    """The tool takes the script's positionals, options and choices, plus
    --device (default cuda) and, for exp_edge_bias, --seq_only; without
    a GPU the default device raises."""
    want, want_pos = _usage(_script_help(script))
    got, got_pos = _usage(_tool_help(mod))
    assert got_pos == want_pos
    assert set(got) == set(want) | extra, (sorted(got), sorted(want))
    for k, meta in want.items():
        assert got[k] == meta, k
    with pytest.raises(RuntimeError):
        mod.main(["ws"] if mod is exp_edge_bias else ["prep", "ws"])


@pytest.fixture(scope="module")
def circuit(tmp_path_factory):
    """The 40-frame circuit (seed 3), prep run on the CPU: (workspace,
    printed text, returned figures)."""
    ws = str(tmp_path_factory.mktemp("circuit") / "ws")
    synth.write_kitti_workspace(ws, N_FRAMES, 3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = exp_circuit.main(["prep", ws, "--device", "cpu"])
    return ws, buf.getvalue(), res


@pytest.fixture(scope="module")
def jax_map(circuit):
    """The JAX package's map of the circuit's workspace (built once)."""
    from xrsfm_tpu.pipelines.run_reconstruction import build_map

    ws = circuit[0]
    return build_map(ws, os.path.join(ws, "camera.txt"))


def test_exp_circuit_prep_writes_a_jax_snapshot(circuit, jax_map):
    """prep's last line has the script's format (scripts/exp_circuit.py
    :279-280), at least 90% of the frames register, and the JAX package
    restores drifted.npz into its own map with the same registered frames
    and poses."""
    from xrsfm_tpu.base import snapshot as JSNAP

    ws, text, (n_reg, ate_pct, _) = circuit
    last = text.strip().splitlines()[-1]
    assert re.fullmatch(rf"prep: \d+ reg, ATE {FLOAT} \({FLOAT}% of span\), "
                        r"\d+s", last), last
    assert n_reg >= 0.9 * N_FRAMES and np.isfinite(ate_pct)
    mj = copy.deepcopy(jax_map)
    JSNAP.restore_into(mj, os.path.join(ws, "drifted.npz"))
    mt = exp_circuit._load(ws, "drifted.npz")
    np.testing.assert_array_equal(np.asarray(mj.registered), mt.registered)
    np.testing.assert_array_equal(np.asarray(mj.q), mt.q)
    np.testing.assert_array_equal(np.asarray(mj.t), mt.t)


def test_exp_circuit_decompose_prints_the_scripts_lines(circuit, jax_map,
                                                       monkeypatch):
    """decompose on the snapshot prints the script's lines character for
    character, and writes the same decompose.npz arrays (the script's map
    is the JAX package's, built once)."""
    import importlib.util

    from xrsfm_tpu.pipelines import run_reconstruction as JRR

    monkeypatch.setattr(JRR, "build_map",
                        lambda *a, **k: copy.deepcopy(jax_map))
    spec = importlib.util.spec_from_file_location(
        "exp_circuit_script", os.path.join(REPO, "scripts", "exp_circuit.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    ws = circuit[0]
    out = {}
    for name, fn in (("jax", script.decompose),
                     ("port", exp_circuit.decompose)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(ws, "drifted.npz")
        out[name] = (buf.getvalue(), dict(np.load(
            os.path.join(ws, "decompose.npz"))))
    assert out["port"][0] == out["jax"][0]
    for k, v in out["jax"][1].items():
        np.testing.assert_array_equal(out["port"][1][k], v, err_msg=k)


def test_exp_circuit_rot_frozen_round(circuit):
    """exp --rounds 1 --rot_freeze: the script's lines (scripts/
    exp_circuit.py:309-358); the rotation-frozen GBA keeps every
    quaternion of the map bit for bit and does not raise the cost; the
    round ends with a finite ATE."""
    ws = circuit[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rounds = exp_circuit.main(["exp", ws, "--rounds", "1", "--rot_freeze",
                                   "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert re.fullmatch(rf"start: \d+ reg, ATE {FLOAT}%", lines[0]), lines[0]
    pats = [rf"round 0: polish rewrote=(True|False), ATE {FLOAT}% \(\d+s\)"]
    (rec,) = rounds
    if rec["rewrote"]:
        pats += [rf"  GBA rot-frozen: {FLOAT} -> {FLOAT}",
                 rf"  after rot-frozen settle: ATE {FLOAT}%",
                 rf"  GBA: {FLOAT} -> {FLOAT}", rf"  GBA: {FLOAT} -> {FLOAT}",
                 rf"  GBA final: {FLOAT} -> {FLOAT}",
                 rf"round 0: after GBA, ATE {FLOAT}% \(\d+s total\)"]
    rest = [ln for ln in lines[1:] if not ln.startswith("  ")
            or re.match(r"  (GBA|after)", ln)]
    assert len(rest) == len(pats), rest
    for p, ln in zip(pats, rest):
        assert re.fullmatch(p, ln), (p, ln)
    assert rec["rewrote"], "the polish did not rewrite the 40-frame circuit"
    rf = rec["rot_frozen"]
    assert rf["q_kept"] and rf["final"] <= rf["initial"]
    assert np.isfinite(rec["ate"])


def _script_json_keys(name):
    """The keys of the dict literal that the script's json.dumps prints."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", name)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args and isinstance(node.args[0],
                                                        ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps of a dict literal")


def test_exp_edge_bias_seq_only(tmp_path):
    """--seq_only on the 80-frame circuit, written by the tool itself (2
    IRLS iterations to keep the test short): the JSON line has the
    script's keys in its order (scripts/exp_edge_bias.py:190-201); every
    sequential pair with at least 60 matches is measured and no loop
    closure; every error is finite and the medians lie under a degree."""
    ws = str(tmp_path / "ws")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = exp_edge_bias.main([ws, "--n_frames", str(N_LOOP), "--iters",
                                  "2", "--seq_only", "--device", "cpu"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == _script_json_keys("exp_edge_bias.py")
    m = exp_circuit._load(ws, "")
    seq = [(i, j) for i, j, mt in m.pairs
           if len(mt) >= exp_edge_bias.MIN_MATCHES
           and abs(j - i) <= synth.SEQ_WINDOW]
    loops = [(i, j) for i, j, _ in m.pairs if abs(j - i) > 50]
    assert loops, "the circuit has no loop-closure pairs"
    assert res["edges"] == seq and line["pairs"] == len(seq) > 0
    assert len(res["errs_raw"]) == len(seq)
    assert np.isfinite(res["errs_raw"]).all()
    assert np.isfinite(res["errs_clean"]).all()
    assert 0.0 < line["contamination_mean"] < 0.1
    assert line["raw_med_deg"] < 1.0 and line["clean_med_deg"] < 1.0


@pytest.mark.slow
def test_circuit_tools_at_250_frames_against_jax(tmp_path):
    """Both packages' diagnostics on the 250-frame circuit (seed 3; tens of
    minutes on a CPU): prep registers at least 238 frames in each, the
    port's un-polished ATE under tests/test_scale.py's 1.5%; the port's
    rotation-frozen round keeps every quaternion and lowers the cost; and
    exp_edge_bias --seq_only's median per-edge errors, raw and clean, at
    most 1.25x the JAX script's on the same pairs.  The scripts run through
    tests/diag_reference.py, which keeps exp_circuit's persistent
    compilation cache off."""
    ws_j, ws_t = str(tmp_path / "jax"), str(tmp_path / "port")
    synth.write_kitti_workspace(ws_t, 250, 3)
    synth.write_kitti_workspace(ws_j, 250, 3)
    out = subprocess.run([sys.executable, "tests/diag_reference.py",
                          "circuit", "prep", ws_j], cwd=REPO,
                         capture_output=True, text=True, timeout=3600,
                         check=True).stdout
    n_j = int(re.search(r"prep: (\d+) reg", out).group(1))
    out = subprocess.run([sys.executable, "tests/diag_reference.py",
                          "edge_bias", ws_j, "--seq_only"], cwd=REPO,
                         capture_output=True, text=True, timeout=3600,
                         check=True).stdout
    edge_j = json.loads(out.strip().splitlines()[-1])
    n_t, ate_t, _ = exp_circuit.main(["prep", ws_t, "--device", "cpu"])
    assert n_j >= 238 and n_t >= 238 and ate_t < 1.5, (n_j, n_t, ate_t)
    (rec,) = exp_circuit.main(["exp", ws_t, "--rounds", "1", "--rot_freeze",
                               "--device", "cpu"])
    rf = rec["rot_frozen"]
    assert rf["q_kept"] and rf["final"] <= rf["initial"]
    edge_t = exp_edge_bias.main([ws_t, "--seq_only", "--device", "cpu"])
    assert edge_t["pairs"] == edge_j["pairs"]
    assert edge_t["raw_med_deg"] <= 1.25 * edge_j["raw_med_deg"]
    assert edge_t["clean_med_deg"] <= 1.25 * edge_j["clean_med_deg"]
