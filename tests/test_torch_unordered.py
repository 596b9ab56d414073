"""The port's unordered (1DSfM) slice as a whole on the CPU: the
workspace that utils/synth writes byte for byte as
scripts/synth_features.py does (landmark ring and street tour, with
distractor frames), and xrsfm_tpu_torch.pipelines.rec_1dsfm on the
landmark ring from its ground-truth pairs under the gates of
tests/test_unordered.py; the slow tier runs the JAX package's rec_1dsfm on
the same workspace in a subprocess and holds the port to it."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from xrsfm_tpu_torch import cli as TCLI
from xrsfm_tpu_torch.ops.umeyama import ate_rmse
from xrsfm_tpu_torch.optim import ba, global_pose, rot_avg
from xrsfm_tpu_torch.pipelines import rec_1dsfm
from xrsfm_tpu_torch.utils import geometry as G
from xrsfm_tpu_torch.utils import io_colmap as IOC
from xrsfm_tpu_torch.utils import io_features as IOF
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES, SEED = 32, 1
_FILES = ("ftr.bin", "size.bin", "fp.bin", "camera_info.txt",
          "gt_cameras.txt", "gt_poses.txt")


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The landmark ring at N_FRAMES frames, seed SEED, no distractors."""
    ws = str(tmp_path_factory.mktemp("ring") / "ws")
    synth.write_unordered_workspace(ws, "unordered", N_FRAMES, SEED)
    return ws


def _table(path, cols):
    out = {}
    with open(path) as f:
        for line in f:
            p = line.split()
            out[p[0]] = [float(p[c]) for c in cols]
    return out


def _evaluate(ws, m):
    """(registered, ATE % of span after sim(3) alignment, median relative
    focal error of the registered frames, the same for camera_info.txt's
    starting focals)."""
    gt = {}
    with open(os.path.join(ws, "gt_poses.txt")) as f:
        for line in f:
            p = line.split()
            gt[p[0]] = (np.array(p[1:5], float), np.array(p[5:8], float))
    gt_f = _table(os.path.join(ws, "gt_cameras.txt"), [1])
    start_f = _table(os.path.join(ws, "camera_info.txt"), [4])
    idx = np.nonzero(m.registered)[0]
    est = G.pose_center_np(m.q[idx], m.t[idx])
    ref = np.stack([G.pose_center_np(*gt[m.names[i]]) for i in idx])
    span = float(np.linalg.norm(ref.max(0) - ref.min(0)))
    ate = 100.0 * ate_rmse(ref, est) / span
    f = np.array([m.cameras[int(m.cam_of_frame[i])][0] for i in idx])
    f_gt = np.array([gt_f[m.names[i]][0] for i in idx])
    f0 = np.array([start_f[m.names[i]][0] for i in idx])
    return (len(idx), ate, float(np.median(np.abs(f - f_gt) / f_gt)),
            float(np.median(np.abs(f0 - f_gt) / f_gt)))


@pytest.mark.parametrize("scene,n_frames,distractors", [
    ("unordered", 24, 8),
    ("tour", 30, 5),
])
def test_synth_workspace_matches_scripts_bytes(tmp_path, scene, n_frames,
                                               distractors):
    """utils/synth.write_unordered_workspace writes the bytes of
    scripts/synth_features.main(scene, per_image_cameras=True,
    descriptors=True, distractors=...) for the same arguments, and returns
    per frame the scene point id of each keypoint (shared by the two ends
    of a ground-truth match)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import synth_features as sf
    finally:
        sys.path.pop(0)
    sf.main(str(tmp_path / "jax"), scene=scene, n_frames=n_frames, seed=2,
            per_image_cameras=True, descriptors=True, distractors=distractors)
    names, obs, n_scene = synth.write_unordered_workspace(
        str(tmp_path / "port"), scene, n_frames, 2, distractors)
    assert len(names) == len(obs) == n_frames + distractors
    for fname in _FILES:
        with open(tmp_path / "jax" / fname, "rb") as a, \
                open(tmp_path / "port" / fname, "rb") as b:
            assert a.read() == b.read(), fname
    feats = IOF.read_features(str(tmp_path / "port" / "ftr.bin"))
    assert [len(f.keypoints) for f in feats] == [len(o) for o in obs]
    # the ground-truth pairs join keypoints of one scene point, less the
    # 3% contamination build_covisibility_pairs mixes in
    for p in IOF.read_frame_pairs(str(tmp_path / "port" / "fp.bin")):
        inl = p.inlier_matches()
        a, b = obs[p.id1][inl[:, 0]], obs[p.id2][inl[:, 1]]
        assert np.mean(a == b) >= 0.9
        assert (a[a == b] < n_scene).all()


def test_rec_1dsfm_reconstructs_ring(ring, tmp_path):
    """rec_1dsfm.main on the ring's ground-truth pairs on the CPU: >= 95%
    registered, ATE under 1.5% of the span, the median focal error at
    most half of the EXIF-grade start's (tests/test_unordered.py's
    gates); intrinsics-refining solves, rotation averaging and every
    other solve on the CPU device it was given; the model reads back
    with one camera per registered image."""
    for mod in (ba, rot_avg, global_pose):
        mod.reset_counts()
    out = str(tmp_path / "model")
    stats = {}
    m = rec_1dsfm.main(ring, os.path.join(ring, "camera_info.txt"), out,
                       stats=stats, device="cpu")
    n_reg, ate, f_err, f_err0 = _evaluate(ring, m)
    assert n_reg >= 0.95 * N_FRAMES
    assert ate < 1.5
    assert f_err <= 0.5 * f_err0, (f_err, f_err0)
    assert ba.COUNTS["intri_solves_cpu"] > 0
    assert rot_avg.COUNTS["solves_cpu"] > 0
    for mod in (ba, rot_avg, global_pose):
        assert not any(v for k, v in mod.COUNTS.items() if k.endswith("_cuda"))
    assert stats["mapper"].registered > 0 and stats["seconds"] > 0
    assert len(IOC.read_images_bin(os.path.join(out, "images.bin"))) == n_reg
    assert len(IOC.read_cameras_bin(os.path.join(out, "cameras.bin"))) \
        >= n_reg


def test_rec_1dsfm_entry_points_refuse(tmp_path):
    """The CLI twin without a GPU is an error, not a CPU run, with or
    without --n_devices; more CUDA devices than exist raise RuntimeError
    rather than running on fewer."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TCLI.main(["rec_1dsfm", str(tmp_path), "x.txt",
                       str(tmp_path / "o")])
        with pytest.raises(RuntimeError, match="CUDA"):
            TCLI.main(["rec_1dsfm", str(tmp_path), "x.txt",
                       str(tmp_path / "o"), "--n_devices", "2"])
    with pytest.raises(RuntimeError):
        rec_1dsfm.main(str(tmp_path), "", str(tmp_path / "o"),
                       n_devices=torch.cuda.device_count() + 1, device="cuda")


_JAX_SCRIPT = r"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from xrsfm_tpu.ops.umeyama import ate_rmse
from xrsfm_tpu.pipelines import rec_1dsfm
from xrsfm_tpu.utils import geometry as G

ws, out = sys.argv[1], sys.argv[2]
m = rec_1dsfm.main(ws, os.path.join(ws, "camera_info.txt"), out)
gt, gt_f = {}, {}
for line in open(os.path.join(ws, "gt_poses.txt")):
    p = line.split()
    gt[p[0]] = (np.array(p[1:5], float), np.array(p[5:8], float))
for line in open(os.path.join(ws, "gt_cameras.txt")):
    p = line.split()
    gt_f[p[0]] = float(p[1])
reg = np.asarray(m.registered)
idx = np.nonzero(reg)[0]
est = np.stack([G.pose_center_np(np.asarray(m.q[i]), np.asarray(m.t[i]))
                for i in idx])
ref = np.stack([G.pose_center_np(*gt[m.names[i]]) for i in idx])
span = float(np.linalg.norm(ref.max(0) - ref.min(0)))
f_err = [abs(float(m.cameras[int(m.cam_of_frame[i])][0]) - gt_f[m.names[i]])
         / gt_f[m.names[i]] for i in idx]
print("RESULT " + json.dumps({"n_reg": int(reg.sum()),
                              "ate_pct": 100 * ate_rmse(ref, est) / span,
                              "focal": float(np.median(f_err))}))
"""


@pytest.mark.slow
def test_port_and_jax_rec_1dsfm_agree_on_ring(ring, tmp_path):
    """The JAX package's rec_1dsfm (in a fresh subprocess, as
    tests/test_unordered.py runs it) and the port's on the same ring:
    both register >= 95%, both stay under 1.5% ATE and 2.5% median focal
    error; the port's ATE is within 3x the JAX package's (or under 0.5%)
    and its focal error within 2x (or under 1%)."""
    script = tmp_path / "jax_rec_1dsfm.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(script), ring, str(tmp_path / "jax_model")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    rj = json.loads(line[len("RESULT "):])
    m = rec_1dsfm.main(ring, os.path.join(ring, "camera_info.txt"),
                       str(tmp_path / "port_model"), device="cpu")
    n_reg, ate, f_err, _ = _evaluate(ring, m)
    assert rj["n_reg"] >= 0.95 * N_FRAMES and n_reg >= 0.95 * N_FRAMES
    assert rj["ate_pct"] < 1.5 and ate < 1.5
    assert rj["focal"] < 0.025 and f_err < 0.025
    assert ate <= max(3.0 * rj["ate_pct"], 0.5), (ate, rj)
    assert f_err <= max(2.0 * rj["focal"], 0.01), (f_err, rj)
