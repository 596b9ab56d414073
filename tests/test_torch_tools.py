"""The port's user scripts (xrsfm_tpu_torch/tools) against the JAX
package's scripts/ of the same names, on the CPU: rendered scenes and
feature workspaces byte for byte (pixels for PNGs), point colours byte for
byte in points3D.bin, evaluate_model's figures and printed lines, and the
dataset runners end to end on small synthetic workspaces."""

import contextlib
import importlib.util
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from xrsfm_tpu_torch.tools import evaluate_model as TEV
from xrsfm_tpu_torch.tools import pointcloud_color as TPC
from xrsfm_tpu_torch.tools import run_1dsfm, run_kitti, run_test_data
from xrsfm_tpu_torch.tools import synth_dataset as TSD
from xrsfm_tpu_torch.tools import synth_features as TSF
from xrsfm_tpu_torch.utils import image_io
from xrsfm_tpu_torch.utils import io_colmap as IOC
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
cv2 = pytest.importorskip("cv2")


def _script(name):
    """scripts/<name>.py as a module of its own name-space."""
    spec = importlib.util.spec_from_file_location(
        f"scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _same_tree(a, b, png=False):
    """Every file of a in b with the same bytes; PNGs by decoded pixels."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_tree(pa, pb, png)
        elif png and n.endswith(".png"):
            ref = cv2.imread(pa, cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(image_io.read_png(pb), ref, n)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), n


@pytest.mark.parametrize("scene,cli", [("loop", False), ("corridor", False),
                                       ("corridor", True)])
def test_synth_dataset_matches_script(tmp_path, scene, cli):
    """utils/synth.write_dataset at 6 cameras and 160x120 (or the tool's
    command line at its defaults, 512x384 and 2 cameras) against
    scripts/synth_dataset.main: the same pixels in every PNG, camera.txt,
    gt_poses.txt, retrieval.txt and times.txt byte-equal, and the same
    printed line."""
    S = _script("synth_dataset")
    ref, out = str(tmp_path / "ref"), str(tmp_path / "port")
    if cli:
        _, said = _stdout(S.main, ref, 2, 3, scene=scene)
        _, got = _stdout(TSD.main, [out, "--n_cams", "2", "--scene", scene,
                                    "--device", "cpu"])
        assert got.replace(out, ref) == said
    else:
        S.main(ref, 6, 3, 160, 120, 150.0, scene=scene)
        synth.write_dataset(out, 6, 3, 160, 120, 150.0, scene)
    _same_tree(ref, out, png=True)
    assert os.path.exists(os.path.join(out, "times.txt")) == (
        scene == "corridor")


FEATURE_CASES = {
    "kitti": [],
    "kitti_descriptors": ["--descriptors"],
    "kitti_per_image": ["--per_image_cameras"],
    "unordered_1dsfm": ["--scene", "unordered", "--per_image_cameras",
                        "--descriptors", "--distractors", "3"],
    "unordered_per_image": ["--scene", "unordered", "--per_image_cameras",
                            "--focal_noise", "0.05"],
    "unordered_pinhole": ["--scene", "unordered"],
    "tour_descriptors": ["--scene", "tour", "--descriptors"],
}


@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_synth_features_matches_script(tmp_path, case):
    """tools.synth_features against scripts/synth_features.main at 40
    frames, seed 5, for each of the script's argument sets: every file
    byte-equal and the same printed line."""
    S = _script("synth_features")
    argv = FEATURE_CASES[case]
    kw = dict(scene="kitti", per_image_cameras="--per_image_cameras" in argv,
              descriptors="--descriptors" in argv)
    for flag, key, typ in (("--scene", "scene", str),
                           ("--distractors", "distractors", int),
                           ("--focal_noise", "focal_noise", float)):
        if flag in argv:
            kw[key] = typ(argv[argv.index(flag) + 1])
    ref, out = str(tmp_path / "ref"), str(tmp_path / "port")
    _, said = _stdout(S.main, ref, n_frames=40, seed=5, **kw)
    _, got = _stdout(TSF.main, [out, "--n_frames", "40", "--seed", "5",
                                "--device", "cpu"] + argv)
    assert got.replace(out, ref) == said
    _same_tree(ref, out)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "pgm"])
def test_read_rgb_matches_cv2(tmp_path, kind):
    """image_io.read_rgb: what cv2.imread(IMREAD_COLOR) then BGR2RGB
    returns."""
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, (23, 31, 4), dtype=np.uint8)
    path = str(tmp_path / ("x.pgm" if kind == "pgm" else "x.png"))
    img = {"gray": rgba[..., 0], "pgm": rgba[..., 0], "rgb": rgba[..., :3],
           "rgba": rgba}[kind]
    cv2.imwrite(path, img if img.ndim == 2 else cv2.cvtColor(
        img, cv2.COLOR_RGBA2BGRA if kind == "rgba" else cv2.COLOR_RGB2BGR))
    ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(image_io.read_rgb(path), ref)


@pytest.fixture(scope="module")
def arc_run(tmp_path_factory):
    """tools.run_test_data on the CPU on an 8-image arc at 384x288: the
    workspace, the number of points coloured and the printed output."""
    ws = str(tmp_path_factory.mktemp("arc8"))
    synth.write_arc_dataset(ws, n_cams=8, w=384, h=288, f=337.5)
    n, said = _stdout(run_test_data.main, [ws, "--device", "cpu"])
    return ws, n, said


def test_run_test_data_end_to_end(arc_run):
    """A model is written, every point is coloured from the images (none
    left at the mapper's grey), all 8 frames register, and the run says
    so."""
    ws, n, said = arc_run
    model = os.path.join(ws, "model")
    pts = IOC.read_points3d_bin(os.path.join(model, "points3D.bin"))
    imgs = IOC.read_images_bin(os.path.join(model, "images.bin"))
    assert len(imgs) == 8 and len(pts) >= 50
    assert n == len(pts)
    assert f"[run_test_data] colored {n} points" in said
    grey = sum(np.array_equal(p.rgb, [128, 128, 128]) for p in pts.values())
    assert grey < 0.05 * len(pts)
    assert os.path.exists(os.path.join(ws, "bins", "fp.bin"))


def test_run_test_data_without_model_exits_1(tmp_path, capsys):
    """One image: no pair, no initialization, no model; the run exits 1
    with the script's line."""
    synth.write_arc_dataset(str(tmp_path), n_cams=1, w=160, h=120, f=150.0)
    with pytest.raises(SystemExit) as e:
        run_test_data.main([str(tmp_path), "--device", "cpu"])
    assert e.value.code == 1
    assert "[run_test_data] reconstruction produced no model" in \
        capsys.readouterr().out


def _edge_model(ws, dst):
    """The arc run's model and images, with one image gray, one missing,
    and some observations pushed outside their image."""
    images = os.path.join(dst, "images")
    shutil.copytree(os.path.join(ws, "images"), images)
    shutil.copytree(os.path.join(ws, "model"), os.path.join(dst, "model"))
    path = os.path.join(dst, "model", "images.bin")
    imgs = IOC.read_images_bin(path)
    names = sorted(im.name for im in imgs.values())
    gray = image_io.read_gray(os.path.join(images, names[1]))
    image_io.write_png(os.path.join(images, names[1]), gray)
    os.remove(os.path.join(images, names[2]))
    for im in imgs.values():
        im.xys = im.xys.copy()
        im.xys[::7, 0] += 1000.0
        im.xys[3::11, 1] = -0.5
    IOC.write_images_bin(path, imgs)
    return images, os.path.join(dst, "model")


@pytest.mark.parametrize("variant", ["as_written", "edge"])
def test_add_color_matches_script(arc_run, tmp_path, variant):
    """tools.pointcloud_color.add_color against
    scripts/pointcloud_color.add_color on the same model and PNGs:
    points3D.bin byte-equal and the same count; "edge" adds a gray PNG, a
    missing image and observations outside their image."""
    ws = arc_run[0]
    S = _script("pointcloud_color")
    dirs = {}
    for who in ("ref", "port"):
        if variant == "edge":
            dirs[who] = _edge_model(ws, str(tmp_path / who))
        else:
            shutil.copytree(os.path.join(ws, "model"),
                            str(tmp_path / who / "model"))
            dirs[who] = (os.path.join(ws, "images"),
                         str(tmp_path / who / "model"))
    n_ref = S.add_color(*dirs["ref"])
    n_port = TPC.add_color(*dirs["port"])
    assert n_port == n_ref > 0
    with open(os.path.join(dirs["ref"][1], "points3D.bin"), "rb") as a, \
            open(os.path.join(dirs["port"][1], "points3D.bin"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("variant", ["as_written", "radial"])
def test_evaluate_model_matches_script(arc_run, tmp_path, monkeypatch,
                                       variant):
    """tools.evaluate_model against scripts/evaluate_model.main on the arc
    run's model (and with its camera made SIMPLE_RADIAL, k1 = 0.02): the
    same printed lines, the ATE within 1e-9 relative, and the returned
    figures equal to the printed ones."""
    ws = arc_run[0]
    model = str(tmp_path / "model")
    shutil.copytree(os.path.join(ws, "model"), model)
    if variant == "radial":
        path = os.path.join(model, "cameras.bin")
        cams = IOC.read_cameras_bin(path)
        for c in cams.values():
            c.model_id = 2
            c.params = np.array([c.params[0], c.params[2], c.params[3], 0.02])
        IOC.write_cameras_bin(path, cams)
    gt = os.path.join(ws, "gt_poses.txt")
    S = _script("evaluate_model")
    monkeypatch.setattr(sys, "argv", ["evaluate_model.py", model, gt])
    ate, said = _stdout(S.main)
    res, got = _stdout(TEV.main, [model, gt, "--device", "cpu"])
    assert got == said
    assert res["ate"] == pytest.approx(ate, rel=1e-9, abs=0)
    assert res["registered"] == 8 and res["n_gt"] == 8
    lines = dict(ln.split(":", 1) for ln in said.splitlines())
    rep = lines["reprojection error"].split()
    for key, word in (("reproj_mean", "mean"), ("reproj_median", "median"),
                      ("reproj_p95", "p95")):
        printed = float(rep[rep.index(word) + 1][:-2])
        assert abs(res[key] - printed) <= 5e-4 + 1e-4, key
    assert f"{res['ate_pct']:.3f}% of span" in said


@pytest.mark.parametrize("dataset", ["kitti", "1dsfm"])
def test_dataset_runner(tmp_path, capsys, dataset):
    """tools.run_kitti on a KITTI-layout workspace (<seq>/image_0 and
    times.txt: the 6-frame corridor) and tools.run_1dsfm on a 1DSfM-layout
    one (<scene>/images, retrieval.txt, camera_info.txt with 3% focal
    error: the 6-frame arc), on the CPU: a missing sequence or scene is
    skipped with the script's line, the other reconstructed with every
    frame registered (and, for KITTI, one stamped TUM line each)."""
    root, ws = str(tmp_path / "data"), str(tmp_path / "ws")
    if dataset == "kitti":
        seq = os.path.join(root, "00")
        synth.write_dataset(seq, n_cams=6, scene="corridor")
        os.rename(os.path.join(seq, "images"), os.path.join(seq, "image_0"))
        run_kitti.main([root, ws, "--seqs", "01", "00", "--device", "cpu"])
        assert f"skip 01: no {os.path.join(root, '01', 'image_0')}" in \
            capsys.readouterr().out
        model = os.path.join(ws, "00", "model")
        with open(os.path.join(model, "00.txt")) as f:
            stamps = [float(ln.split()[0]) for ln in f if ln.strip()]
        np.testing.assert_allclose(stamps, 0.1 * np.arange(6), atol=1e-9)
    else:
        scene = os.path.join(root, "s")
        names, _, _ = synth.write_dataset(scene, n_cams=6, scene="arc")
        with open(os.path.join(scene, "camera_info.txt"), "w") as f:
            for n in names:
                f.write(f"{n} SIMPLE_RADIAL 512 384 {450 * 1.03:.3f} 256.0 "
                        f"192.0 0.0\n")
        run_1dsfm.main([root, ws, "--scenes", "t", "s", "--device", "cpu"])
        assert "skip t: not found" in capsys.readouterr().out
        model = os.path.join(ws, "s", "model")
    assert len(IOC.read_images_bin(os.path.join(model, "images.bin"))) == 6


TOOL_ARGS = {
    "synth_dataset": ["out"],
    "synth_features": ["out"],
    "pointcloud_color": ["--image_dir", "i", "--bin_dir", "m"],
    "evaluate_model": ["m", "gt.txt"],
    "run_test_data": ["ws"],
    "run_kitti": ["root", "ws"],
    "run_1dsfm": ["root", "ws"],
    "run_unordered_bench": ["--workdir", "wd"],
    "profile_sift": [],
    "profile_ba": [],
    "dist_scaling": [],
    "dist_multiprocess": ["--workdir", "wd"],
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only host")
@pytest.mark.parametrize("tool", sorted(TOOL_ARGS))
def test_tool_defaults_to_cuda_and_raises_without_gpu(tmp_path, tool):
    """Every tool's --device defaults to cuda, which raises without a GPU
    before anything is written."""
    mod = importlib.import_module(f"xrsfm_tpu_torch.tools.{tool}")
    args = [str(tmp_path / a) if not a.startswith("--") else a
            for a in TOOL_ARGS[tool]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)
    assert os.listdir(tmp_path) == []


def test_tools_import_no_jax_cv2_or_scripts():
    """A fresh interpreter that imports every tool has no jax, xrsfm_tpu,
    cv2 or scripts module loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import xrsfm_tpu_torch.tools as t\n"
        "mods = [m.name for m in pkgutil.iter_modules(t.__path__, "
        "'xrsfm_tpu_torch.tools.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'xrsfm_tpu', 'cv2', 'scripts'))\n"
        "assert len(mods) == 14, mods\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
