"""The port's host tools against the JAX package's, on the CPU: the CLI's
JSON config (the cases of tests/test_aux.py through utils/config and the
port's CLI), --profile_dir traces (utils/profiling), timers, the native
I/O loader against the Python parsers, export_ply and the drawing
functions (utils/view), and unpack_collect_data."""

import argparse
import json
import os
import struct

import numpy as np
import pytest
import torch

from synthetic import make_scene
from test_torch_snapshot import _write_bins
from xrsfm_tpu.pipelines import unpack_collect_data as JUC
from xrsfm_tpu.utils import config as JC
from xrsfm_tpu.utils import view as JV
from xrsfm_tpu_torch import cli as TCLI
from xrsfm_tpu_torch.mapper import MapperOptions
from xrsfm_tpu_torch.pipelines import run_reconstruction as TRR
from xrsfm_tpu_torch.pipelines import unpack_collect_data as TUC
from xrsfm_tpu_torch.utils import config as C
from xrsfm_tpu_torch.utils import io_features as IOF
from xrsfm_tpu_torch.utils import native
from xrsfm_tpu_torch.utils import profiling
from xrsfm_tpu_torch.utils import timer
from xrsfm_tpu_torch.utils import view as TV

torch.set_num_threads(2)


def _ns(**kw):
    return argparse.Namespace(**kw)


# --- config -------------------------------------------------------------


def test_config_keys_are_jax_keys():
    assert C._KEY_ALIASES == JC._KEY_ALIASES
    assert C._DIR_VALUED == JC._DIR_VALUED


def test_config_reference_keys_run_reconstruction(tmp_path):
    """config_seq.json-style file (reference run_reconstruction.cc:55-64),
    through utils/config and through the port's CLI parser."""
    cfg = tmp_path / "config_seq.json"
    cfg.write_text(json.dumps({
        "bin_path": "/x/bins", "camera_path": "/x/camera.txt",
        "output_path": "/x/out", "init_id1": 3, "init_id2": 7,
    }))
    a = _ns(bin_dir=None, camera_txt=None, output_dir=None,
            init_id1=-1, init_id2=-1)
    C.resolve("run_reconstruction", a, str(cfg))
    assert (a.bin_dir, a.camera_txt, a.output_dir) == (
        "/x/bins", "/x/camera.txt", "/x/out")
    assert (a.init_id1, a.init_id2) == (3, 7)
    b = TCLI._parser().parse_args(["run_reconstruction", "--config",
                                   str(cfg)])
    C.resolve(b.cmd, b, b.config)
    assert vars(a).items() <= vars(b).items()
    assert b.device == "cuda" and b.snapshot_every == 0 and not b.resume


def test_config_cli_overrides_json(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        "images_path": "/json/images", "retrieval_path": "/json/r.txt",
        "matching_type": "retrieval", "output_path": "/json/out",
    }))
    a = TCLI._parser().parse_args(["run_matching", "/cli/images", "--config",
                                   str(cfg)])
    C.resolve(a.cmd, a, a.config)
    assert a.images_dir == "/cli/images"  # the CLI wins
    assert (a.retrieval_path, a.matching_type, a.output_dir) == (
        "/json/r.txt", "retrieval", "/json/out")


def test_config_file_valued_bin_path_maps_to_dir(tmp_path):
    """config_tri.json names images.bin and *.bin files (reference
    run_triangulation.cc:117-125); their directories are taken."""
    cfg = tmp_path / "config_tri.json"
    cfg.write_text(json.dumps({
        "bin_path": "/m/refine/images.bin", "feature_path": "/w/bins/ftr.bin",
        "matches_path": "/w/bins/fp.bin", "output_path": "/w/out",
    }))
    a = _ns(bin_dir=None, model_dir=None, output_dir=None)
    C.resolve("run_triangulation", a, str(cfg))
    assert (a.bin_dir, a.model_dir, a.output_dir) == (
        "/w/bins", "/m/refine", "/w/out")


def test_config_missing_raises(tmp_path):
    a = _ns(bin_dir=None, camera_txt=None, output_dir=None,
            init_id1=-1, init_id2=-1)
    with pytest.raises(SystemExit):
        C.resolve("run_reconstruction", a, None)
    with pytest.raises(SystemExit, match="missing model_dir"):
        TCLI.main(["estimate_scale", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="missing"):
        TCLI.main(["unpack_collect_data"])


def test_cli_config_and_profile_dir_run(tmp_path):
    """run_reconstruction through the CLI with --config and --profile_dir:
    the trace file exists and the model is bit-equal to a direct call's."""
    s = make_scene(n_cams=6, n_pts=100, seed=20, noise=0.0)
    bins = str(tmp_path / "bins")
    cam = _write_bins(s, bins)
    direct = str(tmp_path / "direct")
    assert TRR.main(bins, cam, direct, opts=MapperOptions(verbose=False),
                    device="cpu") is not None
    cfg = tmp_path / "cfg.json"
    cli_out = str(tmp_path / "cli")
    cfg.write_text(json.dumps({"bin_path": bins, "camera_path": cam,
                               "output_path": cli_out}))
    prof = str(tmp_path / "prof")
    TCLI.main(["run_reconstruction", "--config", str(cfg), "--profile_dir",
               prof, "--device", "cpu"])
    with open(os.path.join(prof, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(direct, name), "rb") as a, \
                open(os.path.join(cli_out, name), "rb") as b:
            assert a.read() == b.read(), name


# --- profiling and timers ------------------------------------------------


def test_maybe_trace_and_device_time(tmp_path):
    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(str(tmp_path / "t")):
        with profiling.annotate("span"):
            x = torch.ones(64) * 2.0
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "span" in names
    sec, out = profiling.device_time(lambda v: (v * 2.0).sum(), x,
                                     warmup=1, iters=3)
    assert sec >= 0.0 and float(out) == 256.0


def test_timers():
    ta = timer.TimerArray()
    with ta["reg"].timing():
        timer.sync_device([torch.ones(3)])
    timer.sync_device({"a": torch.zeros(2)})
    assert ta["reg"].total > 0.0 and ta["new"].total == 0.0
    assert set(ta.timers) >= {"tot", "reg", "gba", "new"}


# --- native I/O ------------------------------------------------------------


def test_native_parsers_equal_python(tmp_path):
    """The port's loader finds or builds native/xrsfm_native.c; its readers
    return what the Python parsers return, self-pairs dropped."""
    rng = np.random.default_rng(1)
    feats = [IOF.FrameFeatures(
        f"img{i}.png", rng.uniform(0, 640, (n, 4)).astype(np.float32),
        rng.integers(0, 255, (n, 128), dtype=np.uint8))
        for i, n in enumerate(rng.integers(3, 80, 5))]
    p = str(tmp_path / "ftr.bin")
    IOF.write_features(p, feats)
    pairs = [IOF.FramePairData(
        id1=k, id2=k + 1, matches=rng.integers(0, 100, (n, 2)).astype(np.int32),
        distances=rng.uniform(size=n), E=rng.normal(size=(3, 3)),
        inlier_num=n // 2, inlier_mask=rng.uniform(size=n) > 0.5)
        for k, n in enumerate(rng.integers(4, 50, 6))]
    pairs.append(IOF.FramePairData(
        id1=9, id2=9, matches=np.zeros((2, 2), np.int32),
        distances=np.zeros(2), E=np.eye(3), inlier_num=0,
        inlier_mask=np.zeros(2, bool)))
    q = str(tmp_path / "fp.bin")
    IOF.write_frame_pairs(q, pairs)
    assert native.get_native() is not None
    for with_descs in (True, False):
        for a, b in zip(IOF.read_features(p, with_descs),
                        native.read_features_fast(p, with_descs)):
            assert a.name == b.name
            np.testing.assert_array_equal(a.keypoints, b.keypoints)
            np.testing.assert_array_equal(a.descriptors, b.descriptors)
    py, nat = IOF.read_frame_pairs(q), native.read_frame_pairs_fast(q)
    assert len(py) == len(nat) == 6
    for a, b in zip(py, nat):
        assert (a.id1, a.id2, a.inlier_num) == (b.id1, b.id2, b.inlier_num)
        np.testing.assert_array_equal(a.matches, b.matches)
        np.testing.assert_array_equal(a.distances, b.distances)
        np.testing.assert_array_equal(a.E, b.E)
        np.testing.assert_array_equal(a.inlier_mask, b.inlier_mask)


# --- view ------------------------------------------------------------------


@pytest.mark.parametrize("cams", [0, 40])
def test_export_ply_bytes_equal_jax(tmp_path, cams):
    rng = np.random.default_rng(cams)
    pts = rng.normal(size=(60, 3)) * 20
    rgb = rng.integers(0, 255, (60, 3)).astype(np.uint8) if cams else None
    q = rng.normal(size=(cams, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-12
    t = rng.normal(size=(cams, 3)) * 30
    kw = dict(cam_q=q, cam_t=t) if cams else {}
    TV.export_ply(tmp_path / "t.ply", pts, rgb, **kw)
    JV.export_ply(tmp_path / "j.ply", pts, rgb, **kw)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_drawing_equals_jax(tmp_path):
    pytest.importorskip("cv2")
    img1 = np.zeros((120, 160), np.uint8)
    img2 = np.full((100, 140), 30, np.uint8)
    kps1 = np.array([[10.0, 20.0], [50.0, 60.0], [100.0, 30.0]])
    kps2 = np.array([[15.0, 25.0], [55.0, 65.0]])
    matches = np.array([[0, 0], [1, 1], [2, 0]])
    mask = np.array([True, True, False])
    for fn, args in ((TV.draw_features, (img1, kps1)),
                     (TV.draw_matches, (img1, img2, kps1, kps2, matches,
                                        mask)),
                     (TV.draw_feature_flow, (img1, kps1, kps1 + 3.0,
                                             matches[:2]))):
        out = fn(*args, out_path=tmp_path / f"{fn.__name__}.png")
        np.testing.assert_array_equal(out, getattr(JV, fn.__name__)(*args))
        assert (tmp_path / f"{fn.__name__}.png").exists()


# --- unpack_collect_data ------------------------------------------------------


def test_unpack_collect_data_bytes_equal_jax(tmp_path):
    """A capture stream of `<di` records (a truncated record at the end)
    unpacks into the JAX package's files byte for byte, from the entry
    point and from the CLI."""
    rng = np.random.default_rng(4)
    blobs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(10, 400, 5)]
    stamps = 1.7e9 + np.cumsum(rng.uniform(0.01, 0.1, 5))
    stream = b"".join(struct.pack("<di", ts, len(b)) + b
                      for ts, b in zip(stamps, blobs))
    stream += struct.pack("<di", 1.0, 50) + b"short"
    src = tmp_path / "capture.bin"
    src.write_bytes(stream)
    outs = [tmp_path / k for k in ("port", "jax", "cli")]
    assert TUC.main(str(src), str(outs[0])) == 5
    assert JUC.main(str(src), str(outs[1])) == 5
    TCLI.main(["unpack_collect_data", str(src), str(outs[2])])

    def tree(root):
        return {os.path.relpath(os.path.join(d, f), root):
                open(os.path.join(d, f), "rb").read()
                for d, _, fs in os.walk(root) for f in fs}

    t = tree(outs[0])
    assert len(t) == 6 and t == tree(outs[1]) == tree(outs[2])
    assert t[os.path.join("images", "000003.jpg")] == blobs[3]
