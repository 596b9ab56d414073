"""The port's matching stage through its entry points
(xrsfm_tpu_torch.pipelines.run_matching.main and the run_matching CLI)
against the JAX package's, on a 6-image arc scene rendered by the port's
utils/synth, on the CPU."""

import os
import shutil

import numpy as np
import pytest
import torch

from xrsfm_tpu.feature import matching as JFM
from xrsfm_tpu.pipelines import run_matching as JRM
from xrsfm_tpu_torch import cli as TCLI
from xrsfm_tpu_torch.pipelines import run_matching as TRM
from xrsfm_tpu_torch.utils import io_features as IOF
from xrsfm_tpu_torch.utils import synth
from xrsfm_tpu_torch.utils.options import from_jax_options

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Images, the JAX run's outputs, and the port's two runs: (a) from the
    JAX ftr.bin, (b) from the images."""
    root = str(tmp_path_factory.mktemp("arc6"))
    synth.write_arc_dataset(root, n_cams=6, w=192, h=160, f=450.0)
    images = os.path.join(root, "images")
    jax_out = os.path.join(root, "jax")
    JRM.main(images, "", "sequential", jax_out)
    port_a = os.path.join(root, "port_a")
    os.makedirs(port_a)
    shutil.copy(os.path.join(jax_out, "ftr.bin"), port_a)
    TRM.main(images, "", "sequential", port_a, device="cpu")
    port_b = os.path.join(root, "port_b")
    TRM.main(images, "", "sequential", port_b, device="cpu")
    return root, images, jax_out, port_a, port_b


def _pairs(out_dir):
    return {(p.id1, p.id2): p
            for p in IOF.read_frame_pairs(os.path.join(out_dir, "fp.bin"))}


def test_from_jax_features_same_pairs_and_matches(scene):
    """(a) Same features in: the same verified pair set, identical
    pre-verification matches, inlier counts within max(3, 3%)."""
    _, _, jax_out, port_a, _ = scene
    pj, pt = _pairs(jax_out), _pairs(port_a)
    assert len(pj) >= 10
    assert set(pj) == set(pt)
    for k in pj:
        assert np.array_equal(pj[k].matches, pt[k].matches), k
        tol = max(3, 0.03 * pj[k].inlier_num)
        assert abs(pj[k].inlier_num - pt[k].inlier_num) <= tol, k


def test_from_images_same_pairs(scene):
    """(b) Images in, through both entry points: the same verified pair
    set, match counts within 5%, and the same image sizes."""
    _, _, jax_out, _, port_b = scene
    pj, pt = _pairs(jax_out), _pairs(port_b)
    assert set(pj) == set(pt)
    for k in pj:
        nj, nt = len(pj[k].matches), len(pt[k].matches)
        assert abs(nj - nt) <= 0.05 * nj, (k, nj, nt)
    np.testing.assert_array_equal(
        IOF.read_image_size(os.path.join(jax_out, "size.bin")),
        IOF.read_image_size(os.path.join(port_b, "size.bin")))


@pytest.mark.parametrize("mtype,opts", [
    ("retrieval", {}),
    # a short window, so that the loop-closure probes add pairs
    ("sequential", {"seq_window": 3, "seq_loop_stride": 2}),
    ("covisibility", {}),
])
def test_with_retrieval_ranks_same_pairs(scene, mtype, opts):
    """With the scene's retrieval.txt, from the JAX ftr.bin: the same
    proposed pairs, verified pairs and matches as the JAX package (the
    port's options converted from the JAX dataclass)."""
    root, images, jax_out, _, _ = scene
    rpath = os.path.join(root, "retrieval.txt")
    jopts = JFM.MatchingOptions(**opts)
    runs = (
        (JRM.main, {"opts": jopts}),
        (TRM.main, {"opts": from_jax_options(jopts), "device": "cpu"}),
    )
    outs, stats = [], []
    for k, (run, kw) in enumerate(runs):
        out = os.path.join(root, f"{mtype}_{len(opts)}_{k}")
        os.makedirs(out)
        shutil.copy(os.path.join(jax_out, "ftr.bin"), out)
        st = {}
        run(images, rpath, mtype, out, stats=st, **kw)
        outs.append(_pairs(out))
        stats.append(st["pairs_proposed"])
    pj, pt = outs
    assert stats[0] == stats[1]
    assert len(pj) >= 10 and set(pj) == set(pt)
    for k in pj:
        assert np.array_equal(pj[k].matches, pt[k].matches), k


def test_cli_run_matching_writes_same_fp(scene, tmp_path):
    """python -m xrsfm_tpu_torch.cli run_matching ... --device cpu, from
    the cached JAX ftr.bin, writes the same fp.bin as main()."""
    _, images, jax_out, port_a, _ = scene
    out = str(tmp_path / "cli")
    os.makedirs(out)
    shutil.copy(os.path.join(jax_out, "ftr.bin"), out)
    TCLI.main(["run_matching", images, "", "sequential", out,
               "--device", "cpu"])
    with open(os.path.join(out, "fp.bin"), "rb") as f, \
            open(os.path.join(port_a, "fp.bin"), "rb") as g:
        assert f.read() == g.read()


def test_self_retrieval_same_ranks_and_pairs(scene, tmp_path):
    """Retrieval matching without a retrieval.txt, from the JAX ftr.bin:
    the port ranks the images by VLAD as the JAX package does (the cached
    retrieval.txt byte-equal) and verifies the same pairs."""
    _, images, jax_out, _, _ = scene
    outs = []
    for k, run in enumerate((JRM.main, TRM.main)):
        out = str(tmp_path / f"r{k}")
        os.makedirs(out)
        shutil.copy(os.path.join(jax_out, "ftr.bin"), out)
        kw = {"device": "cpu"} if k else {}
        run(images, "", "retrieval", out, **kw)
        outs.append(out)
    with open(os.path.join(outs[0], "retrieval.txt"), "rb") as f, \
            open(os.path.join(outs[1], "retrieval.txt"), "rb") as g:
        assert f.read() == g.read()
    pj, pt = _pairs(outs[0]), _pairs(outs[1])
    assert len(pj) >= 10 and set(pj) == set(pt)


def test_retrieve_cli_writes_jax_retrieval_text(scene, tmp_path):
    """The retrieve stage, through the port's CLI twin, from the JAX
    ftr.bin: the JAX package's retrieve.main writes the same
    retrieval.txt bytes."""
    from xrsfm_tpu.pipelines import retrieve as JRV

    _, images, jax_out, _, _ = scene
    outs = []
    for k in range(2):
        out = str(tmp_path / f"v{k}")
        os.makedirs(out)
        shutil.copy(os.path.join(jax_out, "ftr.bin"), out)
        outs.append(out)
    JRV.main(images, outs[0], topk=3, num_words=8)
    TCLI.main(["retrieve", images, outs[1], "--topk", "3", "--num_words", "8",
               "--device", "cpu"])
    with open(os.path.join(outs[0], "retrieval.txt"), "rb") as f, \
            open(os.path.join(outs[1], "retrieval.txt"), "rb") as g:
        got = g.read()
        assert f.read() == got and len(got.splitlines()) == 6 * 3


def test_main_without_gpu_raises_and_unported_types_raise(scene, tmp_path):
    """device="cuda" without a GPU is an error, not a CPU run; an unknown
    matching type is an error; ORB features, not ported yet, raise
    NotImplementedError naming their ROADMAP.md item."""
    _, images, _, _, _ = scene
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TRM.main(images, "", "sequential", str(tmp_path / "x"),
                     device="cuda")
        assert not os.path.exists(tmp_path / "x")
    with pytest.raises(ValueError, match="unknown matching type"):
        TRM.main(images, "", "exhaustive", str(tmp_path / "c"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        TRM.get_features(images, str(tmp_path / "ftr.bin"),
                         IOF.load_image_names(images), feature_type="orb",
                         device="cpu")
