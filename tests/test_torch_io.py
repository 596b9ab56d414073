"""The port's host-side I/O: image files against cv2.imread, ftr.bin /
fp.bin / size.bin against the JAX package's io_features, option
conversion from the JAX dataclasses, and the port's JAX-free imports."""

import dataclasses
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from xrsfm_tpu.feature.matching import MatchingOptions as JMatchingOptions
from xrsfm_tpu.mapper import kernels as JK
from xrsfm_tpu.ops.sift import SiftOptions as JSiftOptions
from xrsfm_tpu.utils import io_features as JIO
from xrsfm_tpu_torch.feature.matching import MatchingOptions
from xrsfm_tpu_torch.ops.sift import SiftOptions
from xrsfm_tpu_torch.utils import image_io
from xrsfm_tpu_torch.utils import io_features as TIO
from xrsfm_tpu_torch.utils.options import from_jax_options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(seed=0, h=37, w=53):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ramp = (np.add.outer(np.arange(h), np.arange(w)) * 3 % 256).astype(
        np.uint8)
    rgb = np.stack([noise, ramp, 255 - noise], -1)
    return noise, ramp, rgb


@pytest.mark.parametrize("level", [0, 3, 9])
@pytest.mark.parametrize("kind", ["gray_noise", "gray_ramp", "rgb", "rgba",
                                  "pgm"])
def test_read_gray_equals_cv2_imread(tmp_path, kind, level):
    """Files written by OpenCV (its own filter choices per compression
    level): read_gray equals cv2.imread(..., IMREAD_GRAYSCALE) exactly,
    and colour files read as cv2's BGR reversed."""
    noise, ramp, rgb = _images()
    ext = ".pgm" if kind == "pgm" else ".png"
    path = str(tmp_path / f"{kind}{ext}")
    img = {"gray_noise": noise, "gray_ramp": ramp, "pgm": ramp,
           "rgb": rgb[..., ::-1],
           "rgba": np.concatenate([rgb[..., ::-1], noise[..., None]], -1)}[kind]
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(image_io.read_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    if kind in ("rgb", "rgba"):
        np.testing.assert_array_equal(
            image_io.read_image(path),
            cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


def _encode_png(img, ftype):
    """PNG with every row encoded by one filter type (test encoder)."""
    h, w, bpp = img.shape
    rows = img.reshape(h, w * bpp).astype(np.int32)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(x)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + ((x - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
    color = {1: 0, 3: 2}[bpp]

    def chunk(t, b):
        return (struct.pack(">I", len(b)) + t + b
                + struct.pack(">I", zlib.crc32(t + b) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_each_filter_type(tmp_path, ftype):
    """Each of the five PNG row filters decodes exactly, gray and RGB, and
    cv2 agrees."""
    noise, ramp, rgb = _images(seed=ftype)
    for img in (noise[..., None], rgb):
        path = str(tmp_path / f"f{ftype}_{img.shape[2]}.png")
        with open(path, "wb") as f:
            f.write(_encode_png(img, ftype))
        got = image_io.read_image(path)
        np.testing.assert_array_equal(got, img[..., 0] if img.shape[2] == 1
                                      else img)
        np.testing.assert_array_equal(image_io.read_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_written_png_and_pgm_read_back_by_cv2(tmp_path):
    noise, _, rgb = _images(seed=4)
    image_io.write_image(str(tmp_path / "g.png"), noise)
    image_io.write_image(str(tmp_path / "c.png"), rgb)
    image_io.write_image(str(tmp_path / "g.pgm"), noise)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_GRAYSCALE), noise)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_COLOR)[..., ::-1], rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.pgm"), cv2.IMREAD_GRAYSCALE), noise)
    with pytest.raises(ValueError):
        (tmp_path / "bad.png").write_bytes(b"not an image")
        image_io.read_gray(str(tmp_path / "bad.png"))


def _frames(rng, mod):
    return [mod.FrameFeatures(
        name=f"img_{i}.png",
        keypoints=rng.normal(size=(n, 4)).astype(np.float32),
        descriptors=rng.integers(0, 256, (n, 128), dtype=np.uint8))
        for i, n in enumerate((5, 0, 17))]


def _pairs(rng, mod):
    out = []
    for id1, id2, n in ((0, 2, 7), (1, 2, 0), (0, 1, 3)):
        out.append(mod.FramePairData(
            id1=id1, id2=id2,
            matches=rng.integers(0, 50, (n, 2)).astype(np.int32),
            distances=rng.random(n), E=rng.normal(size=(3, 3)),
            inlier_num=int(n // 2), inlier_mask=rng.random(n) < 0.5))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binary_files_byte_equal_with_jax_io(tmp_path, writer):
    """ftr.bin, fp.bin and size.bin written by either package are read by
    the other and re-written byte for byte; retrieval ranks parse alike."""
    rng = np.random.default_rng(3)
    src, dst = (TIO, JIO) if writer == "port" else (JIO, TIO)
    frames, pairs = _frames(rng, src), _pairs(rng, src)
    sizes = rng.integers(1, 4000, (3, 2)).astype(np.int32)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    src.write_features(str(a / "ftr.bin"), frames)
    src.write_frame_pairs(str(a / "fp.bin"), pairs)
    src.write_image_size(str(a / "size.bin"), sizes)
    dst.write_features(str(b / "ftr.bin"), dst.read_features(str(a / "ftr.bin")))
    dst.write_frame_pairs(str(b / "fp.bin"),
                          dst.read_frame_pairs(str(a / "fp.bin")))
    dst.write_image_size(str(b / "size.bin"),
                         dst.read_image_size(str(a / "size.bin")))
    for name in ("ftr.bin", "fp.bin", "size.bin"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    (a / "retrieval.txt").write_text(
        "img_0.png img_2.png\nimg_2.png img_0.png\nimg_2.png missing.png\n")
    name_to_id = {f"img_{i}.png": i for i in range(3)}
    assert (TIO.load_retrieval_rank(str(a / "retrieval.txt"), name_to_id)
            == JIO.load_retrieval_rank(str(a / "retrieval.txt"), name_to_id))


def test_bucket_and_pad_rows_match_jax():
    for n in (0, 1, 63, 64, 65, 1000, 4096, 4097):
        for lo in (64, 256):
            assert TIO.bucket(n, lo) == JK.bucket(n, lo)
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    for n in (3, 6, 9):
        np.testing.assert_array_equal(TIO.pad_rows(a, n, -1.0),
                                      JK.pad_rows(a, n, -1.0))


def test_from_jax_options_round_trips_both_dataclasses():
    """Every field carried over, defaults included; a dict of fields picks
    its class; an unknown field raises."""
    for jopt, cls in (
        (JSiftOptions(), SiftOptions),
        (JSiftOptions(num_octaves=3, first_octave=0, max_features=2048),
         SiftOptions),
        (JMatchingOptions(), MatchingOptions),
        (JMatchingOptions(dist_th=0.6, seq_window=7), MatchingOptions),
    ):
        got = from_jax_options(jopt)
        assert type(got) is cls
        assert dataclasses.asdict(got) == dataclasses.asdict(jopt)
        assert from_jax_options(dataclasses.asdict(jopt)) == got
    assert {f.name for f in dataclasses.fields(SiftOptions)} == \
        {f.name for f in dataclasses.fields(JSiftOptions)}
    assert {f.name for f in dataclasses.fields(MatchingOptions)} == \
        {f.name for f in dataclasses.fields(JMatchingOptions)}
    with pytest.raises(ValueError):
        from_jax_options({"dist_th": 0.5, "not_a_field": 1})
    with pytest.raises(TypeError):
        from_jax_options(3)


def test_port_imports_no_jax():
    """A fresh interpreter that imports every module of the port has no
    jax and no xrsfm_tpu module loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import xrsfm_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'xrsfm_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'xrsfm_tpu'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
