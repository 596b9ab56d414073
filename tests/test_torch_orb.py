"""The port's ORB extractor (xrsfm_tpu_torch.ops.orb), Hamming matcher
(ops/matching.match_descriptors_hamming, match_pair_host_hamming) and the
ORB branch of pipelines/run_matching.get_features against the JAX
package's, on the CPU.

Per pyramid level, on a 128x128 blob texture at 2 levels, fed the same
level image: FAST corner masks equal, scores within 1e-6, keypoints and
their scores equal, angles within 1e-4 rad, and the share of equal
descriptor bits measured (1.0 here) and held at >= 0.99: a bilinear tap,
atan2 or a `va < vb` comparison may flip a bit near a tie, as SIFT's
descriptor bytes do.  The pyramids agree within 5e-5.  The Hamming
matcher is bit-exact, ties and the min(k, 4096) cap included."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_sift import make_texture
from xrsfm_tpu.ops import matching as JM
from xrsfm_tpu.ops import orb as JO
from xrsfm_tpu.pipelines import run_matching as JRM
from xrsfm_tpu_torch.ops import matching as TM
from xrsfm_tpu_torch.ops import orb as TO
from xrsfm_tpu_torch.pipelines import run_matching as TRM
from xrsfm_tpu_torch.utils import image_io
from xrsfm_tpu_torch.utils import io_features as IOF
from xrsfm_tpu_torch.utils import synth
from xrsfm_tpu_torch.utils.options import from_jax_options

torch.set_num_threads(2)

JOPTS = JO.OrbOptions(num_features=512, num_levels=2)
MIN_EQUAL_BITS = 0.99


def _bits_equal(a, b):
    return float(np.mean(np.unpackbits(np.asarray(a), axis=1)
                         == np.unpackbits(np.asarray(b), axis=1)))


@pytest.fixture(scope="module")
def image():
    img, _ = make_texture(h=128, w=128, seed=5, n_blobs=60)
    return (img * 255).astype(np.uint8).astype(np.float32) / 255.0


def test_blob_texture_is_test_sift_texture():
    a, ca = synth.blob_texture(h=96, w=80, seed=3, n_blobs=20)
    b, cb = make_texture(h=96, w=80, seed=3, n_blobs=20)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)


def test_brief_pattern_is_jax_pattern():
    np.testing.assert_array_equal(TO._PAT_A, JO._PAT_A)
    np.testing.assert_array_equal(TO._PAT_B, JO._PAT_B)
    assert from_jax_options(JOPTS) == TO.OrbOptions(num_features=512,
                                                    num_levels=2)


def test_orb_levels_match_jax(image):
    """Per level: the pyramid, FAST masks and scores, NMS, the top-k pool,
    orientations and descriptors, each fed the JAX package's level."""
    opts = from_jax_options(JOPTS)
    per_level = JOPTS.num_features // JOPTS.num_levels
    cur_j = jnp.asarray(image)
    cur_t = torch.from_numpy(image)
    for _lvl in range(2):
        h, w = cur_j.shape
        lv = np.asarray(cur_j)
        np.testing.assert_allclose(cur_t.numpy(), lv, rtol=0, atol=5e-5)
        for th in (JOPTS.fast_threshold, JOPTS.fast_threshold_min):
            cj, sj = JO._fast_score(jnp.asarray(lv), th)
            ct, st = TO._fast_score(torch.from_numpy(lv), th)
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
            np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(
                TO._nms3(torch.from_numpy(np.asarray(sj))).numpy(),
                np.asarray(JO._nms3(sj)))
            xj, yj, aj, vj, dj, okj = (np.asarray(a) for a in
                                       JO._extract_level(jnp.asarray(lv), th,
                                                         JOPTS, h, w,
                                                         per_level))
            xt, yt, at, vt, dt, okt = (a.numpy() for a in TO._extract_level(
                torch.from_numpy(lv), th, opts, per_level))
            assert okj.sum() > 20
            np.testing.assert_array_equal(okt, okj)
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)
            np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
            np.testing.assert_allclose(at[okj], aj[okj], rtol=0, atol=1e-4)
            assert _bits_equal(dt[okj], dj[okj]) >= MIN_EQUAL_BITS
        nh, nw = int(round(h / 1.2)), int(round(w / 1.2))
        cur_j = jax.image.resize(cur_j, (nh, nw), method="bilinear")
        cur_t = TO._downscale(cur_t, nh, nw)


def test_orb_extract_matches_jax(image):
    """The whole extractor: the same keypoints in the same order, angles
    within 1e-4 rad, >= 99% of the descriptor bits equal."""
    kj, dj = JO.OrbExtractor(JOPTS).extract(image)
    kt, dt = TO.OrbExtractor(from_jax_options(JOPTS),
                             device="cpu").extract(image)
    assert len(kj) > 50 and kt.shape == kj.shape and dt.shape == dj.shape
    np.testing.assert_array_equal(kt[:, :3], kj[:, :3])
    np.testing.assert_allclose(kt[:, 3], kj[:, 3], rtol=0, atol=1e-4)
    assert _bits_equal(dt, dj) >= MIN_EQUAL_BITS
    # uint8 input takes the same path as its float image
    k8, d8 = TO.OrbExtractor(from_jax_options(JOPTS), device="cpu").extract(
        (image * 255).round().astype(np.uint8))
    np.testing.assert_array_equal(k8, kt)
    np.testing.assert_array_equal(d8, dt)


def _hamming_case(seed, n, m, n_copies):
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    d2 = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    k = min(n_copies, n - 16, m - 8) if n_copies else 0
    flips = (rng.random((k, 32)) < 0.03) * rng.integers(0, 256, (k, 32))
    d2[:k] = d1[:k] ^ flips.astype(np.uint8)
    if k:  # planted ties: exact duplicates in d2 and in d1
        d2[k: k + 8] = d2[:8]
        d1[k: k + 8] = d1[8:16]
    return d1, d2


@pytest.mark.parametrize("n,m,n_copies", [(100, 90, 50), (300, 500, 200),
                                          (0, 40, 0), (6000, 5000, 4992)])
def test_hamming_matches_equal_jax(n, m, n_copies):
    """Bit-exact matches and distances, lowest-index ties, and the cap:
    at (6000, 5000) k = 8192 and more than 4096 pairs pass, so both
    packages return their first 4096."""
    d1, d2 = _hamming_case(n + m, n, m, n_copies)
    mj, dj = JM.match_pair_host_hamming(d1, d2)
    mt, dt = TM.match_pair_host_hamming(d1, d2, device="cpu")
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(dt, dj)
    assert mt.dtype == np.int32
    if n_copies > 4096:
        assert len(mt) == 4096


def test_hamming_padded_batch_equals_jax():
    """match_descriptors_hamming on padded inputs with masked rows and
    columns: every output equal."""
    d1, d2 = _hamming_case(7, 200, 256, 120)
    m1 = np.arange(256) < 200
    m2 = np.ones(256, bool)
    m2[::7] = False
    d1p = np.zeros((256, 32), np.uint8)
    d1p[:200] = d1
    outj = JM.match_descriptors_hamming(jnp.asarray(d1p), jnp.asarray(d2),
                                        jnp.asarray(m1), jnp.asarray(m2),
                                        80, 0.9, 128)
    outt = TM.match_descriptors_hamming(torch.from_numpy(d1p),
                                        torch.from_numpy(d2),
                                        torch.from_numpy(m1),
                                        torch.from_numpy(m2), 80, 0.9, 128)
    for a, b in zip(outt, outj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def orb_images(tmp_path_factory):
    """Two blob-texture PNGs and one file that is no image."""
    d = str(tmp_path_factory.mktemp("orb_images"))
    for i in range(2):
        img, _ = make_texture(h=96, w=112, seed=20 + i, n_blobs=40)
        image_io.write_png(os.path.join(d, f"im{i}.png"),
                           (img * 255).astype(np.uint8))
    with open(os.path.join(d, "im2.png"), "wb") as f:
        f.write(b"not a png")
    return d, IOF.load_image_names(d)


def test_orb_ftr_bin_matches_jax(orb_images, tmp_path, monkeypatch):
    """The ORB branch of get_features: with both packages' extractors
    returning the same keypoints and descriptors, ftr.bin is byte-equal
    (image reading, 32 bytes padded to 128, the entry of an unreadable
    image); with each package's own extractor the files agree at the
    extractor's tolerances."""
    d, names = orb_images
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    JRM.get_features(d, jpath, names, verbose=False, feature_type="orb")
    TRM.get_features(d, tpath, names, verbose=False, feature_type="orb",
                     device="cpu")
    fj, ft = IOF.read_features(jpath), IOF.read_features(tpath)
    assert [f.name for f in ft] == [f.name for f in fj] == names
    assert len(fj[2].keypoints) == 0 and len(ft[2].keypoints) == 0
    for a, b in zip(ft[:2], fj[:2]):
        assert len(b.keypoints) > 10
        np.testing.assert_array_equal(a.keypoints[:, :3], b.keypoints[:, :3])
        np.testing.assert_allclose(a.keypoints[:, 3], b.keypoints[:, 3],
                                   rtol=0, atol=1e-4)
        assert a.descriptors.shape == b.descriptors.shape
        assert not a.descriptors[:, 32:].any()
        assert _bits_equal(a.descriptors[:, :32],
                           b.descriptors[:, :32]) >= MIN_EQUAL_BITS

    def jax_extract(self, img):
        return JO.OrbExtractor(self.opts).extract(img)

    monkeypatch.setattr(TO.OrbExtractor, "extract", jax_extract)
    tpath2 = str(tmp_path / "t2.bin")
    TRM.get_features(d, tpath2, names, verbose=False, feature_type="orb",
                     device="cpu")
    with open(jpath, "rb") as f, open(tpath2, "rb") as g:
        assert f.read() == g.read()
