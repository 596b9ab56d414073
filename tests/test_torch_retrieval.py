"""The port's VLAD retrieval (xrsfm_tpu_torch.feature.retrieval) against
the JAX package's (xrsfm_tpu/feature/retrieval.py) on the same seeded
descriptor sets, and the behaviours tests/test_retrieval.py holds the
JAX package to, on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_retrieval import _make_scene_descs
from xrsfm_tpu.feature import retrieval as JR
from xrsfm_tpu_torch.feature import retrieval as TR
from xrsfm_tpu_torch.utils import io_features as IOF

torch.set_num_threads(2)


def _sample_and_init(seed=0, k=16):
    rng = np.random.default_rng(seed)
    descs, _ = _make_scene_descs(rng)
    alld = np.concatenate(descs).astype(np.float32) / 512.0
    return alld, alld[rng.choice(len(alld), k, replace=False)]


def test_kmeans_matches_jax():
    """Lloyd from the same sample and init (the JAX side zero-padded to its
    bucket, the padding invisible): centers within atol 1e-4 and the
    quantization error within 1e-5 relative, after 0 and 10 iterations."""
    alld, init = _sample_and_init()
    padded = np.zeros((JR._bucket(len(alld)), 128), np.float32)
    padded[: len(alld)] = alld
    for iters in (0, 10):
        cj, ej = JR._kmeans(padded, jnp.asarray(init), iters)
        ct, et = TR._kmeans(torch.from_numpy(alld), torch.from_numpy(init),
                            iters)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4)
        assert float(et) == pytest.approx(float(ej), rel=1e-5)


def _assert_vlads_close(vt, vj):
    """VLAD vectors within atol 1e-5 before the signed square root
    (sign(v) v^2 undoes it) and in every pairwise similarity.  The root
    itself amplifies the float32 rounding of a residual component that is
    zero in exact arithmetic (d sqrt(v) = dv / 2 sqrt(v)): two summation
    orders leave such a component at 0 in one package and ~1.6e-5 in the
    other, too small to move any similarity."""
    np.testing.assert_allclose(np.sign(vt) * vt * vt, np.sign(vj) * vj * vj,
                               atol=1e-5)
    np.testing.assert_allclose(vt @ vt.T, vj @ vj.T, atol=1e-5)


def test_train_vocabulary_and_encode_vlad_match_jax():
    """The same default_rng draws give the JAX package's vocabulary (atol
    1e-4), and with its vocabulary the same VLAD vectors (atol 1e-5, see
    _assert_vlads_close), images of different descriptor counts and an
    empty one included."""
    rng = np.random.default_rng(5)
    descs, _ = _make_scene_descs(rng)
    descs[3] = descs[3][:41]
    descs.append(np.zeros((0, 128), np.uint8))
    vj = JR.train_vocabulary(descs, num_words=16, seed=3)
    vt = TR.train_vocabulary(descs, num_words=16, seed=3, device="cpu")
    np.testing.assert_allclose(vt, vj, atol=1e-4)
    ej = JR.encode_vlad(descs, vj)
    et = TR.encode_vlad(descs, vj, device="cpu")
    assert et.shape == (len(descs), 16 * 129)
    _assert_vlads_close(et, ej)
    assert np.all(et[-1] == 0)


def test_ranks_match_jax_on_separated_scenes():
    """build_retrieval end to end: the same ranks as the JAX package on
    three well-separated scenes."""
    rng = np.random.default_rng(1)
    descs, scene_of = _make_scene_descs(rng)
    rj, vj = JR.build_retrieval(descs, num_words=16, topk=5)
    rt, vt = TR.build_retrieval(descs, num_words=16, topk=5, device="cpu")
    np.testing.assert_array_equal(rt, rj)
    _assert_vlads_close(vt, vj)


def test_ranks_ties_go_to_the_lower_index():
    """Exact ties in similarity rank the lower image index first, as
    jax.lax.top_k does: duplicated vectors, and whole rows of equal
    scores; the port's ranks equal the JAX package's there."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(4, 32)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    # rows 1, 3, 6 identical; rows 0, 5 identical; row 7 orthogonal-ish
    vl = base[[0, 1, 2, 1, 3, 0, 1, 2]].copy()
    vl[7] = 0.0
    rt = TR.rank_images(vl, topk=7, device="cpu")
    rj = JR.rank_images(vl, topk=7)
    np.testing.assert_array_equal(rt, rj)
    assert list(rt[1][:2]) == [3, 6] and list(rt[6][:2]) == [1, 3]
    # an all-zero query ties with every other image: ascending order
    assert list(rt[7]) == [0, 1, 2, 3, 4, 5, 6]


def test_write_retrieval_text_byte_equal(tmp_path):
    """write_retrieval_text writes the JAX package's bytes, which
    load_retrieval_rank reads back as ranks_to_id2rank."""
    ranks = np.array([[1, 2], [0, 2], [1, 0]], np.int32)
    names = ["a.png", "b.png", "c.png"]
    JR.write_retrieval_text(str(tmp_path / "j.txt"), names, ranks)
    TR.write_retrieval_text(str(tmp_path / "t.txt"), names, ranks)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    got = IOF.load_retrieval_rank(str(tmp_path / "t.txt"),
                                  {n: i for i, n in enumerate(names)})
    assert got == TR.ranks_to_id2rank(ranks) == JR.ranks_to_id2rank(ranks)


# tests/test_retrieval.py:33-90, on the port


def test_kmeans_reduces_quantization_error():
    alld, init = _sample_and_init(k=16)
    x = torch.from_numpy(alld)
    _, err0 = TR._kmeans(x, torch.from_numpy(init), 0)
    _, err10 = TR._kmeans(x, torch.from_numpy(init), 10)
    assert float(err10) < float(err0)
    assert float(err10) >= -1e-4


def test_retrieval_ranks_same_scene_first():
    rng = np.random.default_rng(1)
    descs, scene_of = _make_scene_descs(rng)
    ranks, vlads = TR.build_retrieval(descs, num_words=16, topk=3,
                                      device="cpu")
    assert np.allclose(np.linalg.norm(vlads, axis=1), 1.0, atol=1e-4)
    for i, row in enumerate(ranks):
        assert all(scene_of[j] == scene_of[i] for j in row), (i, row)
        assert i not in row


def test_vlad_invariant_to_descriptor_order_and_padding():
    rng = np.random.default_rng(2)
    descs, _ = _make_scene_descs(rng, n_scenes=1, imgs_per_scene=2)
    vocab = TR.train_vocabulary(descs, num_words=8, seed=0, device="cpu")
    d = descs[0]
    v1 = TR.encode_vlad([d], vocab, device="cpu")
    v2 = TR.encode_vlad([d[::-1].copy()], vocab, device="cpu")
    assert np.allclose(v1, v2, atol=1e-4)
    v3 = TR.encode_vlad([d, descs[1][:37]], vocab, device="cpu")[0]
    assert np.allclose(v1[0], v3, atol=1e-4)


def test_empty_and_tiny_inputs():
    vocab = TR.train_vocabulary([], num_words=8, device="cpu")
    assert vocab.shape == (8, 128)
    rng = np.random.default_rng(3)
    d = (np.abs(rng.normal(size=(5, 128))) * 40).astype(np.uint8)
    vocab = TR.train_vocabulary([d], num_words=8, seed=0, device="cpu")
    np.testing.assert_allclose(vocab, JR.train_vocabulary([d], num_words=8,
                                                          seed=0), atol=1e-4)
    vl = TR.encode_vlad([np.zeros((0, 128), np.uint8), d], vocab,
                        device="cpu")
    assert np.all(vl[0] == 0.0)
    assert TR.rank_images(vl, topk=5, device="cpu").shape == (2, 1)
