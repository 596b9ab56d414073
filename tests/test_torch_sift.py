"""The port's SIFT extractor (xrsfm_tpu_torch.ops.sift) against the JAX
package's, on the same seeded textures, on the CPU.

Both run the same float32 algorithm; their convolutions sum in different
orders, so pyramid values differ in the last bits and refined keypoint
positions by ~1e-4 px, more where the 3x3 quadratic fit is
ill-conditioned."""

import functools

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from xrsfm_tpu.ops import sift as JS
from xrsfm_tpu_torch.ops import sift as TS

from test_sift import make_texture

torch.set_num_threads(2)

CASES = [(fo, seed) for fo in (0, -1) for seed in (0, 1)]


def _opts(mod, fo):
    return mod.SiftOptions(num_octaves=3, features_per_octave=512,
                           max_features=1024, first_octave=fo)


@functools.lru_cache(maxsize=None)
def _extract(fo, seed):
    img, _ = make_texture(128, 160, seed=seed, n_blobs=60)
    jk, jd = JS.SiftExtractor(_opts(JS, fo)).extract(img)
    tk, td = TS.SiftExtractor(_opts(TS, fo), device="cpu").extract(img)
    dist, nn = cKDTree(tk[:, :2]).query(jk[:, :2])
    return jk, jd, tk, td, dist, nn


def _agreeing(jk, tk, dist, nn):
    """JAX keypoints whose nearest port keypoint is within 2e-3 px, with
    sigma within 0.1% and angle within 5e-4 rad."""
    dsig = np.abs(tk[nn, 2] - jk[:, 2]) / jk[:, 2]
    dang = np.abs((tk[nn, 3] - jk[:, 3] + np.pi) % (2 * np.pi) - np.pi)
    return (dist < 2e-3) & (dsig < 1e-3) & (dang < 5e-4)


@pytest.mark.parametrize("fo,seed", CASES)
def test_sift_keypoints_match_jax(fo, seed):
    """Counts within 1 (observed equal); >= 98% of the JAX keypoints have a
    port keypoint within 2e-3 px with sigma within 0.1% and angle within
    5e-4 rad (observed: 98.4% to 100%; the worst keypoint is 1.2e-2 px
    off, sigma 0.058%, angle 1.2e-4 rad)."""
    jk, _, tk, _, dist, nn = _extract(fo, seed)
    assert len(jk) > 50
    assert abs(len(tk) - len(jk)) <= 1
    ok = _agreeing(jk, tk, dist, nn)
    assert ok.mean() >= 0.98, ok.mean()


@pytest.mark.parametrize("fo,seed", CASES)
def test_sift_descriptors_match_jax(fo, seed):
    """On the agreeing keypoints: descriptor bytes within +-1 on >= 93% of
    them (observed 95.1% to 100%) and within +-8 on all (observed 4).
    The descriptor pass samples with nearest-neighbour taps, and a tap
    flips to the next pixel when a ~1e-4 px position difference carries
    it across a half-pixel boundary, so +-1 cannot hold everywhere."""
    jk, jd, tk, td, dist, nn = _extract(fo, seed)
    ok = _agreeing(jk, tk, dist, nn)
    diff = np.abs(td[nn[ok]].astype(int) - jd[ok].astype(int)).max(axis=1)
    assert np.mean(diff <= 1) >= 0.93, np.bincount(diff)
    assert diff.max() <= 8, np.bincount(diff)


def test_sift_extract_batch_matches_jax():
    """The batched uint8 path (the pipeline's): two 8-bit images in one
    batch, against the JAX package's extract_batch; per image, the
    keypoint criteria of test_sift_keypoints_match_jax."""
    imgs = [(make_texture(128, 160, seed=s, n_blobs=60)[0] * 255).astype(
        np.uint8) for s in (2, 3)]
    jb = JS.SiftExtractor(_opts(JS, 0)).extract_batch(imgs, batch=2)
    tb = TS.SiftExtractor(_opts(TS, 0), device="cpu").extract_batch(
        imgs, batch=2)
    for (jk, _), (tk, _) in zip(jb, tb):
        assert len(jk) > 50
        assert abs(len(tk) - len(jk)) <= 1
        dist, nn = cKDTree(tk[:, :2]).query(jk[:, :2])
        assert _agreeing(jk, tk, dist, nn).mean() >= 0.98
