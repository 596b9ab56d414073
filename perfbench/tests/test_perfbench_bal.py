"""The BAL-shaped generator: the configuration's counts exactly, one seed
one problem, seeds far past 32 bits, local problems as the traffic says;
and the row kernels' least time, which counts the problem's observations
and not the padded slots of a packing."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench.gen import bal
from perfbench.lib import peaks

torch.set_num_threads(2)
PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name="bal-dubrovnik356"):
    with open(os.path.join(PKG, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_counts_equal_the_configuration(seed):
    cfg = _cfg()
    p = bal.make_problem(cfg, seed)["start"]
    assert len(p["cam_q"]) == cfg["n_cameras"] == 356
    assert len(p["points"]) == cfg["n_points"] == 226730
    assert len(p["obs_cam"]) == cfg["n_observations"] == 1255268
    assert np.bincount(p["obs_pt"]).min() >= cfg["min_track"]
    assert np.unique(p["obs_cam"]).size == cfg["n_cameras"]


def test_one_seed_one_problem():
    cfg = dict(_cfg(), n_cameras=40, n_points=3000, n_observations=16000)
    a, b = bal.make_problem(cfg, 7), bal.make_problem(cfg, 7)
    c = bal.make_problem(cfg, 8)
    for k in a["start"]:
        np.testing.assert_array_equal(a["start"][k], b["start"][k])
    assert not np.array_equal(a["start"]["obs_uv"], c["start"]["obs_uv"])


def test_local_problems():
    cfg = dict(_cfg(), n_cameras=60, n_points=5000, n_observations=27000)
    start = bal.make_problem(cfg, 3)["start"]
    cov = bal.covisibility(start)
    cs = bal.local_centers(60, 8, 3)
    assert len(set(cs.tolist())) == 8
    for c in cs:
        lp = bal.local_problem(start, cov, int(c), 5)
        assert (~lp["fix_cam"]).sum() == 6
        # every point a free camera sees, with all its observations
        free_ids = np.unique(lp["obs_cam"][~lp["fix_cam"][lp["obs_cam"]]])
        assert len(free_ids) == 6
        n_pts = len(lp["points"])
        assert np.bincount(lp["obs_pt"], minlength=n_pts).min() >= 2


def test_roofline_counts_observations_not_padding():
    from xrsfm_tpu_torch.optim import ba as BA

    cfg = dict(_cfg(), n_cameras=30, n_points=2000, n_observations=11000)
    arr = bal.make_problem(cfg, 5)["start"]
    prob = BA.BAProblem.from_numpy("cpu", **arr)
    shapes, bounds = [], []
    for cam_width, bucket_lo in ((128, 8), (32, 32)):
        p, ell = BA.pack_camera_major(prob, cam_width=cam_width,
                                      bucket_lo=bucket_lo)
        shapes.append((ell.cam.slots.numel(), ell.pt.slots.numel()))
        O = int((p.obs_w > 0).sum())
        C, P = p.cam_q.shape[0], p.points.shape[0]
        bounds.append([peaks.least_seconds(k, C, P, O, D)
                       for k in ("cam", "pt") for D in (6, 14)])
    assert shapes[0] != shapes[1]
    assert bounds[0] == bounds[1]
