"""The port's snapshots (xrsfm_tpu_torch.base.snapshot, the mapper's
snapshot_every and resumption, run_reconstruction.main(resume=True) and
its CLI flags) on the CPU: the three cases of tests/test_snapshot.py, the
file format against the JAX package's writer, a snapshot of either
package resuming in the other, and a resumed run of the stage's entry
point."""

import os

import numpy as np
import pytest
import torch

from synthetic import make_scene
from test_torch_mapper import build_map
from xrsfm_tpu.base import snapshot as JS
from xrsfm_tpu.base.map import SfMMap as JMap
from xrsfm_tpu.mapper import IncrementalMapper as JIncrementalMapper
from xrsfm_tpu.mapper import MapperOptions as JMapperOptions
from xrsfm_tpu_torch import cli as TCLI
from xrsfm_tpu_torch.base import snapshot as TS
from xrsfm_tpu_torch.base.map import SfMMap as TMap
from xrsfm_tpu_torch.mapper import IncrementalMapper, MapperOptions
from xrsfm_tpu_torch.pipelines import run_reconstruction as TRR
from xrsfm_tpu_torch.utils import io_features as IOF

torch.set_num_threads(2)

SCENE = dict(n_cams=6, n_pts=150, seed=20, noise=0.0)


def _logging(cls):
    """Mapper subclass that keeps its log lines."""
    class _Mapper(cls):
        def _log(self, msg):
            self.log.append(msg)
    return _Mapper


def _port_mapper(opts):
    mapper = _logging(IncrementalMapper)(opts, device="cpu")
    mapper.log = []
    return mapper


def _assert_same_state(a, b):
    assert list(a.names) == list(b.names)
    np.testing.assert_array_equal(a.registered, b.registered)
    np.testing.assert_array_equal(a.registered_fail, b.registered_fail)
    np.testing.assert_array_equal(a.q, b.q)
    np.testing.assert_array_equal(a.t, b.t)
    assert (a.init_id1, a.init_id2) == (b.init_id1, b.init_id2)
    assert a.num_tracks == b.num_tracks
    nt = a.num_tracks
    for k in ("track_xyz", "track_valid", "track_error", "track_angle"):
        np.testing.assert_array_equal(getattr(a, k)[:nt], getattr(b, k)[:nt])
    assert [dict(o) for o in a.track_obs] == [dict(o) for o in b.track_obs]
    for f in range(a.num_frames):
        np.testing.assert_array_equal(a.track_of[f], b.track_of[f])
        np.testing.assert_array_equal(a.kps[f], b.kps[f])


@pytest.fixture(scope="module")
def full_map():
    m = build_map(TMap, make_scene(**SCENE))
    assert IncrementalMapper(MapperOptions(verbose=False),
                             device="cpu").reconstruct(m)
    return m


def test_snapshot_roundtrip_and_resume(full_map, tmp_path):
    """tests/test_snapshot.py's round trip: the loaded map holds the saved
    state; with the pairs re-attached its counters and correspondence
    search work.  The file holds what the JAX package's writer writes for
    the same map, array by array."""
    m = full_map
    path = str(tmp_path / "snap.npz")
    TS.save_snapshot(m, path)
    m2 = TS.load_snapshot(path)
    _assert_same_state(m, m2)
    for id1, id2, matches in m.pairs:
        m2.add_pair(id1, id2, matches)
    m2.build_correspondence_graph()
    m2.rebuild_visibility_counters()
    for f in range(m.num_frames):
        np.testing.assert_array_equal(m2.p3d_corr_cnt[f], m.p3d_corr_cnt[f])
    p2d, _tids = m2.search_correspondences(0)
    assert len(p2d) > 0
    jpath = str(tmp_path / "jax.npz")
    JS.save_snapshot(m, jpath)  # the JAX writer reads the map's attributes
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_midrun_checkpoint_then_resume(tmp_path):
    """A bounded run with snapshot_every=1 checkpoints; restore_into a
    fresh map, and the resumed reconstruction registers every frame
    without initializing again."""
    s = make_scene(**SCENE)
    path = str(tmp_path / "mid.npz")
    m1 = build_map(TMap, s)
    opts = MapperOptions(verbose=False, snapshot_every=1, snapshot_path=path,
                         max_registrations=2)
    assert IncrementalMapper(opts, device="cpu").reconstruct(m1)
    n1 = int(np.count_nonzero(m1.registered))
    assert 3 <= n1 < 6  # init pair + 2 registrations, stopped early
    m2 = TS.restore_into(build_map(TMap, s), path)
    assert int(np.count_nonzero(m2.registered)) == n1
    mapper = _port_mapper(MapperOptions(verbose=False))
    assert mapper.reconstruct(m2)
    assert int(np.count_nonzero(m2.registered)) == 6
    assert f"resuming with {n1} registered frames" in mapper.log
    assert not any(msg.startswith("initialized") for msg in mapper.log)


def test_restore_into_rejects_other_dataset(full_map, tmp_path):
    path = str(tmp_path / "snap.npz")
    TS.save_snapshot(full_map, path)
    other = build_map(TMap, make_scene(n_cams=5, n_pts=100, seed=3))
    with pytest.raises(ValueError, match="different dataset"):
        TS.restore_into(other, path)


def test_snapshots_resume_across_packages(tmp_path):
    """A snapshot the JAX package's writer wrote of a mid-run map resumes
    in the port, and one the port's mapper wrote mid-run resumes in the
    JAX package's mapper: both packages' readers restore the same state
    from either file, and each resumed run finishes with every frame
    registered.  (One JAX mapper run: its compiles take most of a minute
    here.)"""
    s = make_scene(**SCENE)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    mid = build_map(TMap, s)
    assert IncrementalMapper(MapperOptions(
        verbose=False, snapshot_every=1, snapshot_path=tpath,
        max_registrations=2), device="cpu").reconstruct(mid)
    JS.save_snapshot(TS.load_snapshot(tpath), jpath)
    mt = TS.restore_into(build_map(TMap, s), jpath)
    _assert_same_state(JS.restore_into(build_map(JMap, s), jpath), mt)
    _assert_same_state(JS.load_snapshot(jpath), TS.load_snapshot(jpath))
    mapper = _port_mapper(MapperOptions(verbose=False))
    assert mapper.reconstruct(mt)
    assert mt.registered.all()
    assert any(msg.startswith("resuming with") for msg in mapper.log)

    mj2 = JS.restore_into(build_map(JMap, s), tpath)
    _assert_same_state(TS.restore_into(build_map(TMap, s), tpath), mj2)
    jmapper = _logging(JIncrementalMapper)(JMapperOptions(verbose=False))
    jmapper.log = []
    assert jmapper.reconstruct(mj2)
    assert mj2.registered.all()
    assert any(msg.startswith("resuming with") for msg in jmapper.log)


def _write_bins(s, bins, f=500.0, cx=320.0, cy=240.0):
    """ftr.bin, fp.bin and camera.txt of a make_scene scene: exact pixel
    projections, pairs within three frames with every match an inlier."""
    os.makedirs(bins, exist_ok=True)
    n_cams, n_pts = s["uv"].shape[:2]
    feats = []
    for i in range(n_cams):
        kp = np.zeros((n_pts, 4), np.float32)
        kp[:, :2] = s["uv"][i] * f + np.array([cx, cy])
        feats.append(IOF.FrameFeatures(f"img{i:04d}.png", kp,
                                       np.zeros((n_pts, 128), np.uint8)))
    IOF.write_features(os.path.join(bins, "ftr.bin"), feats)
    idx = np.arange(n_pts, dtype=np.int32)
    pairs = [IOF.FramePairData(id1=i, id2=j,
                               matches=np.stack([idx, idx], 1),
                               distances=np.zeros(n_pts), E=np.eye(3),
                               inlier_num=n_pts,
                               inlier_mask=np.ones(n_pts, bool))
             for i in range(n_cams) for j in range(i + 1, min(i + 4, n_cams))]
    IOF.write_frame_pairs(os.path.join(bins, "fp.bin"), pairs)
    cam = os.path.join(bins, "camera.txt")
    with open(cam, "w") as fh:
        fh.write(f"0 PINHOLE 640 480 {f} {f} {cx} {cy}\n")
    return cam


def test_run_reconstruction_resumes(tmp_path, capsys):
    """run_reconstruction.main with snapshot_every writes
    <output_dir>/snapshot.npz; main(resume=True) restores it and finishes
    every frame; the CLI's --resume and --snapshot_every do the same."""
    s = make_scene(n_cams=8, n_pts=150, seed=20, noise=0.0)
    bins = str(tmp_path / "bins")
    cam = _write_bins(s, bins)
    out = str(tmp_path / "out")
    m = TRR.main(bins, cam, out, snapshot_every=2,
                 opts=MapperOptions(verbose=False, max_registrations=4,
                                    batch_registration=1),
                 device="cpu")
    snap = os.path.join(out, "snapshot.npz")
    with np.load(snap) as z:
        n1 = int(np.count_nonzero(z["registered"]))
    assert 3 <= n1 <= int(np.count_nonzero(m.registered)) < 8
    stats = {}
    m2 = TRR.main(bins, cam, out, resume=True, stats=stats,
                  opts=MapperOptions(verbose=False), device="cpu")
    assert m2.registered.all()
    assert f"({n1} frames registered)" in capsys.readouterr().out
    assert stats["mapper"].registered == 8 - n1
    out2 = str(tmp_path / "cli")
    TCLI.main(["run_reconstruction", bins, cam, out2, "--snapshot_every",
               "3", "--device", "cpu"])
    assert os.path.exists(os.path.join(out2, "snapshot.npz"))
    TCLI.main(["run_reconstruction", bins, cam, out2, "--resume",
               "--device", "cpu"])
    assert "resumed from" in capsys.readouterr().out
