"""The port's mapper (xrsfm_tpu_torch.base.map, .mapper, and
pipelines.run_reconstruction with its CLI twin) against the JAX package's,
on the CPU: map construction and state carried over, a reconstruction of
tests/synthetic.make_scene correspondences, the stage's entry points on
bins the port's own matching stage wrote, the loop-closure options, and
the options that once raised (several devices among them)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from synthetic import make_scene
from xrsfm_tpu.base.map import SfMMap as JMap
from xrsfm_tpu.mapper import MapperOptions as JMapperOptions
from xrsfm_tpu_torch import cli as TCLI
from xrsfm_tpu_torch.base.map import SfMMap as TMap
from xrsfm_tpu_torch.mapper import IncrementalMapper, MapperOptions
from xrsfm_tpu_torch.mapper import ba_glue
from xrsfm_tpu_torch.ops.umeyama import ate_rmse
from xrsfm_tpu_torch.optim import ba as TB
from xrsfm_tpu_torch.pipelines import run_matching as TRM
from xrsfm_tpu_torch.pipelines import run_reconstruction as TRR
from xrsfm_tpu_torch.utils import geometry as TG
from xrsfm_tpu_torch.utils import io_colmap as TIO
from xrsfm_tpu_torch.utils import synth
from xrsfm_tpu_torch.utils.options import from_jax_options

torch.set_num_threads(2)


def build_map(map_cls, s, f=500.0, cx=320.0, cy=240.0, window=3,
              noise_px=0.3, outlier_frac=0.03, seed=0, model_id=1,
              params=None):
    """tests/test_incremental.build_map_from_scene for either package's
    SfMMap: noisy pixel projections in shuffled per-frame order, pairs
    within `window` frames with a few wrong matches."""
    rng = np.random.default_rng(seed)
    n_cams, n_pts = s["uv"].shape[:2]
    m = map_cls()
    m.add_camera(0, model_id, params or [f, f, cx, cy], 640, 480)
    perms = []
    for i in range(n_cams):
        uv_px = s["uv"][i] * f + np.array([cx, cy], np.float32)
        uv_px = uv_px + rng.normal(scale=noise_px, size=uv_px.shape)
        perm = rng.permutation(n_pts)
        perms.append(np.argsort(perm))
        m.add_frame(f"img{i:04d}.png", 0, uv_px[perm].astype(np.float32))
    for i in range(n_cams):
        for j in range(i + 1, min(i + 1 + window, n_cams)):
            matches = np.stack([perms[i], perms[j]], axis=1).astype(np.int32)
            n_out = int(outlier_frac * len(matches))
            if n_out:
                rows = rng.choice(len(matches), n_out, replace=False)
                matches[rows, 1] = rng.integers(0, n_pts, n_out)
            m.add_pair(i, j, matches)
    m.build_correspondence_graph()
    return m


def _centers(q, t):
    return TG.pose_center_np(np.asarray(q, np.float64), np.asarray(t, np.float64))


@pytest.mark.parametrize("model_id,params", [
    (1, None), (4, [480.0, 520.0, 330.0, 250.0, -0.1, 0.02, 1e-3, -2e-3]),
])
def test_map_construction_matches_jax(model_id, params):
    """The same inputs give the same correspondence graph (exactly) and
    kps_norm within 1e-6 (float32 undistortion; a distorted OPENCV camera
    included), and the same registration candidates."""
    s = make_scene(n_cams=5, n_pts=80, seed=3)
    mj = build_map(JMap, s, model_id=model_id, params=params)
    mt = build_map(TMap, s, model_id=model_id, params=params)
    for f in range(5):
        np.testing.assert_allclose(mt.kps_norm[f], mj.kps_norm[f], atol=1e-6,
                                   rtol=0)
        for name in ("offsets", "other_frame", "other_p2d", "other_gkp"):
            np.testing.assert_array_equal(getattr(mt.corr[f], name),
                                          getattr(mj.corr[f], name))
    for m in (mj, mt):
        m.registered[[0, 1]] = True
        tid = m.new_track(np.zeros(3))
        m.add_observation(tid, 0, 5)
        m.add_observation(tid, 1, 7)
    np.testing.assert_array_equal(mt.ready_frames(1, 4), mj.ready_frames(1, 4))
    for a, b in zip(mt.search_correspondences(2), mj.search_correspondences(2)):
        np.testing.assert_array_equal(a, b)


def _state(m):
    return {k: getattr(m, k) for k in TMap._STATE + TMap._KEYFRAME_STATE
            if hasattr(m, k)}


def _assert_same_state(a, b):
    for k, va in _state(a).items():
        vb = getattr(b, k)
        if k == "corr":
            for ca, cb in zip(va, vb):
                for f in ("offsets", "other_frame", "other_p2d", "other_gkp"):
                    np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
        elif isinstance(va, list) and va and isinstance(va[0], np.ndarray):
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(x, y)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=k)
        elif k in ("cameras", "camera_models", "pairs"):
            assert repr(va) == repr(vb), k
        else:
            assert va == vb, k


def test_from_state_carries_a_jax_map_over_and_round_trips():
    """A JAX-package map with tracks, registrations and keyframe fields
    becomes a port map with the same state; the copy is independent; and
    port -> port round-trips."""
    s = make_scene(n_cams=5, n_pts=80, seed=4)
    mj = build_map(JMap, s)
    mj.registered[[0, 1]] = True
    mj.q[1] = [0.9, 0.1, 0.2, 0.3]
    mj.init_id1, mj.init_id2 = 0, 1
    for k in range(10):
        tid = mj.new_track(np.full(3, float(k)))
        mj.add_observations([tid, tid], 0, [k])
        mj.add_observation(tid, 1, k + 3)
    mj.delete_track(4)
    mj.is_keyframe = np.ones(5, bool)
    mj.ref_frame = np.full(5, -1, np.int64)
    mj.ref_rel_q = np.zeros((5, 4))
    mj.ref_rel_t = np.zeros((5, 3))
    mt = TMap.from_state(mj)
    assert isinstance(mt, TMap)
    _assert_same_state(mt, mj)
    np.testing.assert_array_equal(mt.ready_frames(1, 4), mj.ready_frames(1, 4))
    mt.track_xyz[0] = 99.0
    mt.kps_norm[0][0] = 99.0
    assert mj.track_xyz[0, 0] == 0.0 and mj.kps_norm[0][0, 0] != 99.0
    _assert_same_state(TMap.from_state(mt), mt)


def test_mapper_reconstructs_make_scene():
    """make_scene correspondences (6 cameras, 150 points, 0.3 px noise, 3%
    wrong matches; the JAX package's slow-tier scene): every frame
    registers, ATE < 0.05 after similarity alignment (the JAX test's
    gate), more than 100 tracks, and every BA solve ran on the CPU device
    the mapper was given."""
    s = make_scene(n_cams=6, n_pts=150, seed=20, noise=0.0)
    m = build_map(TMap, s)
    TB.reset_counts()
    mapper = IncrementalMapper(MapperOptions(verbose=False), device="cpu")
    assert mapper.reconstruct(m)
    assert int(np.count_nonzero(m.registered)) == 6
    ate = ate_rmse(_centers(s["q"], s["t"]), _centers(m.q, m.t))
    assert ate < 0.05, ate
    assert int(np.count_nonzero(m.track_valid)) > 100
    assert TB.COUNTS["solves_cpu"] > 0 and TB.COUNTS["solves_cuda"] == 0
    assert mapper.stats.registered == 4 and mapper.stats.time_total > 0


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    """A 6-image arc scene rendered by utils/synth (512x384, f=450, about
    750 features per image) and matched by the port's own matching stage
    on the CPU."""
    root = str(tmp_path_factory.mktemp("arc_recon"))
    synth.write_arc_dataset(root, n_cams=6)
    TRM.main(os.path.join(root, "images"), "", "sequential",
             os.path.join(root, "bins"), device="cpu")
    return root


def _gt_centers(root, names):
    gt = {}
    with open(os.path.join(root, "gt_poses.txt")) as f:
        for line in f:
            p = line.split()
            gt[p[0]] = _centers(np.array(p[1:5], float), np.array(p[5:8], float))
    return np.stack([gt[n] for n in names])


def _check_model(root, out):
    imgs = TIO.read_images_bin(os.path.join(out, "images.bin"))
    pts = TIO.read_points3d_bin(os.path.join(out, "points3D.bin"))
    cams = TIO.read_cameras_bin(os.path.join(out, "cameras.bin"))
    assert len(imgs) == 6 and len(pts) > 500 and len(cams) == 1
    ims = sorted(imgs.values(), key=lambda im: im.name)
    est = np.stack([_centers(im.qvec, im.tvec) for im in ims])
    ref = _gt_centers(root, [im.name for im in ims])
    span = np.linalg.norm(ref.max(0) - ref.min(0))
    assert ate_rmse(ref, est) < 0.01 * span
    traj = open(os.path.join(out, "trajectory.txt")).read().splitlines()
    assert len(traj) == 6


def test_run_reconstruction_main_on_port_bins(bins):
    """run_reconstruction.main on ftr.bin / fp.bin written by the port's
    matching stage: all 6 frames registered, ATE under 1% of the
    trajectory span, the COLMAP binaries and trajectory.txt read back;
    stats carry the mapper's phase seconds."""
    out = os.path.join(bins, "model_main")
    stats = {}
    m = TRR.main(os.path.join(bins, "bins"), os.path.join(bins, "camera.txt"),
                 out, stats=stats, device="cpu")
    assert m is not None and int(np.count_nonzero(m.registered)) == 6
    assert stats["mapper"].registered == 4 and stats["seconds"] > 0
    _check_model(bins, out)


def test_run_reconstruction_cli_on_port_bins(bins):
    out = os.path.join(bins, "model_cli")
    TCLI.main(["run_reconstruction", os.path.join(bins, "bins"),
               os.path.join(bins, "camera.txt"), out, "--init_id1", "1",
               "--init_id2", "3", "--device", "cpu"])
    _check_model(bins, out)


def test_cuda_device_raises_without_a_gpu(tmp_path):
    """No fallback: device="cuda" without a GPU is an error, from the entry
    point, the CLI and the mapper."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRR.main(str(tmp_path), str(tmp_path / "camera.txt"),
                 str(tmp_path / "out"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCLI.main(["run_reconstruction", str(tmp_path),
                   str(tmp_path / "camera.txt"), str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IncrementalMapper(MapperOptions(), device="cuda")


@pytest.mark.parametrize("change,item", [
    # refine_intrinsics runs since intrinsics BA was ported
    # (tests/test_torch_unordered.py), snapshot_every since snapshots were
    # (tests/test_torch_snapshot.py), n_devices since parallel/ was
    # (tests/test_torch_parallel.py); the case keeps its id
    pytest.param(dict(n_devices=2), "parallel/", id="change1-item 5"),
])
def test_unported_options_raise(bins, change, item):
    """The last option that raised NotImplementedError, n_devices = 2, now
    runs on a mesh of 2 CPU shards, from the mapper and from the entry
    point (6/6 registered, every global solve sharded), and raises
    RuntimeError on CUDA with fewer GPUs than asked (on a host without
    CUDA, any)."""
    mapper = IncrementalMapper(dataclasses.replace(MapperOptions(), **change),
                               device="cpu")
    assert mapper.mesh.size == 2 and mapper.mesh.home.type == "cpu"
    TB.reset_counts()
    out = os.path.join(bins, "model_mesh")
    m = TRR.main(os.path.join(bins, "bins"), os.path.join(bins, "camera.txt"),
                 out, device="cpu", **change)
    assert m is not None and int(np.count_nonzero(m.registered)) == 6
    assert TB.COUNTS["dist_solves_cpu"] > 0
    _check_model(bins, out)
    with pytest.raises(RuntimeError):
        IncrementalMapper(MapperOptions(
            n_devices=torch.cuda.device_count() + 1), device="cuda")


@pytest.mark.parametrize("option", ["correct_pose", "global_polish",
                                    "rot_avg_polish"])
def test_loop_options_run_on_cpu(option):
    """The loop-closure options, once NotImplementedError, run: a 10-frame
    make_scene reconstruction with the option registers every frame at ATE
    < 0.05; correct_pose runs the correction check on every frame, and the
    polish options measure the pairs and trial the rewrite (kept, reverted
    or skipped by its gates), all on the CPU device."""
    from xrsfm_tpu_torch.optim import rot_avg

    s = make_scene(n_cams=10, n_pts=80, seed=21, noise=0.0)
    m = build_map(TMap, s)
    rot_avg.reset_counts()
    TB.reset_counts()
    mapper = IncrementalMapper(
        MapperOptions(verbose=False, **{option: True}), device="cpu")
    assert mapper.reconstruct(m)
    assert m.registered.all()
    assert ate_rmse(_centers(s["q"], s["t"]), _centers(m.q, m.t)) < 0.05
    assert TB.COUNTS["solves_cuda"] == 0
    if option == "correct_pose":
        assert mapper.stats.time_check > 0 and mapper.stats.polish == "off"
    else:
        assert mapper.stats.polish in ("kept", "reverted", "skipped")
        assert rot_avg.COUNTS["measure_cpu"] >= 1
        assert rot_avg.COUNTS["measure_cuda"] == 0


def test_unported_entry_options_raise(tmp_path):
    """The mesh arguments that raised NotImplementedError now run:
    run_ba(mesh=) on a make_scene reconstruction solves on 4 CPU shards to
    within 1% of the single-device cost, and rec_1dsfm with more CUDA
    devices than exist raises RuntimeError (no fallback)."""
    from xrsfm_tpu_torch.parallel.mesh import make_mesh
    from xrsfm_tpu_torch.pipelines import rec_1dsfm

    s = make_scene(n_cams=6, n_pts=150, seed=20, noise=0.0)
    m = build_map(TMap, s)
    assert IncrementalMapper(MapperOptions(verbose=False),
                             device="cpu").reconstruct(m)
    frames = list(np.nonzero(m.registered)[0])
    m1 = TMap.from_state(m)
    TB.reset_counts()
    res4 = ba_glue.run_ba(m, frames, mesh=make_mesh(4, "cpu"), device="cpu")
    res1 = ba_glue.run_ba(m1, frames, device="cpu")
    assert TB.COUNTS["dist_solves_cpu"] == 1 and TB.COUNTS["solves_cpu"] == 1
    assert abs(res4.final_cost - res1.final_cost) <= 0.01 * res1.final_cost
    assert res4.iters >= 1 and res4.n_obs == res1.n_obs > 0
    assert ate_rmse(_centers(m1.q, m1.t), _centers(m.q, m.t)) < 1e-3
    with pytest.raises(RuntimeError):
        rec_1dsfm.main(str(tmp_path), "", str(tmp_path / "o"),
                       n_devices=torch.cuda.device_count() + 1, device="cuda")


def test_mapper_options_convert_from_jax():
    """from_jax_options carries MapperOptions over field by field, nested
    init / reg / tri options included, from a dataclass or a dict; and
    ErrorCorrectOptions and BAOptions, whose fields match the JAX
    package's."""
    from xrsfm_tpu.mapper.error_correct import ErrorCorrectOptions as JEC
    from xrsfm_tpu.mapper.initialize import InitOptions as JInit
    from xrsfm_tpu.mapper.triangulate import TriOptions as JTri
    from xrsfm_tpu.optim.ba import BAOptions as JBA
    from xrsfm_tpu_torch.mapper.error_correct import ErrorCorrectOptions

    jopt = JMapperOptions(gba_iters=7, init=JInit(min_points=33),
                          tri=JTri(tri_px=5.0))
    got = from_jax_options(jopt)
    assert type(got) is MapperOptions
    assert dataclasses.asdict(got) == dataclasses.asdict(jopt)
    assert from_jax_options(dataclasses.asdict(jopt)) == got
    assert {f.name for f in dataclasses.fields(MapperOptions)} == \
        {f.name for f in dataclasses.fields(JMapperOptions)}
    assert from_jax_options(JTri(filter_px=3.0)).filter_px == 3.0
    for jcls, tcls, kw in ((JEC, ErrorCorrectOptions, dict(min_covis_engage=7,
                                                          loop_edge_weight=2.0)),
                           (JBA, TB.BAOptions, dict(max_iters=60, precise=True))):
        got = from_jax_options(jcls(**kw))
        assert type(got) is tcls
        assert dataclasses.asdict(got) == dataclasses.asdict(jcls(**kw))
        assert from_jax_options(dataclasses.asdict(jcls(**kw))) == got
        assert ({f.name for f in dataclasses.fields(tcls)}
                == {f.name for f in dataclasses.fields(jcls)})


@pytest.mark.slow
def test_port_and_jax_mappers_agree_on_make_scene():
    """The port's mapper and the JAX package's on the same make_scene map
    (JIT-bound in JAX, hence slow): both register every frame, both ATEs
    under 0.05, within a factor of 3 of each other (or both under 5e-3),
    and track counts within 10%."""
    from xrsfm_tpu.mapper import IncrementalMapper as JMapper

    s = make_scene(n_cams=6, n_pts=150, seed=20, noise=0.0)
    mj, mt = build_map(JMap, s), build_map(TMap, s)
    assert JMapper(JMapperOptions(verbose=False)).reconstruct(mj)
    assert IncrementalMapper(MapperOptions(verbose=False),
                             device="cpu").reconstruct(mt)
    ref = _centers(s["q"], s["t"])
    ate_j = ate_rmse(ref, _centers(mj.q, mj.t))
    ate_t = ate_rmse(ref, _centers(mt.q, mt.t))
    assert mj.registered.all() and mt.registered.all()
    assert ate_j < 0.05 and ate_t < 0.05
    assert ate_t <= max(3 * ate_j, 5e-3), (ate_t, ate_j)
    nj, nt = int(mj.track_valid.sum()), int(mt.track_valid.sum())
    assert abs(nt - nj) <= 0.1 * nj
