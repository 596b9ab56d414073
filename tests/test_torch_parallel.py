"""The port's parallel/ (xrsfm_tpu_torch.parallel: mesh, checksum,
dist_matching, dist_ba) against the JAX package's (xrsfm_tpu/parallel) on
the same seeded numpy inputs, on the CPU: the JAX side on its 8-device
virtual mesh (tests/conftest.py), the port's on meshes of virtual CPU
shards, and the multi-process axis on two Gloo processes.

The JAX package's distributed step runs bf16 Schur products and the
port's float32, so the BA gates are tests/test_dist_ba.py's: rms under
0.6 px on both sides, |rms_port - rms_jax| < 0.2 px, final-cost parity
under 1%, focal within 1%.  Sharded against single-device, the port
holds matching and verification bit-equal and BA cost parity under 1%."""

import dataclasses
import json
import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import torch_dist_worker
from synthetic import make_scene
from test_ba import build_problem, perturb, rms_px as _jrms
from xrsfm_tpu.parallel import checksum as JC
from xrsfm_tpu.parallel.dist_ba import solve_distributed as j_solve_distributed
from xrsfm_tpu.parallel.dist_matching import match_pairs_sharded as j_match_sharded
from xrsfm_tpu_torch.feature import matching as TFM
from xrsfm_tpu_torch.ops import matching as TOM
from xrsfm_tpu_torch.optim import ba as TB
from xrsfm_tpu_torch.parallel import checksum as TC
from xrsfm_tpu_torch.parallel import dist_ba, mesh as TMESH
from xrsfm_tpu_torch.parallel.dist_matching import match_pairs_sharded
from xrsfm_tpu_torch.pipelines import run_matching as TRM
from xrsfm_tpu_torch.utils import camera as TCam
from xrsfm_tpu_torch.utils import io_features as TIO
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _jmesh(axis="obs"):
    return JMesh(np.array(jax.devices()), axis_names=(axis,))


# --- checksums -------------------------------------------------------------

_DTYPES = ["float32", "float64", "bfloat16", "float16", "int8", "uint8",
           "int16", "uint16", "int32", "int64", "uint32", "bool"]


def _array(dtype, seed=0, n=777):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.uniform(size=n) > 0.5
    if dtype in ("float32", "float64", "float16", "bfloat16"):
        return (rng.normal(size=n) * 300).astype(
            np.float32 if dtype == "bfloat16" else dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_array_checksum_equals_jax(dtype):
    """The port's number is the JAX package's on the same values, for every
    dtype the JAX function widens, bit-casts or casts; bf16 from the same
    float32 values, rounded alike."""
    a = _array(dtype)
    if dtype == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        t = torch.from_numpy(a).to(torch.bfloat16)
        assert np.array_equal(np.asarray(j).view(np.uint16),
                              t.view(torch.int16).numpy().view(np.uint16))
    else:
        j, t = jnp.asarray(a), torch.from_numpy(a)
    assert TC.array_checksum(t) == int(JC.array_checksum(j))


def test_pytree_checksum_equals_jax_with_paths():
    """Tree paths spelled as jax.tree_util.keystr spells them, for nested
    dicts (keys sorted), lists and tuples; swapped leaves of equal content
    change the number."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.integers(0, 9, 7).astype(np.int32)
    tree = {"t": [a, (b, a[:2])], "q": {"z": b, "a": [a.T.copy()]},
            "s": 1.5, "k": 3, "f": True}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    assert TC.pytree_checksum(tree) == JC.pytree_checksum(jtree)
    ttree = {"t": [torch.from_numpy(a), (torch.from_numpy(b),
                                         torch.from_numpy(a[:2]))],
             "q": {"z": torch.from_numpy(b), "a": [torch.from_numpy(a).T]},
             "s": 1.5, "k": 3, "f": True}
    assert TC.pytree_checksum(ttree) == JC.pytree_checksum(jtree)
    x, y = np.ones(8, np.float32), np.zeros(8, np.float32)
    assert (TC.pytree_checksum({"q": x, "t": y})
            != TC.pytree_checksum({"q": y, "t": x}))


def test_checksum_shard_invariant():
    """The JAX package's checksum of an array sharded over its 8 devices is
    the port's of the same values, contiguous or a strided view."""
    x = np.arange(4096, dtype=np.float32).reshape(64, 64) * 0.37
    sharded = jax.device_put(x, NamedSharding(_jmesh("d"), P("d")))
    t = torch.from_numpy(x.T.copy()).T  # a transposed view of the values
    assert not t.is_contiguous()
    assert TC.array_checksum(t) == int(JC.array_checksum(sharded))
    assert TC.array_checksum(torch.from_numpy(x)) == TC.array_checksum(t)


def test_checksum_one_ulp_and_position():
    x = np.arange(512, dtype=np.float32)
    y = x.copy()
    y[317] = np.nextafter(y[317], np.inf)  # one ulp
    assert TC.array_checksum(x) != TC.array_checksum(y)
    assert TC.array_checksum(np.array([1.0, 2.0], np.float32)) != \
        TC.array_checksum(np.array([2.0, 1.0], np.float32))


# --- the mesh --------------------------------------------------------------

def test_make_mesh_raises_without_enough_gpus():
    """No fallback: more CUDA devices than exist is an error (on a host
    without CUDA, any)."""
    with pytest.raises(RuntimeError):
        TMESH.make_mesh(torch.cuda.device_count() + 1, "cuda")
    m = TMESH.make_mesh(3, "cpu", axis="pairs")
    assert m.devices == (CPU,) * 3 and m.shape == {"pairs": 3}
    pod = TMESH.Mesh([CPU] * 8, ("dcn", "ici"), shape=(2, 4))
    assert pod.size == 8 and pod.home == CPU and pod.group is None
    with pytest.raises(ValueError):
        TMESH.Mesh([CPU] * 8, ("dcn", "ici"), shape=(3, 4))
    assert TMESH.initialize_distributed() == (1, 0)  # one process: no-op


# --- sharded matching ------------------------------------------------------

@pytest.mark.parametrize("planted", [False, True])
def test_match_pairs_sharded_equals_single_device_and_jax(planted):
    """tests/test_dist_ba.py's descriptors (uniform noise, whose norms pass
    the 512 of SIFT's quantization: no pair passes the ratio test), and
    unit descriptors scaled to 512 with 96 of each frame planted, shuffled
    and jittered by +-2, in the next: 5 pairs over 8 CPU shards equal the
    port's single-device match_descriptors and the JAX package's
    match_pairs_sharded on its 8-device mesh, match for match."""
    rng = np.random.default_rng(0)
    F, K = 6, 128
    descs = rng.integers(0, 90, size=(F, K, 128), dtype=np.uint8)
    masks = np.ones((F, K), bool)
    if planted:
        v = rng.uniform(size=(F, K, 128))
        descs = np.round(512 * v / np.linalg.norm(v, axis=-1, keepdims=True))
        for f in range(1, F):
            rows = rng.permutation(K)[:96]
            jitter = rng.integers(-2, 3, size=(96, 128))
            descs[f, rows] = np.clip(descs[f - 1, :96] + jitter, 0, 255)
        descs = descs.astype(np.uint8)
        masks[3, 100:] = False
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]
    TOM.reset_launch_counts()
    m_sh, c_sh, d_sh = match_pairs_sharded(TMESH.make_mesh(8, "cpu", "pairs"),
                                           descs, masks, pairs, max_matches=K)
    assert TOM.LAUNCHES["topstats_plain"] == 8
    m_j, c_j, d_j = j_match_sharded(_jmesh("pairs"), descs, masks, pairs,
                                    max_matches=K)
    assert np.array_equal(m_sh, np.asarray(m_j))
    assert np.array_equal(c_sh, np.asarray(c_j))
    np.testing.assert_allclose(d_sh, np.asarray(d_j), atol=1e-6, rtol=0)
    for k, (i, j) in enumerate(pairs):
        m1, c1, d1 = TOM.match_descriptors(
            *(torch.from_numpy(a) for a in (descs[i], descs[j], masks[i],
                                            masks[j])), 0.7, 0.8, K)
        assert int(c1) == int(c_sh[k])
        assert (int(c1) > 40) == planted
        assert np.array_equal(m1.numpy(), m_sh[k])
        assert np.array_equal(d1.numpy(), d_sh[k])


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The unordered landmark ring of utils/synth (16 frames, seed 1;
    matchable descriptors): its features and sequential pairs."""
    ws = str(tmp_path_factory.mktemp("ring"))
    names, _, _ = synth.write_unordered_workspace(ws, "unordered", 16, 1)
    return ws, names, TIO.read_features(os.path.join(ws, "ftr.bin"))


def _pair_bits(pairs):
    return [(p.id1, p.id2, p.inlier_num, p.matches.tobytes(),
             p.distances.tobytes(), p.E.tobytes(), p.inlier_mask.tobytes())
            for p in pairs]


def test_match_and_verify_sharded_is_bit_equal(ring):
    """match_and_verify_pairs over 4 CPU shards (chunks of 64 pairs, the
    last one partial) verifies the same pairs as on one device, with the
    same matches, distances, F and inlier masks bit for bit."""
    _, names, feats = ring
    pairs = TFM.sequential_pairs(len(names), TFM.MatchingOptions())
    assert len(pairs) > 64 and len(pairs) % 64
    one = TFM.match_and_verify_pairs(feats, pairs, verbose=False,
                                     device="cpu")
    four = TFM.match_and_verify_pairs(feats, pairs, verbose=False,
                                      mesh=TMESH.make_mesh(4, "cpu"))
    assert len(one) > 30
    assert _pair_bits(four) == _pair_bits(one)


def test_run_matching_n_devices_writes_same_fp_bin(ring, tmp_path):
    """run_matching.main(n_devices=4, device="cpu") writes the fp.bin bytes
    of n_devices=1 (features from the cached ftr.bin)."""
    ws, names, _ = ring
    images = tmp_path / "images"
    images.mkdir()
    for n in names:
        (images / n).touch()
    out = {}
    for n_dev in (1, 4):
        d = tmp_path / f"out{n_dev}"
        d.mkdir()
        for f in ("ftr.bin", "size.bin"):
            (d / f).write_bytes(open(os.path.join(ws, f), "rb").read())
        TRM.main(str(images), "", "sequential", str(d), n_devices=n_dev,
                 device="cpu")
        out[n_dev] = (d / "fp.bin").read_bytes()
    assert len(out[1]) > 1000 and out[4] == out[1]


# --- distributed bundle adjustment -----------------------------------------

def _port(jp, **extra):
    """The port's BAProblem of a JAX BAProblem (tests/test_ba.py's)."""
    arrays = {f.name: getattr(jp, f.name, None)
              for f in dataclasses.fields(TB.BAProblem)}
    arrays.update(extra)
    return TB.BAProblem.from_numpy(
        "cpu", **{k: (None if v is None else np.asarray(v))
                  for k, v in arrays.items()})


def _rms(p):
    r, _ = TB._residuals_only(p)
    m = p.obs_w > 0
    return float(torch.sqrt(((r * r).sum(-1) * m).sum() / m.sum()))


def _state(p):
    return {"q": p.cam_q, "t": p.cam_t, "x": p.points}


@pytest.fixture(scope="module")
def pose_problem():
    """tests/test_dist_ba.py's problem: 5 cameras, 80 points, 0.2 px noise
    (seed 42), perturbed (seed 43); the JAX package's 8-device solve."""
    p0, _ = build_problem(n_cams=5, n_pts=80, noise_px=0.2, seed=42)
    p_bad = perturb(p0, seed=43)
    p_j, cost_j = j_solve_distributed(_jmesh(), p_bad, max_iters=15)
    return p_bad, p_j, float(cost_j)


def test_solve_distributed_pose_only_matches_jax_and_single(pose_problem):
    """8 CPU shards, 15 iterations: at the noise floor (rms < 0.6 px) like
    the JAX package's 8-device solve and the port's single-device solve
    (|d rms| < 0.2 px, final cost within 1% of both; measured on the
    CPU: rms 0.25114 against 0.25115 and 0.25115 px, costs 1.7e-6 and
    3.3e-6 apart)."""
    p_bad, p_j, cost_j = pose_problem
    p = _port(p_bad)
    stats = {}
    sol, cost = dist_ba.solve_distributed(TMESH.make_mesh(8, "cpu"), p,
                                          max_iters=15, stats=stats)
    single, info = TB.solve_ba(p, TB.BAOptions(
        max_iters=15, huber_px=4.0, cg_iters=dist_ba.CG_ITERS,
        cg_tol=dist_ba.CG_TOL))
    rms, rms_j, rms_1 = _rms(sol), _jrms(p_j), _rms(single)
    assert rms < 0.6 and rms_j < 0.6 and rms_1 < 0.6, (rms, rms_j, rms_1)
    assert abs(rms - rms_j) < 0.2 and abs(rms - rms_1) < 0.2
    assert abs(cost - cost_j) / cost_j < 0.01, (cost, cost_j)
    assert abs(cost - info["final_cost"]) / info["final_cost"] < 0.01
    assert stats["final_cost"] == cost and 1 <= stats["iters"] <= 15
    assert stats["initial_cost"] > 10 * cost
    assert sol.obs_uv.shape == p.obs_uv.shape  # the unpadded observations


def test_solve_distributed_one_shard_is_solve_ba_bit_for_bit(pose_problem):
    """On a one-shard mesh the distributed step is the single-device
    solver's step (same hook, same schedule at cg 50 / 1e-6): the same
    bits for 6 iterations, before its 8-rejection stop could differ."""
    p = _port(pose_problem[0])
    sol, cost = dist_ba.solve_distributed(TMESH.make_mesh(1, "cpu"), p,
                                          max_iters=6)
    single, info = TB.solve_ba(p, TB.BAOptions(
        max_iters=6, huber_px=4.0, cg_iters=50, cg_tol=1e-6))
    assert cost == info["final_cost"]
    assert TC.pytree_checksum(_state(sol)) == TC.pytree_checksum(_state(single))


def test_solve_distributed_pod_mesh_2d(pose_problem):
    """The (dcn, ici) = (2, 4) mesh in one process, sharded over both axes:
    at the noise floor, and bit-identical to the 1-D 8-shard run (the same
    shard layout)."""
    p = _port(pose_problem[0])
    pod = TMESH.Mesh([CPU] * 8, ("dcn", "ici"), shape=(2, 4))
    sol, cost = dist_ba.solve_distributed(pod, p, max_iters=15,
                                          axis=("dcn", "ici"))
    flat, cost1 = dist_ba.solve_distributed(TMESH.make_mesh(8, "cpu"), p,
                                            max_iters=15)
    assert _rms(sol) < 0.6
    assert cost == cost1
    assert TC.pytree_checksum(_state(sol)) == TC.pytree_checksum(_state(flat))
    with pytest.raises(ValueError):
        dist_ba.solve_distributed(pod, p, max_iters=1, axis="ici")


def test_solve_distributed_holds_the_gauge():
    """tests/test_dist_ba.py's gauge case: camera 0's pose and camera 1's
    translation stay where they were, bit for bit (the JAX package
    re-normalizes frozen quaternions and holds them to 1e-6)."""
    p0, _ = build_problem(n_cams=5, n_pts=60, noise_px=0.2, seed=44)
    p = _port(perturb(p0, seed=45))
    sol, _ = dist_ba.solve_distributed(TMESH.make_mesh(8, "cpu"), p,
                                       max_iters=5)
    assert torch.equal(sol.cam_q[0], p.cam_q[0])
    assert torch.equal(sol.cam_t[0], p.cam_t[0])
    assert torch.equal(sol.cam_t[1], p.cam_t[1])
    assert not torch.equal(sol.cam_q[1], p.cam_q[1])


def test_solve_distributed_stops_early_when_settled(pose_problem):
    """A settled problem stops long before max_iters (the plateau rule or
    eight rejections), and iters counts what ran."""
    p = _port(pose_problem[0])
    mesh = TMESH.make_mesh(8, "cpu")
    settled, _ = dist_ba.solve_distributed(mesh, p, max_iters=25)
    stats = {}
    _, cost = dist_ba.solve_distributed(mesh, settled, max_iters=40,
                                        stats=stats)
    assert np.isfinite(cost)
    assert 1 <= stats["iters"] < 40, stats


def test_solve_distributed_is_deterministic_and_counted():
    """Two equal solves give equal checksums; deterministic=False sums in
    another order, within 1% of it; each counts one distributed solve on
    the CPU."""
    p0, _ = build_problem(n_cams=5, n_pts=60, noise_px=0.2, seed=46)
    p = _port(perturb(p0, seed=47))
    mesh = TMESH.make_mesh(8, "cpu")
    TB.reset_counts()
    sums = [TC.pytree_checksum(_state(dist_ba.solve_distributed(
        mesh, p, max_iters=5)[0])) for _ in range(2)]
    assert sums[0] == sums[1]
    _, c_det = dist_ba.solve_distributed(mesh, p, max_iters=5)
    _, c_sum = dist_ba.solve_distributed(mesh, p, max_iters=5,
                                         deterministic=False)
    assert abs(c_sum - c_det) / c_det < 0.01
    assert TB.COUNTS["dist_solves_cpu"] == 4 and TB.COUNTS["solves_cpu"] == 0
    assert TB.COUNTS["dist_solves_cuda"] == 0


def test_solve_distributed_intrinsics_matches_jax_and_single():
    """tests/test_dist_ba.py's 14-dof case: 6 cameras of one PINHOLE camera
    with a 3% focal error; the port's 8-shard solve, the JAX package's
    8-device solve and the port's single-device solve (25 iterations) all
    reach rms < 0.6 px within 0.2 px of each other, final costs within 1%,
    focal within 1% of the true 500 (measured on the CPU: rms 0.24665,
    0.24666, 0.24666 px; costs 4.4e-6 from the JAX package's and 2.8e-5
    from single-device; focal 501.710, 501.766, 501.791)."""
    p0, _ = build_problem(n_cams=6, n_pts=100, noise_px=0.2, seed=48)
    n = p0.cam_q.shape[0]
    free, tie = TCam.intri_free_mask(TCam.PINHOLE)
    meta = dict(cam_kam=np.zeros(n, np.int32),
                fix_intri=np.tile(~free[None], (n, 1)),
                tie_f=np.full(n, bool(tie)))
    p_bad = perturb(dataclasses.replace(
        p0, **{k: jnp.asarray(v) for k, v in meta.items()}), seed=49)
    intri_bad = np.asarray(p_bad.cam_intri).copy()
    intri_bad[:, :2] *= 1.03
    p_bad = dataclasses.replace(p_bad, cam_intri=jnp.asarray(intri_bad))
    p_j, cost_j = j_solve_distributed(_jmesh(), p_bad, max_iters=25,
                                      optimize_intrinsics=True)
    p = _port(p_bad)
    TB.reset_counts()
    sol, cost = dist_ba.solve_distributed(
        TMESH.make_mesh(8, "cpu"), p, max_iters=25, optimize_intrinsics=True)
    single, info = TB.solve_ba(p, TB.BAOptions(
        max_iters=25, huber_px=4.0, optimize_intrinsics=True))
    rms, rms_j, rms_1 = _rms(sol), _jrms(p_j), _rms(single)
    assert rms < 0.6 and rms_j < 0.6 and rms_1 < 0.6, (rms, rms_j, rms_1)
    assert abs(rms - rms_j) < 0.2 and abs(rms - rms_1) < 0.2
    assert abs(cost - float(cost_j)) / float(cost_j) < 0.01
    assert abs(cost - info["final_cost"]) / info["final_cost"] < 0.01
    for f in (float(sol.cam_intri[0, 0]), float(np.asarray(p_j.cam_intri)[0, 0]),
              float(single.cam_intri[0, 0])):
        assert abs(f - 500.0) / 500.0 < 0.01, f
    assert TB.COUNTS["dist_solves_cpu"] == 1


def test_two_gloo_processes_equal_one_process(pose_problem, tmp_path):
    """Two processes of 2 CPU shards each, joined by Gloo through a file
    store (the pod mesh (dcn, ici) = (2, 2)), solve to the bits of one
    process with 4 shards: the same checksum in both ranks."""
    p = _port(pose_problem[0])
    arrays = torch_dist_worker.problem_arrays(p)
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=torch_dist_worker.gloo_solve,
                         args=(r, 2, init, 2, arrays, 8,
                               str(tmp_path / f"rank{r}.json")))
             for r in range(2)]
    for pr in procs:
        pr.start()
    for pr in procs:
        pr.join(timeout=180)
    for pr in procs:
        if pr.is_alive():
            pr.terminate()
            pr.join()
    assert [pr.exitcode for pr in procs] == [0, 0]
    res = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    one, cost = dist_ba.solve_distributed(TMESH.make_mesh(4, "cpu"), p,
                                          max_iters=8)
    assert res[0]["shape"] == {"dcn": 2, "ici": 2}
    assert res[0]["checksum"] == res[1]["checksum"] == \
        TC.pytree_checksum(_state(one))
    assert res[0]["cost"] == res[1]["cost"] == cost


# --- the mapper on a mesh ---------------------------------------------------

def test_mapper_n_devices_8_matches_one_device():
    """tests/test_dist_ba.py's production case: make_scene (6 cameras, 150
    points, seed 20) reconstructed with MapperOptions.n_devices = 8 on the
    CPU (KGBA and the polish GBA sharded) registers the frames n_devices =
    1 registers, at the same geometry (ATE between the runs < 1e-3)."""
    from test_torch_mapper import build_map, _centers
    from xrsfm_tpu_torch.base.map import SfMMap
    from xrsfm_tpu_torch.mapper import IncrementalMapper, MapperOptions
    from xrsfm_tpu_torch.ops.umeyama import ate_rmse

    res = {}
    for n_dev in (1, 8):
        m = build_map(SfMMap, make_scene(n_cams=6, n_pts=150, seed=20,
                                         noise=0.0))
        TB.reset_counts()
        mapper = IncrementalMapper(MapperOptions(verbose=False,
                                                 n_devices=n_dev),
                                   device="cpu")
        assert mapper.reconstruct(m)
        res[n_dev] = (m.registered.copy(), _centers(m.q, m.t),
                      dict(TB.COUNTS))
    assert np.array_equal(res[1][0], res[8][0]) and res[1][0].all()
    assert ate_rmse(res[1][1], res[8][1]) < 1e-3
    assert res[1][2]["dist_solves_cpu"] == 0
    assert res[8][2]["dist_solves_cpu"] > 0
