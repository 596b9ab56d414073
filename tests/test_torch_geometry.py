"""The port's geometry, camera models, COLMAP I/O and Umeyama alignment
(xrsfm_tpu_torch.utils.geometry / .camera / .io_colmap, .ops.umeyama)
against the JAX package's, on the same seeded numpy inputs, on the CPU.

Tolerance: atol 1e-5 on unit-scale quantities (quaternions, rotations,
normalized coordinates, angles); pixel outputs are compared after dividing
by the focal length, i.e. at atol 1e-5 in normalized units (float32
rounding of 500-pixel values alone is 3e-5 px)."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from xrsfm_tpu.ops import umeyama as JU
from xrsfm_tpu.utils import camera as JC, geometry as JG, io_colmap as JIO
from xrsfm_tpu_torch.ops import umeyama as TU
from xrsfm_tpu_torch.utils import camera as TC, geometry as TG
from xrsfm_tpu_torch.utils import io_colmap as TIO

torch.set_num_threads(2)

ATOL = 1e-5


def _j(f, *a):
    return np.asarray(f(*(jnp.asarray(x) for x in a)))


def _t(f, *a):
    out = f(*(torch.from_numpy(np.array(x)) for x in a))
    return out.numpy() if isinstance(out, torch.Tensor) else out


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _close(a, b, atol=ATOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("name", [
    "quat_normalize", "quat_conj", "quat_to_rotmat", "skew", "so3_exp_quat",
    "so3_log", "so3_exp_matrix", "rotmat_to_quat",
])
def test_unary_ops_match_jax(name):
    """Quaternion and SO(3) maps on 64 seeded inputs, small rotation
    vectors (Taylor branch) included; rotmat_to_quat on matrices of all
    four Shepperd cases."""
    rng = np.random.default_rng(1)
    if name in ("skew", "so3_exp_quat", "so3_exp_matrix"):
        x = rng.normal(scale=1.0, size=(64, 3)).astype(np.float32)
        x[:8] *= 1e-5
    elif name == "rotmat_to_quat":
        x = np.asarray(JG.quat_to_rotmat(jnp.asarray(_quats(rng, 64))))
    else:
        x = _quats(rng, 64) * (1.7 if name == "quat_normalize" else 1.0)
    _close(_t(getattr(TG, name), x), _j(getattr(JG, name), x))


def _both(name, args):
    """Outputs of the port's and the JAX package's `name` as lists of numpy
    arrays (one per returned tensor)."""
    t = getattr(TG, name)(*(torch.from_numpy(a) for a in args))
    j = getattr(JG, name)(*(jnp.asarray(a) for a in args))
    t, j = (t, j) if isinstance(t, tuple) else ((t,), (j,))
    return [x.numpy() for x in t], [np.asarray(x) for x in j]


@pytest.mark.parametrize("name", [
    "quat_mul", "quat_rotate", "pose_compose", "pose_inverse", "pose_apply",
    "pose_center", "pose_relative", "pose_retract", "angle_between_rays",
])
def test_pose_ops_match_jax(name):
    """SE(3) ops on 32 seeded poses; translations and points of size ~5
    are held at atol 1e-4 (float32 rounding of the products), the rest
    at 1e-5."""
    rng = np.random.default_rng(2)
    qa, qb = _quats(rng, 32), _quats(rng, 32)
    ta, tb = (rng.normal(size=(2, 32, 3)) * 3).astype(np.float32)
    x = rng.normal(size=(32, 3)).astype(np.float32) * 5
    d = (rng.normal(size=(32, 6)) * 0.1).astype(np.float32)
    args = {
        "quat_mul": (qa, qb), "quat_rotate": (qa, x),
        "pose_compose": (qa, ta, qb, tb), "pose_inverse": (qa, ta),
        "pose_apply": (qa, ta, x), "pose_center": (qa, ta),
        "pose_relative": (qa, ta, qb, tb), "pose_retract": (qa, ta, d),
        "angle_between_rays": (x, ta),
    }[name]
    for got, exp in zip(*_both(name, args)):
        _close(got, exp, atol=1e-4 if got.shape[-1] == 3 else ATOL)


def test_numpy_twins_equal_jax_twins():
    """The *_np host twins are the same float64 numpy code: equal to the
    JAX package's twins to 1e-12."""
    rng = np.random.default_rng(3)
    qa, qb = _quats(rng, 16).astype(np.float64), _quats(rng, 16).astype(np.float64)
    ta, tb = rng.normal(size=(2, 16, 3))
    R = JG.quat_to_rotmat_np(qa)
    for got, exp in (
        (TG.quat_to_rotmat_np(qa), R),
        (TG.rotmat_to_quat_np(R), JG.rotmat_to_quat_np(R)),
        (TG.pose_center_np(qa, ta), JG.pose_center_np(qa, ta)),
        (TG.quat_mul_np(qa, qb), JG.quat_mul_np(qa, qb)),
        (np.concatenate(TG.pose_compose_np(qa, ta, qb, tb), -1),
         np.concatenate(JG.pose_compose_np(qa, ta, qb, tb), -1)),
        (np.concatenate(TG.pose_relative_np(qa, ta, qb, tb), -1),
         np.concatenate(JG.pose_relative_np(qa, ta, qb, tb), -1)),
    ):
        np.testing.assert_allclose(got, exp, atol=1e-12)


_RAW = {
    JC.SIMPLE_PINHOLE: [500.0, 320.0, 240.0],
    JC.PINHOLE: [480.0, 520.0, 310.0, 250.0],
    JC.SIMPLE_RADIAL: [500.0, 320.0, 240.0, -0.08],
    JC.RADIAL: [500.0, 320.0, 240.0, -0.1, 0.03],
    JC.OPENCV: [480.0, 520.0, 310.0, 250.0, -0.1, 0.02, 1e-3, -2e-3],
}


@pytest.mark.parametrize("model_id", sorted(_RAW))
def test_camera_model_matches_jax(model_id):
    """Each of the 5 COLMAP models: canonical / raw parameters and the free
    mask equal; distort, its Jacobian, undistort, normalized_to_image,
    image_to_normalized and project within atol 1e-5 (pixels over f)."""
    raw = _RAW[model_id]
    canon = TC.canonicalize_params(model_id, raw)
    np.testing.assert_array_equal(canon, JC.canonicalize_params(model_id, raw))
    np.testing.assert_array_equal(TC.raw_params(model_id, canon),
                                  JC.raw_params(model_id, canon))
    for a, b in zip(TC.intri_free_mask(model_id), JC.intri_free_mask(model_id)):
        np.testing.assert_array_equal(a, b)
    p = canon.astype(np.float32)
    f = float(p[0])
    rng = np.random.default_rng(model_id)
    uv = rng.uniform(-0.6, 0.6, (200, 2)).astype(np.float32)
    px = (uv * p[:2] + p[2:4]).astype(np.float32)
    for name, args, scale in (
        ("distort", (p, uv), 1.0), ("distort_jacobian", (p, uv), 1.0),
        ("undistort", (p, uv), 1.0), ("normalized_to_image", (p, uv), f),
        ("image_to_normalized", (p, px), 1.0),
    ):
        _close(_t(getattr(TC, name), *args) / scale,
               _j(getattr(JC, name), *args) / scale)
    q = _quats(rng, 200)
    t = np.array([0.1, -0.2, 6.0], np.float32) + 0 * q[:, :3]
    xyz = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    (gxy, gz), (exy, ez) = (
        [a.numpy() for a in TC.project(*(torch.from_numpy(a) for a in
                                         (p, q, t, xyz)))],
        [np.asarray(a) for a in JC.project(*(jnp.asarray(a) for a in
                                             (p, q, t, xyz)))])
    _close(gz, ez, atol=1e-4)
    front = ez > 1.0
    _close(gxy[front] / f, exy[front] / f)
    np.testing.assert_allclose(
        TC.image_to_normalized_np(canon, px),
        np.asarray(JC.image_to_normalized(jnp.asarray(p), jnp.asarray(px))),
        atol=ATOL, rtol=0)


def _colmap_model(rng, mod):
    cams = {1: mod.ColmapCamera(1, JC.OPENCV, 640, 480,
                                np.asarray(_RAW[JC.OPENCV])),
            3: mod.ColmapCamera(3, JC.SIMPLE_RADIAL, 320, 240,
                                np.asarray(_RAW[JC.SIMPLE_RADIAL]))}
    imgs = {}
    for iid, n in ((1, 5), (2, 0), (7, 9)):
        imgs[iid] = mod.ColmapImage(
            iid, _quats(rng, 1)[0].astype(np.float64), rng.normal(size=3),
            1 if iid != 7 else 3, f"im{iid}.png", rng.normal(size=(n, 2)),
            rng.integers(-1, 10, n).astype(np.int64))
    pts = {pid: mod.ColmapPoint3D(
        pid, rng.normal(size=3), rng.integers(0, 256, 3).astype(np.uint8),
        float(rng.random()), np.array([1, 7], np.int32),
        np.array([0, 3], np.int32)) for pid in (0, 4, 9)}
    return cams, imgs, pts


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_binaries_byte_equal_with_jax(tmp_path, writer):
    """cameras.bin / images.bin / points3D.bin written by either package
    are read by the other and re-written byte for byte; the text camera
    file and the TUM trajectory writer agree too."""
    rng = np.random.default_rng(4)
    src, dst = (TIO, JIO) if writer == "port" else (JIO, TIO)
    cams, imgs, pts = _colmap_model(rng, src)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    src.write_cameras_bin(str(a / "cameras.bin"), cams)
    src.write_images_bin(str(a / "images.bin"), imgs)
    src.write_points3d_bin(str(a / "points3D.bin"), pts)
    dst.write_cameras_bin(str(b / "cameras.bin"),
                          dst.read_cameras_bin(str(a / "cameras.bin")))
    dst.write_images_bin(str(b / "images.bin"),
                         dst.read_images_bin(str(a / "images.bin")))
    dst.write_points3d_bin(str(b / "points3D.bin"),
                           dst.read_points3d_bin(str(a / "points3D.bin")))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    (a / "cameras.txt").write_text(
        "# comment\n0 PINHOLE 640 480 500 510 320 240\n"
        "2 SIMPLE_RADIAL 320 240 300 160 120 0.01\n")
    for c1, c2 in zip(TIO.read_cameras_text(str(a / "cameras.txt")).values(),
                      JIO.read_cameras_text(str(a / "cameras.txt")).values()):
        assert dataclasses.astuple(c1)[:4] == dataclasses.astuple(c2)[:4]
        np.testing.assert_array_equal(c1.params, c2.params)
    q = _quats(rng, 3).astype(np.float64)
    t = rng.normal(size=(3, 3))
    reg = np.array([True, False, True])
    TIO.write_trajectory_tum(str(a / "t1.txt"), ["a", "b", "c"], q, t, reg)
    JIO.write_trajectory_tum(str(a / "t2.txt"), ["a", "b", "c"], q, t, reg)
    assert (a / "t1.txt").read_text() == (a / "t2.txt").read_text()


def test_umeyama_and_ate_equal_jax():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(30, 3))
    R = JG.quat_to_rotmat_np(_quats(rng, 1)[0])
    dst = 2.5 * src @ R.T + np.array([1.0, -2.0, 0.5]) \
        + rng.normal(scale=1e-3, size=src.shape)
    for a, b in zip(TU.umeyama(src, dst), JU.umeyama(src, dst)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    assert TU.ate_rmse(dst, src) == pytest.approx(JU.ate_rmse(dst, src),
                                                  abs=1e-12)
