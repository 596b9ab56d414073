"""The port's camera-major row-native bundle adjustment (pack_camera_major,
build_ell, the row functions, _build_normal_blocks_ell,
_build_pt_blocks_native, _schur_solve_ell and solve_ba(p, opts, ell) in
xrsfm_tpu_torch/optim/ba.py) against the JAX package's
(xrsfm_tpu/optim/ba.py) on the same seeded numpy problems, on the CPU.

The JAX functions run at float32 (pt_dtype / compute_dtype float32,
precise=True, "highest" matmul precision).  The JAX package rounds its
row counts up to a bucket of XLA shapes; the port's tables have exactly
the rows the segments need, so the JAX tables' first rows are compared,
and its padding sentinels (table length, point-major size) are mapped to
the port's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_error_correct import _jax_map
from xrsfm_tpu.mapper import ba_glue as JG
from xrsfm_tpu.optim import ba as JB
from xrsfm_tpu_torch.base.map import SfMMap as TMap
from xrsfm_tpu_torch.mapper import ba_glue as TG
from xrsfm_tpu_torch.optim import ba as TB
from xrsfm_tpu_torch.utils import camera as TC
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

_F32 = dict(pt_dtype=jnp.float32)


def _problem(seed=0, n_cams=12, n_pts=300, intri=False, fixes=False):
    """bench.make_ba_problem's generator at a small size with OPENCV
    distortion, a few zero-weight and behind-the-camera observations;
    intri adds one intrinsic block per two cameras, PINHOLE's frozen
    entries and every other focal tied; fixes freezes cameras, a
    translation, points and rotations."""
    d = synth.ba_problem(n_cams=n_cams, n_pts=n_pts, seed=seed)
    rng = np.random.default_rng(seed + 1)
    d["cam_intri"][:, 4:] = [-0.05, 0.01, 1e-3, -5e-4]
    d["obs_w"][rng.choice(len(d["obs_w"]), 5, replace=False)] = 0.0
    d["points"][:3, 2] -= 200.0  # behind every camera: cheirality guard
    if intri:
        free, _ = TC.intri_free_mask(TC.PINHOLE)
        d.update(cam_kam=np.arange(n_cams) // 2,
                 fix_intri=np.tile(~free[None], (n_cams, 1)),
                 tie_f=np.arange(n_cams) % 2 == 0)
    if fixes:
        d["fix_cam"][[0, 5]] = True
        d["fix_trans"][[1, 7]] = True
        d["fix_pt"][rng.choice(n_pts, n_pts // 10, replace=False)] = True
        d["fix_rot"] = np.zeros(n_cams, bool)
        d["fix_rot"][[3, 8]] = True
    return d


def _port(d):
    return TB.BAProblem.from_numpy("cpu", **d)


def _jax(d):
    out = {}
    for f in dataclasses.fields(JB.BAProblem):
        if d.get(f.name) is None:
            continue
        a = np.asarray(d[f.name])
        if f.name.startswith("fix_") or f.name == "tie_f":
            a = a.astype(bool)
        elif f.name in ("obs_cam", "obs_pt", "cam_kam"):
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        out[f.name] = jnp.asarray(a)
    return JB.BAProblem(**out)


def _packed(d, **kw):
    """(port problem, port ell, JAX problem, JAX ell), both packed."""
    pt, et = TB.pack_camera_major(_port(d), **kw)
    pj, ej = JB.pack_camera_major(_jax(d), **kw)
    return pt, et, pj, ej


def _close(got, exp, rel, what=""):
    """Within rel of exp's largest entry."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=rel * max(np.abs(exp).max(), 1e-30),
                               err_msg=what)


def _pad(a, rows):
    """numpy copy of a with zero rows appended up to `rows`."""
    a = np.asarray(a)
    return np.concatenate([a, np.zeros((rows - len(a),) + a.shape[1:],
                                       a.dtype)])


def _sentinel(jax_table, jax_sentinel, port_sentinel):
    t = np.asarray(jax_table).astype(np.int64)
    return np.where(t == jax_sentinel, port_sentinel, t)


@pytest.mark.parametrize("cam_width,n_pad", [(8, 0), (32, 40), (128, 0),
                                             (128, 40)])
def test_tables_equal_jax(cam_width, n_pad):
    """pack_camera_major at camera widths 8, 32 and 128, with and without
    n_valid padding (weight-0 rows at camera 0 and point 0 past n_valid),
    and build_ell: every table equals the JAX package's first rows, array
    for array (padding sentinels mapped); starts[s] is the first row of
    segment s."""
    d = _problem(seed=1)
    n = len(d["obs_cam"])
    if n_pad:
        for k, fill in (("obs_cam", 0), ("obs_pt", 0), ("obs_w", 0.0)):
            d[k] = np.concatenate([d[k], np.full(n_pad, fill, d[k].dtype)])
        d["obs_uv"] = np.concatenate([d["obs_uv"], np.zeros((n_pad, 2),
                                                            np.float32)])
    kw = dict(n_valid=n) if n_pad else {}
    pt, et, pj, ej = _packed(d, cam_width=cam_width, **kw)
    Rc, Mc = et.cam.slots.shape
    Rp, Lw = et.pt.slots.shape
    Rcj, Mcj = ej.cam.slots.shape
    Rpj = ej.pt.slots.shape[0]
    assert Mc == Mcj == min(cam_width, 128) and Lw == ej.pt.slots.shape[1]
    assert Rc <= Rcj and Rp <= Rpj
    O2, O2j = Rc * Mc, Rcj * Mcj
    for name in ("obs_uv", "obs_cam", "obs_pt", "obs_w"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name))[:O2], name)
    np.testing.assert_array_equal(pj.obs_w[O2:], 0)
    for side, R in (("cam", Rc), ("pt", Rp)):
        rt, rj = getattr(et, side), getattr(ej, side)
        slots_j = np.asarray(rj.slots)[:R]
        if side == "pt":
            slots_j = _sentinel(slots_j, O2j, O2)
        np.testing.assert_array_equal(rt.slots.numpy(), slots_j, side)
        np.testing.assert_array_equal(rt.seg.numpy(), np.asarray(rj.seg)[:R])
        np.testing.assert_array_equal(rt.other.numpy(),
                                      np.asarray(rj.other)[:R])
        starts = rt.starts.numpy()
        assert starts[0] == 0 and starts[-1] == R
        np.testing.assert_array_equal(rt.seg.numpy()[starts[:-1]],
                                      np.arange(len(starts) - 1))
    assert et.cam.contig and not et.pt.contig
    np.testing.assert_array_equal(et.pt_uv.numpy(), np.asarray(ej.pt_uv)[:Rp])
    np.testing.assert_array_equal(et.pt_w.numpy(), np.asarray(ej.pt_w)[:Rp])
    np.testing.assert_array_equal(
        et.pt_pos.numpy(),
        _sentinel(np.asarray(ej.pt_pos)[:Rc], Rpj * Lw, Rp * Lw))

    # the flat tables of build_ell (sentinel: the table length, both)
    ft = TB.build_ell(_port(d).obs_cam, _port(d).obs_pt, 12, 300, **kw)
    fj = JB.build_ell(d["obs_cam"], d["obs_pt"], 12, 300, **kw)
    for side in ("cam", "pt"):
        rt, rj = getattr(ft, side), getattr(fj, side)
        R = rt.slots.shape[0]
        for name in ("slots", "seg", "other"):
            np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                          np.asarray(getattr(rj, name))[:R])


@pytest.mark.parametrize("with_intri", [False, True], ids=["D6", "D14"])
def test_row_residuals_and_jacobians_match_jax(with_intri):
    """_row_project's residuals within 1e-4 px (float32 pixels ~600) and
    depths within 1e-5 relative, Jc [Rc,Mc,2,D] and Jp within rtol 1e-5 of
    their largest entry, against the JAX package's first rows; the
    residuals-only pass equals the Jacobian pass's."""
    d = _problem(seed=2, intri=with_intri)
    pt, et, pj, ej = _packed(d)
    Rc = et.cam.slots.shape[0]
    r, z, Jc, Jp = TB._residuals_and_jacobians_rows(pt, et, with_intri)
    rj, zj, Jcj, Jpj = jax.jit(
        JB._residuals_and_jacobians_rows, static_argnames="with_intri")(
        pj, ej, with_intri=with_intri)
    assert Jc.shape[-1] == (14 if with_intri else 6)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj)[:Rc], atol=1e-4,
                               rtol=0)
    _close(z, np.asarray(zj)[:Rc], 1e-5, "z")
    _close(Jc, np.asarray(Jcj)[:Rc], 1e-5, "Jc")
    _close(Jp, np.asarray(Jpj)[:Rc], 1e-5, "Jp")
    r2, z2 = TB._residuals_only_rows(pt, et)
    assert torch.equal(r2, r) and torch.equal(z2, z)


@pytest.mark.parametrize("branch", ["row_cam_only", "row_gathers", "flat",
                                    "pt_native", "D14"])
def test_normal_blocks_match_jax(branch):
    """_build_normal_blocks_ell (row-native with cam_only / return_cam_w
    and with return_pt_gathers; the flat gather branch) and
    _build_pt_blocks_native, with fix_cam, fix_trans, fix_pt and fix_rot,
    against the JAX package at pt_dtype float32: U, V, bc, bp within 1e-4
    of each array's largest entry, Jcw, Jpg and spg within 1e-5.  The JAX
    flat branch casts its camera operands to bfloat16 whatever pt_dtype
    says, so the port's flat U and bc are held to the JAX package's COO
    _build_normal_blocks (float32) instead.  The plain cam_rows / pt_rows
    equal their compositions."""
    with_intri = branch == "D14"
    d = _problem(seed=3, intri=with_intri, fixes=True)
    pt, et, pj, ej = _packed(d)
    Rc, Rp = et.cam.slots.shape[0], et.pt.slots.shape[0]
    H = 4.0
    with jax.default_matmul_precision("highest"):
        if branch == "flat":
            p0 = _port(d)
            fl = TB.build_ell(p0.obs_cam, p0.obs_pt, 12, 300)
            fj = JB.build_ell(d["obs_cam"], d["obs_pt"], 12, 300)
            pjf = _jax(d)
            r, z, Jc, Jp = TB._residuals_and_jacobians(p0)
            _, w = TB._robust_cost_and_weight(r, z, p0.obs_w, H)
            U, V, bc, bp, (Jpg, spg) = TB._build_normal_blocks_ell(
                p0, fl, r, Jc, Jp, w, return_pt_gathers=True,
                pt_dtype=torch.float32)
            rj, zj, Jcj, Jpj = JB._residuals_and_jacobians(pjf)
            _, wj = JB._robust_cost_and_weight(rj, zj, pjf.obs_w, H)
            _, Vj, _, bpj, (Jpgj, spgj) = JB._build_normal_blocks_ell(
                pjf, fj, rj, Jcj, Jpj, wj, return_pt_gathers=True, **_F32)
            Uj, _, _, bcj, _ = JB._build_normal_blocks(pjf, rj, Jcj, Jpj, wj)
            Rp = fl.pt.slots.shape[0]
        elif branch == "pt_native":
            V, bp, (Jpg, spg) = TB._build_pt_blocks_native(
                pt, et, H, pt_dtype=torch.float32)
            Vj, bpj, (Jpgj, spgj) = JB._build_pt_blocks_native(
                pj, ej, H, **_F32)
            V2, bp2, (Jpg2, spg2) = TB.pt_rows(pt, et, H)
            assert all(torch.equal(a, b) for a, b in
                       ((V, V2), (bp, bp2), (Jpg, Jpg2), (spg, spg2)))
        else:
            r, z, Jc, Jp = TB._residuals_and_jacobians_rows(pt, et,
                                                            with_intri)
            cost, w = TB._robust_cost_and_weight(
                r, z, pt.obs_w.reshape(et.cam.slots.shape), H)
            rj, zj, Jcj, Jpj = JB._residuals_and_jacobians_rows(
                pj, ej, with_intri=with_intri)
            cj, wj = JB._robust_cost_and_weight(
                rj, zj, pj.obs_w.reshape(ej.cam.slots.shape), H)
            assert float(cost) == pytest.approx(float(cj), rel=1e-5)
            if branch == "row_gathers":
                U, V, bc, bp, (Jpg, spg) = TB._build_normal_blocks_ell(
                    pt, et, r, Jc, Jp, w, return_pt_gathers=True,
                    pt_dtype=torch.float32)
                Uj, Vj, bcj, bpj, (Jpgj, spgj) = JB._build_normal_blocks_ell(
                    pj, ej, rj, Jcj, Jpj, wj, return_pt_gathers=True, **_F32)
            else:
                U, bc, Jcw = TB._build_normal_blocks_ell(
                    pt, et, r, Jc, Jp, w, cam_only=True, return_cam_w=True,
                    pt_dtype=torch.float32)
                Uj, bcj, Jcwj = JB._build_normal_blocks_ell(
                    pj, ej, rj, Jcj, Jpj, wj, cam_only=True,
                    return_cam_w=True, **_F32)
                _close(Jcw, np.asarray(Jcwj)[:Rc], 1e-5, "Jcw")
                c2, U2, bc2, Jcw2 = TB.cam_rows(pt, et, H, with_intri)
                assert all(torch.equal(a, b) for a, b in
                           ((cost, c2), (U, U2), (bc, bc2), (Jcw, Jcw2)))
    if branch != "pt_native":
        _close(U, Uj, 1e-4, "U")
        _close(bc, bcj, 1e-4, "bc")
        m = TB._cam_colmask(pt, with_intri).numpy()
        assert not U.numpy()[m == 0].any()
        assert not U.numpy()[[0, 5], :6].any()
        assert not bc.numpy()[[3, 8], :3].any()
    if branch in ("row_gathers", "flat", "pt_native"):
        _close(V, Vj, 1e-4, "V")
        _close(bp, bpj, 1e-4, "bp")
        _close(Jpg, np.asarray(Jpgj)[:Rp], 1e-5, "Jpg")
        _close(spg, np.asarray(spgj)[:Rp], 1e-5, "spg")
        assert not V.numpy()[d["fix_pt"]].any()


def _schur_inputs(mode):
    """(port args, JAX args, problems) of one _schur_solve_ell call in
    `mode`, the JAX args the port's inputs padded to the JAX rows."""
    with_intri = mode == "tied"
    d = _problem(seed=5, intri=with_intri, fixes=True)
    H = 4.0
    if mode == "flat":
        p = _port(d)
        e = TB.build_ell(p.obs_cam, p.obs_pt, 12, 300)
        pj, ej = _jax(d), JB.build_ell(d["obs_cam"], d["obs_pt"], 12, 300)
        r, z, Jc, Jp = TB._residuals_and_jacobians(p)
        _, w = TB._robust_cost_and_weight(r, z, p.obs_w, H)
        U, V, bc, bp = TB._build_normal_blocks_ell(
            p, e, r, Jc, Jp, w, pt_dtype=torch.float32)
        t = (U, V, bc, bp, Jc, Jp, w, None, None)
        j = tuple(jnp.asarray(a.numpy()) for a in t[:7]) + (None, None)
        return p, e, t, pj, ej, j
    p, e, pj, ej = _packed(d)
    Rcj, Rpj = ej.cam.slots.shape[0], ej.pt.slots.shape[0]
    r, z, Jc, Jp = TB._residuals_and_jacobians_rows(p, e, with_intri)
    _, w = TB._robust_cost_and_weight(r, z, p.obs_w.reshape(e.cam.slots.shape),
                                      H)
    U, bc, camw = TB.cam_rows(p, e, H, with_intri)[1:]
    V, bp, ptg = TB.pt_rows(p, e, H)
    if mode == "row":
        ptg = camw = None
    elif mode == "pt_major":
        camw = None
    t = (U, V, bc, bp, Jc, Jp, w, ptg, camw)

    def jx(a, rows):
        return jnp.asarray(_pad(a.numpy(), rows))

    j = tuple(jnp.asarray(a.numpy()) for a in (U, V, bc, bp)) + (
        jx(Jc, Rcj), jx(Jp, Rcj), jx(w, Rcj),
        None if ptg is None else tuple(jx(a, Rpj) for a in ptg),
        None if camw is None else jx(camw, Rcj))
    return p, e, t, pj, ej, j


@pytest.mark.parametrize("mode", ["weighted", "pt_major", "row", "flat",
                                  "tied"])
def test_schur_solve_ell_matches_jax(mode):
    """_schur_solve_ell in its modes (weighted point-major, point-major,
    camera-major Z, the flat gathers, the tied-intrinsics space at D = 14)
    on the same inputs as the JAX package's at compute_dtype float32 under
    "highest" precision: 4 PCG iterations at lambda 1e-3, dx_c and dx_p
    within 1e-4 of their largest entry."""
    p, e, t, pj, ej, j = _schur_inputs(mode)
    U, V, bc, bp, Jc, Jp, w, ptg, camw = t
    lam = torch.tensor(1e-3)
    dx_c, dx_p = TB._schur_solve_ell(
        p, e, U, V, bc, bp, Jc, Jp, w, lam, 4, 1e-6,
        compute_dtype=torch.float32, pt_gathers=ptg, cam_w=camw)
    with jax.default_matmul_precision("highest"):
        dcj, dpj = jax.jit(
            JB._schur_solve_ell,
            static_argnames=("cg_iters", "cg_tol", "compute_dtype"))(
            pj, ej, *j[:7], jnp.float32(1e-3), cg_iters=4, cg_tol=1e-6,
            compute_dtype=jnp.float32, pt_gathers=j[7], cam_w=j[8])
    _close(dx_c, dcj, 1e-4, "dx_c")
    _close(dx_p, dpj, 1e-4, "dx_p")
    assert dx_c.shape[1] == (14 if mode == "tied" else 6)


@pytest.mark.parametrize("case", ["cg2", "cg15", "flat", "intri"])
def test_solve_ba_ell_matches_jax_and_coo(case):
    """solve_ba(p, opts, ell) on a 20-camera, 500-point problem (bench
    settings; the intrinsics case from a 3% focal error at Huber 32 px)
    against the JAX package's solve_ba(p, BAOptions(precise=True), ell) on
    its own packing, and against the port's COO solve: initial and final
    costs within rtol 1e-3 and iteration counts equal (the tolerances of
    tests/test_torch_ba.py); row_solves_cpu counted only on the row path."""
    d = synth.ba_problem(n_cams=20, n_pts=500, seed=0)
    opts = dict(max_iters=10, cg_iters=15 if case == "cg15" else 2,
                huber_px=4.0, lam_init=1e-4)
    if case == "intri":
        free, tie = TC.intri_free_mask(TC.SIMPLE_RADIAL)
        d["cam_intri"][:, :2] *= 1.03
        d.update(cam_kam=np.zeros(20, np.int64),
                 fix_intri=np.tile(~free[None], (20, 1)),
                 tie_f=np.full(20, bool(tie)))
        opts.update(huber_px=32.0, optimize_intrinsics=True)
    if case == "flat":
        pt = _port(d)
        et = TB.build_ell(pt.obs_cam, pt.obs_pt, 20, 500)
        pj, ej = _jax(d), JB.build_ell(d["obs_cam"], d["obs_pt"], 20, 500)
    else:
        pt, et, pj, ej = _packed(d)
    TB.reset_counts()
    st, it = TB.solve_ba(pt, TB.BAOptions(**opts), et)
    assert TB.COUNTS["row_solves_cpu"] == (0 if case == "flat" else 1)
    sj, ij = JB.solve_ba(pj, JB.BAOptions(precise=True, **opts), ej)
    sc, ic = TB.solve_ba(_port(d), TB.BAOptions(**opts))
    for k in ("initial_cost", "final_cost"):
        assert it[k] == pytest.approx(float(ij[k]), rel=1e-3), k
        assert it[k] == pytest.approx(ic[k], rel=1e-3), k
    assert it["final_cost"] < 0.1 * it["initial_cost"]
    assert it["iters"] == int(ij["iters"]) == ic["iters"]
    _close(st.points, sc.points, 1e-3, "points")
    if case == "intri":
        np.testing.assert_allclose(st.cam_intri[:, 0].numpy(),
                                   np.asarray(sj.cam_intri)[:, 0], rtol=1e-3)


def _kernel_colmask(flags, D):
    """The gauge mask [C, D] as csrc/ba_cam_rows.cu's cams_kernel forms it
    from optim/ba._row_masks' flags (fix_cam, fix_rot, fix_trans,
    fix_intri, tie_f; None where absent)."""
    fix_cam, fix_rot, fix_trans, fix_intri, tie_f = (
        None if f is None else f.numpy() for f in flags)
    C = len(fix_cam)
    rot = fix_cam | (fix_rot if fix_rot is not None else False)
    frozen = [np.repeat(rot[:, None], 3, 1),
              np.repeat((fix_cam | fix_trans)[:, None], 3, 1)]
    if D == 14:
        fi = fix_intri.copy()
        if tie_f is not None:
            fi[:, 1] |= tie_f
        frozen.append(fi)
    m = ~np.concatenate(frozen, axis=1)
    assert m.shape == (C, D)
    return m.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_intri", [False, True], ids=["D6", "D14"])
def test_row_kernel_masks_match_colmask(with_intri, seed):
    """The freeze flags the camera-row wrapper hands its kernel
    (_row_masks: the problem's own bool tensors, nothing packed), decoded
    by the kernel's rule, give _cam_colmask(p, with_intri) exactly and the
    JAX package's _cam_colmask, for random fix_cam, fix_trans, fix_rot,
    fix_intri and tie_f, with fix_rot and tie_f also absent; the point
    side's flag is fix_pt itself, and pt_rows_plain zeroes exactly the
    blocks of the points it freezes (and no seen point's else)."""
    rng = np.random.default_rng(seed)
    d = _problem(seed=seed, intri=with_intri)
    C, P = len(d["cam_q"]), len(d["points"])
    d["fix_cam"] = rng.random(C) < 0.3
    d["fix_trans"] = rng.random(C) < 0.3
    d["fix_pt"] = rng.random(P) < 0.3
    if seed != 1:
        d["fix_rot"] = rng.random(C) < 0.3
    if with_intri:
        d["fix_intri"] = rng.random((C, 8)) < 0.3
        d["tie_f"] = rng.random(C) < 0.5 if seed != 2 else None
    p = _port(d)
    D = 14 if with_intri else 6
    flags = TB._row_masks(p, with_intri)
    for f, shape in zip(flags, ((C,), (C,), (C,), (C, 8), (C,))):
        assert f is None or (f.dtype == torch.bool and f.shape == shape)
    assert flags[0] is p.fix_cam and flags[2] is p.fix_trans
    m = _kernel_colmask(flags, D)
    np.testing.assert_array_equal(m, TB._cam_colmask(p, with_intri).numpy())
    np.testing.assert_array_equal(
        m, np.asarray(JB._cam_colmask(_jax(d), with_intri)))
    pp, ell = TB.pack_camera_major(p)
    V, bp, _ = TB.pt_rows_plain(pp, ell, 4.0)
    fp = d["fix_pt"]
    assert not V[fp].any() and not bp[fp].any()
    seen = ~fp
    seen[:3] = False  # _problem puts points 0..2 behind every camera
    assert bool((V[seen].abs().sum(dim=(1, 2)) > 0).all())


@pytest.mark.parametrize("cam_width,pt_width", [(8, 8), (32, 16),
                                                (128, 32)])
def test_row_kernel_tables(cam_width, pt_width):
    """What the row kernels take from pack_camera_major, on a problem with
    a camera and a point without observations: camera rows of at most 128
    slots and point rows of 8, 16 or 32, seg non-decreasing and equal to c
    on rows starts[c]..starts[c+1]-1, at least one row a segment, the
    point rows' seg consecutive within a warp's groups (32 / Lw points), a
    padding-only row of weight 0 and ids 0 for the unobserved camera and
    point, and the same tables as the JAX package's first rows."""
    d = _problem(seed=5, n_cams=12, n_pts=300)
    keep = (d["obs_cam"] != 11) & (d["obs_pt"] != 299)
    for k in ("obs_cam", "obs_pt", "obs_w", "obs_uv"):
        d[k] = d[k][keep]
    pt, et, pj, ej = _packed(d, cam_width=cam_width, pt_width=pt_width)
    for side, n_seg, cap in (("cam", 12, 128), ("pt", 300, 32)):
        ri = getattr(et, side)
        R, M = ri.slots.shape
        seg, starts = ri.seg.numpy(), ri.starts.numpy()
        assert M <= cap and M <= (cam_width if side == "cam" else pt_width)
        assert len(starts) == n_seg + 1 and starts[0] == 0
        assert starts[-1] == R and (np.diff(starts) >= 1).all()
        np.testing.assert_array_equal(
            seg, np.repeat(np.arange(n_seg), np.diff(starts)))
        last = slice(starts[-2], starts[-1])  # the unobserved segment
        assert starts[-1] - starts[-2] == 1
        assert not ri.other.numpy()[last].any()
        np.testing.assert_array_equal(seg, np.asarray(
            getattr(ej, side).seg)[:R])
    assert et.pt.slots.shape[1] in (8, 16, 32)
    Rc, Mc = et.cam.slots.shape
    w = pt.obs_w.numpy().reshape(Rc, Mc)
    assert not w[-1].any()
    assert not et.pt_w.numpy()[-1].any()
    # every weighted observation has its slot; the rest weigh 0
    assert (w > 0).sum() == (d["obs_w"] > 0).sum()


def test_frozen_parameters_stay_bit_unchanged_on_rows():
    """On the row path, frozen cameras keep q and t, translation-frozen
    cameras t, rotation-frozen cameras q and frozen points their
    coordinates, bit for bit; the free ones move."""
    d = _problem(seed=4, fixes=True)
    pt, et = TB.pack_camera_major(_port(d))
    sol, info = TB.solve_ba(pt, TB.BAOptions(max_iters=8, huber_px=4.0), et)
    assert info["final_cost"] < info["initial_cost"]
    q0, t0, x0 = (getattr(pt, k).numpy() for k in ("cam_q", "cam_t",
                                                   "points"))
    q1, t1, x1 = (getattr(sol, k).numpy() for k in ("cam_q", "cam_t",
                                                    "points"))
    for i in (0, 5):
        assert np.array_equal(q1[i], q0[i]) and np.array_equal(t1[i], t0[i])
    for i in (1, 7):
        assert np.array_equal(t1[i], t0[i]) and not np.array_equal(q1[i],
                                                                   q0[i])
    for i in (3, 8):
        assert np.array_equal(q1[i], q0[i]) and not np.array_equal(t1[i],
                                                                   t0[i])
    fp = d["fix_pt"]
    assert np.array_equal(x1[fp], x0[fp])
    assert not np.array_equal(x1[~fp], x0[~fp])
    assert not np.array_equal(q1[2], q0[2])


def test_run_ba_solves_in_the_row_layout():
    """ba_glue.run_ba packs the map's problem camera-major and solves it in
    the row layout: one row solve counted on the CPU, the plain row
    functions run; its costs within rtol 1e-3 of the JAX package's
    run_ba (precise, its own packing), the translations within 1e-3."""
    mj, _ = _jax_map()
    mj.t[2:] += 0.05
    mt = TMap.from_state(mj)
    frames = list(range(mj.num_frames))
    TB.reset_counts()
    TB.reset_launch_counts()
    rt = TG.run_ba(mt, frames, TB.BAOptions(max_iters=20, huber_px=4.0),
                   device="cpu")
    assert TB.COUNTS["row_solves_cpu"] == 1 and TB.COUNTS["solves_cpu"] == 1
    assert TB.LAUNCHES["ba_cam_rows_plain"] == TB.LAUNCHES[
        "ba_pt_rows_plain"] == TB.COUNTS["lm_iters"] > 0
    assert TB.LAUNCHES["ba_cam_rows_cuda"] == 0
    assert TB.LAUNCHES["ba_pt_rows_cuda"] == 0
    rj = JG.run_ba(mj, frames, JB.BAOptions(max_iters=20, huber_px=4.0,
                                            precise=True))
    assert rt.final_cost < rt.initial_cost
    for k in ("initial_cost", "final_cost"):
        assert getattr(rt, k) == pytest.approx(getattr(rj, k), rel=1e-3), k
    np.testing.assert_allclose(mt.t, mj.t, atol=1e-3, rtol=0)
