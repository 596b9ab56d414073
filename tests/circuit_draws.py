"""Both packages' sequential mapper on the 250-frame kitti-class circuit
under salted RANSAC seeds, on the CPU: a diagnosis of where their ATE
spreads part (ROADMAP.md, queue 3).  Not a test: it imports both packages,
as the port's tests do, and each run takes minutes.

  python tests/circuit_draws.py workspace WS
      write the circuit (utils/synth.write_kitti_workspace(WS, 250, 3),
      the bytes of chip_smoke.py phase 8)
  python tests/circuit_draws.py run --pkg jax|port --salt K WS OUT.json
          [--snapshot_at N SNAP.npz]
      rec_kitti on WS; records the drift (sim(3)-aligned ATE of the
      registered frames, % of the span) before every loop check, each
      correction, the MapperStats split and the points filtered; saves a
      snapshot (base/snapshot) once N frames are registered
  python tests/circuit_draws.py resume --pkg jax|port --salt K WS SNAP.npz
          N_MORE OUT.json [--swap register,tri,ba] [--precise]
      restores SNAP.npz into the package's map and registers N_MORE more
      frames with loop correction (no polish); --swap runs those stages of
      the JAX package through the port's functions, --precise runs the
      JAX package's BA with BAOptions(precise=True) (float32 Schur
      products)
  python tests/circuit_draws.py summary OUT.json...

The salt K adds K * 7919 (mod 2^31) to the seed of every RANSAC draw of
initialization, registration and the loop check's relocation (JAX package:
mapper/initialize.py:68, register.py:54, :130, error_correct.py:263; port:
mapper/initialize.py:59, register.py:104, error_correct.py:225) by
wrapping jax.random.PRNGKey and torch.Generator in those modules only;
K = 0 leaves the shipped seeds.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

SALT_STEP = 7919
MASK = 0x7FFFFFFF
SALTED = ("initialize", "register", "error_correct")


class _Proxy:
    """A module stand-in that forwards every attribute but the ones given."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(
            self._base, name)


def _salt_jax(mods, salt):
    import jax

    def key(seed):
        return jax.random.PRNGKey((int(seed) + salt * SALT_STEP) & MASK)

    proxy = _Proxy(jax, random=_Proxy(jax.random, PRNGKey=key))
    for mod in mods:
        mod.jax = proxy


def _salt_port(mods, salt):
    import torch

    def generator(*args, **kwargs):
        gen = torch.Generator(*args, **kwargs)
        seed = gen.manual_seed

        def salted(s):
            return seed((int(s) + salt * SALT_STEP) & MASK)

        return _Proxy(gen, manual_seed=salted)

    proxy = _Proxy(torch, Generator=generator)
    for mod in mods:
        mod.torch = proxy


def load(pkg, salt):
    """The package's modules, with their RANSAC seeds salted."""
    if pkg == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        import xrsfm_tpu as root
        from xrsfm_tpu.mapper import (error_correct, incremental, initialize,
                                      register, triangulate)
        from xrsfm_tpu.pipelines import rec_kitti, run_reconstruction
        kw = {}
    else:
        import torch

        torch.set_num_threads(2)
        import xrsfm_tpu_torch as root
        from xrsfm_tpu_torch.mapper import (error_correct, incremental,
                                            initialize, register, triangulate)
        from xrsfm_tpu_torch.pipelines import rec_kitti, run_reconstruction
        kw = {"device": "cpu"}
    mods = dict(initialize=initialize, register=register,
                error_correct=error_correct)
    if salt:
        (_salt_jax if pkg == "jax" else _salt_port)(
            [mods[k] for k in SALTED], salt)
    import importlib

    snapshot = importlib.import_module(root.__name__ + ".base.snapshot")
    return dict(EC=error_correct, INC=incremental, TRI=triangulate,
                REG=register, rec_kitti=rec_kitti, RR=run_reconstruction,
                snapshot=snapshot, kw=kw)


def _drift_fn(ws):
    from xrsfm_tpu_torch.ops.umeyama import ate_rmse
    from xrsfm_tpu_torch.utils import geometry as G

    gt = {}
    with open(os.path.join(ws, "gt_poses.txt")) as f:
        for line in f:
            p = line.split()
            gt[p[0]] = G.pose_center_np(np.array(p[1:5], float),
                                        np.array(p[5:8], float))
    c = np.array(list(gt.values()))
    span = float(np.linalg.norm(c.max(0) - c.min(0)))

    def drift(m):
        reg = np.nonzero(m.registered)[0]
        if len(reg) < 3:
            return 0.0
        est = np.array([G.pose_center_np(np.asarray(m.q[i], float),
                                         np.asarray(m.t[i], float))
                        for i in reg])
        ref = np.array([gt[m.names[i]] for i in reg])
        return 100.0 * ate_rmse(ref, est) / span

    return drift


def _instrument(P, drift, series, snap=None):
    """Record the drift before every loop check and after a correction;
    count the points filtered; save a snapshot at snap = (N, path)."""
    counters = dict(filtered=0, amnesty=0)
    check0, filter0 = P["EC"].check_and_correct_pose, P["TRI"].filter_tracks
    amnesty0 = P["INC"].IncrementalMapper._post_correction_amnesty

    def check(m, frame, *a, **k):
        n_reg, d0 = int(np.count_nonzero(m.registered)), drift(m)
        ok = check0(m, frame, *a, **k)
        series.append(dict(frame=int(frame), n_reg=n_reg, drift_pct=d0,
                           corrected=bool(ok),
                           drift_after=drift(m) if ok else None))
        if snap and n_reg == snap[0]:
            P["snapshot"].save_snapshot(m, snap[1])
        return ok

    def filt(m, *a, **k):
        n0 = int(np.count_nonzero(m.track_valid[: m.num_tracks]))
        out = filter0(m, *a, **k)
        counters["filtered"] += n0 - int(
            np.count_nonzero(m.track_valid[: m.num_tracks]))
        return out

    def amnesty(self, m):
        counters["amnesty"] += 1
        return amnesty0(self, m)

    P["EC"].check_and_correct_pose = check
    P["TRI"].filter_tracks = filt
    P["INC"].IncrementalMapper._post_correction_amnesty = amnesty
    return counters


def _keep_mapper(P):
    held = {}
    rec0 = P["INC"].IncrementalMapper.reconstruct

    def rec(self, m):
        held["mapper"] = self
        return rec0(self, m)

    P["INC"].IncrementalMapper.reconstruct = rec
    return held


def _swap(stages, salt):
    """Run the JAX package's register / triangulate / BA stages through
    the port's functions on the CPU (the port's registration draws salted
    as the JAX package's)."""
    import torch

    torch.set_num_threads(2)
    from xrsfm_tpu.mapper import ba_glue as JBG
    from xrsfm_tpu.mapper import register as JREG
    from xrsfm_tpu.mapper import triangulate as JTRI
    from xrsfm_tpu.optim.ba import BAOptions
    from xrsfm_tpu_torch.mapper import ba_glue as TBG
    from xrsfm_tpu_torch.mapper import register as TREG
    from xrsfm_tpu_torch.mapper import triangulate as TTRI
    from xrsfm_tpu_torch.utils.options import from_jax_options as FJ

    if "ba" in stages:
        def run_ba(m, frames, opts=None, fix_all_poses=False, obs_frames=None,
                   optimize_intrinsics=False, freeze_tracks=None, **_):
            return TBG.run_ba(m, frames, FJ(opts or BAOptions()),
                              fix_all_poses=fix_all_poses,
                              obs_frames=obs_frames,
                              optimize_intrinsics=optimize_intrinsics,
                              freeze_tracks=freeze_tracks, device="cpu")
        JBG.run_ba = run_ba
    if "register" in stages:
        if salt:
            _salt_port([TREG], salt)

        def reg(m, batch, opts, seed_salts=None, **k):
            return TREG.register_frames_batch(m, batch, FJ(opts),
                                              seed_salts=seed_salts,
                                              device="cpu", **k)
        JREG.register_frames_batch = reg
    if "tri" in stages:
        def wrap(fn):
            def w(m, arg=None, opts=None, *a, **k):
                extra = [FJ(opts)] if opts is not None else []
                return fn(m, arg, *extra, *a, device="cpu", **k)
            return w
        for name in ("triangulate_frame", "filter_tracks",
                     "merge_frame_tracks", "retriangulate",
                     "merge_all_tracks"):
            setattr(JTRI, name, wrap(getattr(TTRI, name)))


def _precise():
    import dataclasses

    from xrsfm_tpu.mapper import ba_glue as JBG
    from xrsfm_tpu.optim.ba import BAOptions

    run_ba0 = JBG.run_ba

    def run_ba(m, frames, opts=None, *a, **k):
        return run_ba0(m, frames, dataclasses.replace(opts or BAOptions(),
                                                      precise=True), *a, **k)
    JBG.run_ba = run_ba


def cmd_run(a):
    P = load(a.pkg, a.salt)
    drift, series = _drift_fn(a.ws), []
    counters = _instrument(P, drift, series,
                           (a.snapshot_at[0], a.snapshot_at[1])
                           if a.snapshot_at else None)
    held = _keep_mapper(P)
    t0 = time.time()
    out = os.path.splitext(a.out)[0] + "_model"
    m = P["rec_kitti"].main(a.ws, "00", out, "", **P["kw"])
    mp = held["mapper"]
    res = dict(pkg=a.pkg, salt=a.salt, seconds=time.time() - t0,
               registered=int(np.count_nonzero(m.registered)),
               final_ate_pct=drift(m),
               corrections=int(mp.stats.corrections),
               failed=int(mp.stats.failed),
               rejections=int(sum(mp._rejections.values())),
               polish=str(getattr(mp.stats, "polish", "")),
               counters=counters, series=series)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(_line(a.out, res), flush=True)


def cmd_resume(a):
    P = load(a.pkg, a.salt)
    stages = [s for s in a.swap.split(",") if s]
    if stages:
        _swap(stages, a.salt)
    if a.precise:
        _precise()
    drift, series = _drift_fn(a.ws), []
    counters = _instrument(P, drift, series)
    m = P["RR"].build_map(a.ws, os.path.join(a.ws, "camera.txt"))
    P["snapshot"].restore_into(m, a.snapshot)
    d0 = drift(m)
    opts = P["INC"].MapperOptions(correct_pose=True, global_polish=False,
                                  max_registrations=a.n_more, verbose=False)
    mapper = P["INC"].IncrementalMapper(opts, **P["kw"])
    t0 = time.time()
    mapper.reconstruct(m)
    res = dict(pkg=a.pkg, salt=a.salt, swap=stages, precise=a.precise,
               snapshot=os.path.basename(a.snapshot), seconds=time.time() - t0,
               start_drift_pct=d0,
               registered=int(np.count_nonzero(m.registered)),
               final_ate_pct=drift(m), corrections=int(mapper.stats.corrections),
               failed=int(mapper.stats.failed),
               rejections=int(sum(mapper._rejections.values())),
               counters=counters, series=series)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(_line(a.out, res), flush=True)


def _line(name, r):
    s = r["series"]
    first = next((x for x in s if x["corrected"]), None)
    pre = first["drift_pct"] if first else (s[-1]["drift_pct"] if s else 0.0)
    text = (f"{os.path.basename(name)}: {r['pkg']} salt {r['salt']}"
            + (f" swap {','.join(r['swap'])}" if r.get("swap") else "")
            + (" precise" if r.get("precise") else "")
            + (f" from {r['start_drift_pct']:.3f}%" if "start_drift_pct" in r
               else "")
            + f"; {r['registered']} registered, ATE {r['final_ate_pct']:.3f}%,"
            f" drift before the first correction {pre:.3f}%"
            + (f" -> {first['drift_after']:.3f}%" if first else
               " (no correction)")
            + f"; corrections {r['corrections']}, failed {r['failed']},"
            f" rejections {r['rejections']}, filtered "
            f"{r['counters']['filtered']}, amnesty {r['counters']['amnesty']};"
            f" {r['seconds']:.0f} s")
    return text


def cmd_summary(a):
    for name in a.files:
        with open(name) as f:
            print(_line(name, json.load(f)))


def cmd_workspace(a):
    from xrsfm_tpu_torch.utils import synth

    synth.write_kitti_workspace(a.ws, 250, 3)


def main(argv=None):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("workspace")
    w.add_argument("ws")
    r = sub.add_parser("run")
    r.add_argument("--pkg", choices=("jax", "port"), required=True)
    r.add_argument("--salt", type=int, default=0)
    r.add_argument("--snapshot_at", nargs=2, metavar=("N", "SNAP"))
    r.add_argument("ws")
    r.add_argument("out")
    c = sub.add_parser("resume")
    c.add_argument("--pkg", choices=("jax", "port"), required=True)
    c.add_argument("--salt", type=int, default=0)
    c.add_argument("--swap", default="")
    c.add_argument("--precise", action="store_true")
    c.add_argument("ws")
    c.add_argument("snapshot")
    c.add_argument("n_more", type=int)
    c.add_argument("out")
    s = sub.add_parser("summary")
    s.add_argument("files", nargs="+")
    a = p.parse_args(argv)
    if a.cmd == "run" and a.snapshot_at:
        a.snapshot_at = (int(a.snapshot_at[0]), a.snapshot_at[1])
    dict(workspace=cmd_workspace, run=cmd_run, resume=cmd_resume,
         summary=cmd_summary)[a.cmd](a)


if __name__ == "__main__":
    main()
