"""An out-of-place PCG loop to hold optim/ba._Pcg to, and the problems the
tests solve with it (imports no JAX: the card's tests use it too).

_Pcg runs PCG as state tensors that one in-place step updates, on a GPU
replayed as a CUDA graph.  `lockstep(diffs, route)` is a subclass of it
for _schur_solve_ell or _schur_solve to build in its place: its run
computes PCG with fresh tensors for every operation, each stop test read
before its
iteration, and hands its x and Σ alpha ypt(p_k) on as the result; after
each of its iterations the in-place step runs too (route "eager": called;
"graph": captured once by ba._pcg_graph and replayed), and the largest
difference between the two states goes into diffs."""

import numpy as np
import torch

from xrsfm_tpu_torch.optim import ba
from xrsfm_tpu_torch.utils import camera as Cam
from xrsfm_tpu_torch.utils import synth


def problem(intri, seed=0, n_cams=12, n_pts=300):
    """utils/synth.ba_problem with OPENCV distortion, a frozen camera, some
    frozen points and a few zero-weight and behind-the-camera
    observations; intri adds a 2% focal error, one intrinsic block per two
    cameras, PINHOLE's frozen entries and every other focal tied (the
    14-dof tangent, through _TiedSpace)."""
    d = synth.ba_problem(n_cams=n_cams, n_pts=n_pts, seed=seed)
    rng = np.random.default_rng(seed + 1)
    d["cam_intri"][:, 4:] = [-0.05, 0.01, 1e-3, -5e-4]
    d["obs_w"][rng.choice(len(d["obs_w"]), 5, replace=False)] = 0.0
    d["points"][:3, 2] -= 200.0
    d["fix_cam"][0] = True
    d["fix_pt"][rng.choice(n_pts, n_pts // 10, replace=False)] = True
    if intri:
        free, _ = Cam.intri_free_mask(Cam.PINHOLE)
        d["cam_intri"][:, :2] *= 1.02
        d.update(cam_kam=np.arange(n_cams) // 2,
                 fix_intri=np.tile(~free[None], (n_cams, 1)),
                 tie_f=np.arange(n_cams) % 2 == 0)
    return d


def options(intri, cg_iters=15):
    return ba.BAOptions(max_iters=8, cg_iters=cg_iters,
                        huber_px=32.0 if intri else 4.0,
                        optimize_intrinsics=intri)


def _dot(dot):
    """The space's dot product as one expression, no out= tensor."""
    space = getattr(dot, "__self__", None)
    if isinstance(space, ba._TiedSpace):
        return lambda a, b: ((a[:, :6] * b[:, :6]).sum()
                             + (a[:, 6:] * b[:, 6:] * space.wred).sum())
    return lambda a, b: (a * b).sum()


def _gap(a, b):
    if a.dtype == torch.bool:
        return float((a != b).any())
    return float((a.double() - b.double()).abs().max())


def lockstep(diffs, route="eager"):
    class Lockstep(ba._Pcg):
        def __init__(self, rhs, n_pts, ypt_reduce, S_matvec, precond, dot,
                     cg_tol):
            self.rhs0, self.cg_tol = rhs.clone(), cg_tol
            super().__init__(rhs, n_pts, ypt_reduce, S_matvec, precond,
                             dot, cg_tol)

        def run(self, cg_iters, graph):
            dot = _dot(self.dot)
            rhs = self.rhs0
            x = torch.zeros_like(rhs)
            r_ = rhs
            z_ = self.precond(r_)
            pk = z_
            rz = dot(r_, z_)
            bnorm = torch.sqrt(dot(rhs, rhs)) + 1e-30
            ypx = rhs.new_zeros(self.ypx.shape)
            step = None
            for _ in range(cg_iters):
                if not bool(torch.sqrt(dot(r_, r_)) > self.cg_tol * bnorm):
                    break
                ba.COUNTS["cg_iters"] += 1
                ypp = self.ypt_reduce(pk)
                Ap = self.S_matvec(pk, ypp)
                denom = dot(pk, Ap)
                alpha = rz / torch.where(denom.abs() < 1e-30, 1e-30, denom)
                x = x + alpha * pk
                ypx = ypx + alpha * ypp
                r_ = r_ - alpha * Ap
                z_ = self.precond(r_)
                rz_new = dot(r_, z_)
                beta = rz_new / torch.where(rz.abs() < 1e-30, 1e-30, rz)
                pk = z_ + beta * pk
                rz = rz_new
                if step is None:
                    self.go = self.test()
                    step = (self.step if route == "eager" else
                            ba._pcg_graph(self.step, rhs.device).replay)
                step()
                go = torch.sqrt(dot(r_, r_)) > self.cg_tol * bnorm
                diffs.append(max(_gap(a, b) for a, b in (
                    (self.x, x), (self.ypx, ypx), (self.r, r_),
                    (self.pk, pk), (self.rz, rz), (self.go, go))))
            self.x, self.ypx = x, ypx

    return Lockstep


def profiled_solve(device="cuda"):
    """One warm row solve (20 cameras, 500 points) under
    perfbench/lib/tracing.capture, as the benchmark traces a unit: the
    solve's counters, the host's copy calls against the copies the device
    ran, the fetches that pin the device's clock to the host's
    (perfbench/lib/spans.clock_offsets), the host's graph launches and
    the reading of pcg_launches_per_iter.bal.  Run it as the first
    profile of a process: later profiles drop kernels."""
    import types

    from perfbench.lib import spans, spec, tracing

    dev = torch.device(device)
    p, ell = ba.pack_camera_major(ba.BAProblem.from_numpy(
        dev, **problem(False, n_cams=20, n_pts=500)))
    opts = options(False)
    ba.solve_ba(p, opts, ell)  # builds the kernels, warms the shapes
    ba.reset_counts()
    _, t = tracing.capture(lambda: ba.solve_ba(p, opts, ell), dev)

    def ids(prefix):
        return [i for i, n in enumerate(t.names) if n.startswith(prefix)]

    pts = spans.clock_offsets(t)
    run = types.SimpleNamespace(trace=t, trace_unit=dict(ba.COUNTS))
    return dict(
        counts=dict(ba.COUNTS),
        host_copies=int(np.isin(t.host_name, ids("cudaMemcpy")).sum()),
        device_copies=int(np.isin(t.dev_name, ids("Memcpy")).sum()),
        fetches=None if pts is None else len(pts[0]),
        graph_launches=int(np.isin(t.host_name, ids("cudaGraphLaunch")).sum()),
        launches_per_iter=spec.metric_reader("pcg_launches_per_iter.bal")(run))
