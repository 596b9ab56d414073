"""Driver of bundle-adjustment traffic: solves back to back, each as the
mapper's BA glue pays for it.

A unit is one solve: the problem as CPU tensors (BAProblem.from_numpy, as
mapper/ba_glue.build_problem leaves it), optim/ba.pack_camera_major onto
the card (host packing and one transfer), solve_ba(p, opts, ell), and the
solved cameras and points fetched to the host.

The configuration (kind "ba_problem") gives the problem's shape
(gen/bal.py); the traffic mix gives the solve's options and the local
problems: n_problems of them, each a camera and its n_neighbours most
covisible cameras freed with their points, every other camera that sees
those points fixed, the intrinsics at the truth and not solved.  The units
cycle through them in a seeded order; set-up solves each of them
warm_rounds times.

The check solves each sampled problem with the plain float64 reference
(reference/ba.py) under the same options, and compares:

  cost_gap         (cost of the program's end state - the reference's end
                   cost) / the reference's end cost, both costs the
                   reference's float64 evaluation;
  cost_report_gap  |the cost solve_ba reported - the float64 cost of the
                   state it returned| / the latter;
  center_gap       RMS distance between the program's and the reference's
                   free camera centres, over the median spacing of the
                   problem's cameras,

each the largest over the sampled solves.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..gen import bal
from ..reference import ba as ref

_STATE = ("cam_q", "cam_t", "cam_intri", "points")


def centers(state: dict) -> np.ndarray:
    R = ref.quat_to_rot(torch.as_tensor(np.asarray(state["cam_q"],
                                                   np.float64)))
    t = torch.as_tensor(np.asarray(state["cam_t"], np.float64))
    return (-(R.transpose(1, 2) @ t[..., None])[..., 0]).numpy()


def _spacing(c: np.ndarray) -> float:
    d = np.linalg.norm(c[:, None] - c[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return float(np.median(d.min(1)))


class Driver:
    def __init__(self, cell, config, seed, device, workdir):
        from xrsfm_tpu_torch.optim import ba as BA

        self.BA = BA
        self.cfg = config
        self.tr = cell.traffic
        self.seed = seed
        self.dev = torch.device(device)
        o = self.tr["options"]
        self.opts = BA.BAOptions(
            max_iters=o["max_iters"], huber_px=o["huber_px"],
            cg_iters=o["cg_iters"], cg_tol=o["cg_tol"],
            optimize_intrinsics=o["optimize_intrinsics"])
        self.outputs = []
        self.next = 0

    def setup(self):
        prob = bal.make_problem(self.cfg, self.seed)
        # the intrinsics a local solve holds are the map's current ones:
        # here the truth
        start = dict(prob["start"], cam_intri=prob["truth"]["cam_intri"])
        covis = bal.covisibility(start)
        cs = bal.local_centers(self.cfg["n_cameras"], self.tr["n_problems"],
                               self.seed)
        self.problems = [bal.local_problem(start, covis, int(c),
                                           self.tr["n_neighbours"])
                         for c in cs]
        self.order = list(range(len(self.problems)))

    def warm(self):
        for _ in range(self.tr["warm_rounds"]):
            for k in self.order:
                self._solve(k)
        self.outputs.clear()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _solve(self, k: int) -> dict:
        BA = self.BA
        arr = self.problems[k]
        c0, l0 = dict(BA.COUNTS), dict(BA.LAUNCHES)
        rf = torch.profiler.record_function
        t0 = time.perf_counter()
        with rf("perfbench.pack"):
            prob = BA.BAProblem.from_numpy("cpu", **arr)
            packed, ell = BA.pack_camera_major(prob, device=self.dev)
            self._sync()
        t1 = time.perf_counter()
        with rf("perfbench.solve"):
            sol, info = BA.solve_ba(packed, self.opts, ell)
            self._sync()
        t2 = time.perf_counter()
        with rf("perfbench.fetch"):
            out = {f: getattr(sol, f).cpu().numpy() for f in _STATE}
        t3 = time.perf_counter()
        self.outputs.append((k, out, float(info["final_cost"])))
        d = lambda a, b, key: a[key] - b[key]
        return {
            "problem": k, "seconds": t3 - t0,
            "spans": {"pack": t1 - t0, "solve": t2 - t1, "fetch": t3 - t2},
            "lm_iters": d(BA.COUNTS, c0, "lm_iters"),
            "cg_iters": d(BA.COUNTS, c0, "cg_iters"),
            "cam_calls": d(BA.LAUNCHES, l0, "ba_cam_rows_cuda"),
            "pt_calls": d(BA.LAUNCHES, l0, "ba_pt_rows_cuda"),
            "shape": {"C": len(arr["cam_q"]), "P": len(arr["points"]),
                      "O": len(arr["obs_cam"]),
                      "D": 14 if self.opts.optimize_intrinsics else 6},
        }

    def unit(self) -> dict:
        k = self.order[self.next % len(self.order)]
        self.next += 1
        return self._solve(k)

    def release(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, k: int, control: bool = False):
        """The plain solve of problem k: (state dict, its float64 cost)."""
        o = self.tr["options"]
        s, cost, _ = ref.solve(
            self.problems[k], self.dev,
            optimize_intrinsics=o["optimize_intrinsics"],
            huber_px=o["huber_px"], max_iters=o["max_iters"],
            control=control)
        state = s.to_numpy()
        if control:
            cost = self.evaluate(k, state)
        return state, cost

    def evaluate(self, k: int, state: dict) -> float:
        o = self.tr["options"]
        return ref.evaluate(self.problems[k], state, self.dev,
                            optimize_intrinsics=o["optimize_intrinsics"],
                            huber_px=o["huber_px"])

    def compare(self, k: int, state: dict, reported: float,
                ref_state: dict, ref_cost: float) -> dict:
        """The numbers of one solve's end state against the reference's."""
        c = self.evaluate(k, state)
        free = ~np.asarray(self.problems[k]["fix_cam"], bool)
        cp, cr = centers(state), centers(ref_state)
        rms = float(np.sqrt(np.mean(np.sum((cp - cr)[free] ** 2, axis=1))))
        return {"cost_gap": (c - ref_cost) / ref_cost,
                "cost_report_gap": abs(reported - c) / c,
                "center_gap": rms / _spacing(cr)}

    def check(self, units) -> dict:
        rng = bal.rng_for(self.seed, 9)
        n = len(self.outputs)
        pick = sorted(rng.choice(n, min(n, self.tr["check_solves"]),
                                 replace=False))
        refs = {}
        worst = {}
        for i in pick:
            k, state, reported = self.outputs[i]
            if k not in refs:
                refs[k] = self.reference(k)
            nums = self.compare(k, state, reported, *refs[k])
            for name, v in nums.items():
                worst[name] = max(worst.get(name, -np.inf), v)
        return worst
