"""Driver of global bundle-adjustment traffic: the whole problem solved
back to back, every solve from the same seeded start, each paid as the
mapper's BA glue pays for it.

A unit is one solve of the configuration's whole problem (gen/bal.py's
"start": the seeded perturbation of the truth, focal lengths moved, k1 =
k2 = 0): the problem as CPU tensors (BAProblem.from_numpy), optim/ba.
pack_camera_major onto the card (host packing and one transfer),
solve_ba(p, opts, ell), and the solved cameras, intrinsics and points
fetched to the host.  The traffic mix gives the solve's options;
set-up solves the problem warm_rounds times.

The check solves the problem once with the plain float64 reference
(reference/ba.py) under the same options and from the same start, and
judges the window's first and last outputs against it, so that what is
judged does not depend on how many solves fit the window:

  cost_gap         (cost of the program's end state - the reference's end
                   cost) / the reference's end cost, both costs the
                   reference's float64 evaluation;
  cost_report_gap  |the cost solve_ba reported - the float64 cost of the
                   state it returned| / the latter;
  center_gap       RMS distance between the program's and the reference's
                   free camera centres, over the median spacing of the
                   cameras;
  focal_gap        RMS over the cameras of |f - f_ref| / f_ref,

each the larger of the two outputs'.  A unit's record has the ba driver's
keys and lm_accepts, the LM candidates the solve accepted
(optim/ba.COUNTS["lm_accepts"], where the program counts them).
"""

from __future__ import annotations

import numpy as np

from ..gen import bal
from . import ba


class Driver(ba.Driver):
    def setup(self):
        self.problems = [bal.make_problem(self.cfg, self.seed)["start"]]
        self.order = [0]

    def _solve(self, k: int) -> dict:
        counts = self.BA.COUNTS
        a0 = counts.get("lm_accepts")
        rec = super()._solve(k)
        # only the first and the last output are judged
        del self.outputs[1:-1]
        if a0 is not None:
            rec["lm_accepts"] = counts["lm_accepts"] - a0
        return rec

    def compare(self, k: int, state: dict, reported: float,
                ref_state: dict, ref_cost: float) -> dict:
        nums = super().compare(k, state, reported, ref_state, ref_cost)
        f = np.asarray(state["cam_intri"], np.float64)[:, 0]
        fr = np.asarray(ref_state["cam_intri"], np.float64)[:, 0]
        nums["focal_gap"] = float(np.sqrt(np.mean(((f - fr) / fr) ** 2)))
        return nums

    def judge(self, outputs) -> dict:
        """The numbers of `outputs` ((k, state, reported cost) tuples), the
        largest of each, against one float64 reference solve."""
        ref_state, ref_cost = self.reference(0)
        worst = {}
        for k, state, reported in outputs:
            for name, v in self.compare(k, state, reported, ref_state,
                                        ref_cost).items():
                worst[name] = max(worst.get(name, -np.inf), v)
        return worst

    def check(self, units) -> dict:
        return self.judge(self.outputs)
