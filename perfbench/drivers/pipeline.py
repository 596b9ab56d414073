"""Driver of image-pipeline traffic: whole passes from pixels to a model.

Set-up renders the configuration's image sequence from the seed
(gen/scenes.py) into the run's work directory.  A unit is one pass of the
documented pipeline on those images, each stage ending in a synchronise:

  extract      pipelines/run_matching.get_features (SIFT on the card)
  match        pipelines/run_matching.main with the features cached
               (the traffic's matching mode; pair matching and
               F-verification)
  reconstruct  pipelines/run_reconstruction.main (the incremental mapper
               at its default MapperOptions), which writes a COLMAP model

Every pass starts from the images alone: its features, pairs and model go
to directories of their own.  The check judges the models of check_passes
passes drawn from the seed among the window's and the traced one's, each
number the largest over them:

  missing_frames  frames the model does not register;
  cost_gap        the model, as a bundle-adjustment problem on its own
                  tracks (reference/model.bundle), solved again by the
                  plain float64 reference (reference/ba.py) from the
                  model's own state under the mapper's last robust cost
                  (the traffic's `resolve`) and gauge (its initial pair:
                  the first frame fixed, the second's translation fixed):
                  (float64 cost of the model - the reference's end cost) /
                  the reference's end cost;

and, read and printed but not compared (reference/model.judge, against
the rendered scene): ate_pct, reproj_px, plane_pct.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from ..gen import scenes
from ..reference import ba as ref
from ..reference import model as judge


class Driver:
    def __init__(self, cell, config, seed, device, workdir):
        from xrsfm_tpu_torch.optim import ba as BA
        from xrsfm_tpu_torch.pipelines import run_matching as RM
        from xrsfm_tpu_torch.pipelines import run_reconstruction as RR

        self.RM, self.RR, self.BA = RM, RR, BA
        self.cfg = config
        self.tr = cell.traffic
        self.seed = seed
        self.dev = torch.device(device)
        self.ws = workdir
        self.models = []
        self.k = 0

    def setup(self):
        self.names, self.planes, self.poses = scenes.write_sequence(
            self.cfg, self.seed, self.ws, self.dev)
        self.images = os.path.join(self.ws, "images")
        self.camera = os.path.join(self.ws, "camera.txt")
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _pass(self, tag: str) -> dict:
        RM, RR, dev = self.RM, self.RR, self.dev
        bins = os.path.join(self.ws, f"bins_{tag}")
        model = os.path.join(self.ws, f"model_{tag}")
        os.makedirs(bins)
        rf = torch.profiler.record_function
        spans, stats = {}, {}
        c0 = dict(self.BA.COUNTS)
        t0 = time.perf_counter()
        with rf("perfbench.extract"):
            RM.get_features(self.images, os.path.join(bins, "ftr.bin"),
                            self.names, verbose=False, device=dev)
            self._sync()
        t1 = time.perf_counter()
        with rf("perfbench.match"):
            RM.main(self.images, "", self.tr["matching"], bins, device=dev)
            self._sync()
        t2 = time.perf_counter()
        with rf("perfbench.reconstruct"):
            m = RR.main(bins, self.camera, model, device=dev, stats=stats)
            self._sync()
        t3 = time.perf_counter()
        shutil.rmtree(bins)
        ms = stats.get("mapper")
        rec = {"frames": len(self.names), "seconds": t3 - t0,
               "spans": {"extract": t1 - t0, "match": t2 - t1,
                         "reconstruct": t3 - t2},
               "failed": m is None, "model": model,
               "gauge": None if m is None else
               (self.names[m.init_id1], self.names[m.init_id2]),
               "lm_iters": self.BA.COUNTS["lm_iters"] - c0["lm_iters"],
               "cg_iters": self.BA.COUNTS["cg_iters"] - c0["cg_iters"]}
        if ms is not None:
            rec["ba_s"] = ms.time_lba + ms.time_gba
        return rec

    def warm(self):
        rec = self._pass("warm")
        shutil.rmtree(rec["model"], ignore_errors=True)

    def unit(self) -> dict:
        rec = self._pass(str(self.k))
        self.k += 1
        if not rec["failed"]:
            self.models.append((rec["model"], rec["gauge"]))
        return rec

    def release(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, model_dir: str, gauge) -> dict:
        nums = judge.judge(model_dir, self.names, self.planes, self.poses)
        r = self.tr["resolve"]
        arrays = judge.bundle(model_dir, gauge)
        kw = dict(optimize_intrinsics=False, huber_px=r["huber_px"])
        own = ref.evaluate(arrays, {}, self.dev, **kw)
        _, best, _ = ref.solve(arrays, self.dev, max_iters=r["max_iters"],
                               **kw)
        nums["cost_gap"] = (own - best) / best
        return nums

    def check(self, units) -> dict:
        rng = np.random.default_rng([int(self.seed) % 2**64, 9])
        n = len(self.models)
        pick = sorted(rng.choice(n, min(n, self.tr["check_passes"]),
                                 replace=False))
        worst = {}
        for model_dir, gauge in (self.models[i] for i in pick):
            for name, v in self.judge(model_dir, gauge).items():
                worst[name] = max(worst.get(name, float("-inf")), v)
        return worst
