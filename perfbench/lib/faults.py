"""Faults planted in the program underneath a run, each of which the cell's
check has to catch: a step that returns its state unchanged, half of the
work left out, an answer altered where it is produced.  (No cell spans
chips, so no exchange between them can be left out.)

inject(driver, fault, setattr) plants one through `setattr(obj, name,
value)`: pytest's monkeypatch.setattr in the tests, a Patch that undoes
itself in perfbench/calibrate.py.
"""

from __future__ import annotations

import dataclasses

FAULTS = ("unchanged", "half_left_out", "answer_altered")


class Patch:
    """setattr that remembers, and undo() that puts everything back."""

    def __init__(self):
        self._undo = []

    def __call__(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def _unchanged(solve_ba):
    def solve(p, opts, ell=None):
        return solve_ba(p, dataclasses.replace(opts, max_iters=0), ell)
    return solve


def _half_left_out(solve_ba):
    def solve(p, opts, ell=None):
        w = p.obs_w.clone()
        w[::2] = 0.0
        return solve_ba(dataclasses.replace(p, obs_w=w), opts, ell)
    return solve


def _answer_altered(solve_ba):
    def solve(p, opts, ell=None):
        sol, info = solve_ba(p, opts, ell)
        pts = sol.points.clone()
        pts[0] += 1.0
        return dataclasses.replace(sol, points=pts), info
    return solve


_BA = {"unchanged": _unchanged, "half_left_out": _half_left_out,
       "answer_altered": _answer_altered}


def inject(driver: str, fault: str, setattr_) -> None:
    """Plant `fault` under the cell's driver ("ba" or "pipeline").

    ba: optim/ba.solve_ba returns its input (no LM iteration), or solves
    with every other observation's weight zeroed, or moves the first
    point of its answer by 1 m.  pipeline: the mapper's bundle
    adjustments return their input, or every other image's SIFT features
    are dropped, or the last registered frame's translation is moved by
    1 m as the model is written."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if driver == "ba":
        from xrsfm_tpu_torch.optim import ba as BA

        setattr_(BA, "solve_ba", _BA[fault](BA.solve_ba))
        return
    from xrsfm_tpu_torch.mapper import ba_glue
    from xrsfm_tpu_torch.pipelines import run_matching as RM
    from xrsfm_tpu_torch.pipelines import run_reconstruction as RR

    if fault == "unchanged":
        setattr_(ba_glue, "solve_ba", _unchanged(ba_glue.solve_ba))
    elif fault == "half_left_out":
        sift = RM._sift_features

        def half(images_dir, names, *a, **k):
            feats = sift(images_dir, names, *a, **k)
            return [RM._no_features(f.name) if i % 2 else f
                    for i, f in enumerate(feats)]
        setattr_(RM, "_sift_features", half)
    else:
        write = RR.map_to_colmap

        def altered(m, out_dir):
            i = int(m.registered.nonzero()[0][-1])
            m.t[i] = m.t[i] + 1.0
            return write(m, out_dir)
        setattr_(RR, "map_to_colmap", altered)
