"""The registration gate of drift/loop error detection (port of
xrsfm_tpu/mapper/error_correct.py:50-214; reference: ErrorDetector,
src/geometry/error_detector.cc:5-159).

A new pose must agree with the epipolar geometry of its matched,
registered neighbours.  Loop correction itself (TryLocate, the scale pose
graph, CheckAndCorrectPose) is not ported yet: ROADMAP.md, Still to port,
item 2.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import kernels
from ..base.map import SfMMap
from ..ops import epipolar
from ..utils import geometry as G


@dataclasses.dataclass
class ErrorCorrectOptions:
    angle_band_deg: float = 2.0  # reference: sin 2 deg band
    min_good_ratio: float = 0.8  # reference: >= 80% inliers = good pair
    pure_rotation_th: float = 0.01
    min_covis_engage: int = 10  # engage detection when covis obs < 10


def _rel_pose_stats(q1, t1, q2, t2, uv1, uv2, mask, th):
    """Relative-pose consistency of P pairs: relative pose -> essential ->
    Sampson -> (good, total, baseline) [P, 3]."""
    qr, tr = G.pose_relative(q2, t2, q1, t1)  # T21: x2 = R x1 + t
    baseline = torch.linalg.norm(tr, dim=-1)
    E = epipolar.essential_from_pose(
        qr, tr / baseline.clamp_min(1e-12)[..., None])
    good = (epipolar.sampson_error(E, uv1, uv2) < th) & mask
    return (good.sum(dim=-1).to(uv1.dtype), mask.sum(dim=-1).to(uv1.dtype),
            baseline)


def _pair_stats_many(m: SfMMap, pair_list, opts: ErrorCorrectOptions,
                     pose_override=None, *, device):
    """Consistency stats of many (id1, id2, matches) in one device pass.
    pose_override: {frame: (q, t)} evaluated instead of the map pose.
    Returns [P, 3] numpy (good, total, baseline)."""
    pose_override = pose_override or {}

    def pose(f):
        return pose_override.get(f, (m.q[f], m.t[f]))

    P = len(pair_list)
    nb = max(len(mt) for _, _, mt in pair_list)
    q1 = np.zeros((P, 4), np.float32)
    q2 = np.zeros((P, 4), np.float32)
    t1 = np.zeros((P, 3), np.float32)
    t2 = np.zeros((P, 3), np.float32)
    uv1 = np.zeros((P, nb, 2), np.float32)
    uv2 = np.zeros((P, nb, 2), np.float32)
    mask = np.zeros((P, nb), bool)
    for i, (id1, id2, mt) in enumerate(pair_list):
        n = len(mt)
        q1[i], t1[i] = pose(id1)
        q2[i], t2[i] = pose(id2)
        uv1[i, :n] = m.kps_norm[id1][mt[:, 0]]
        uv2[i, :n] = m.kps_norm[id2][mt[:, 1]]
        mask[i, :n] = True
    th = float(np.float32(float(np.sin(np.deg2rad(opts.angle_band_deg))) ** 2))
    return np.stack(kernels.on_device(
        _rel_pose_stats, q1, t1, q2, t2, uv1, uv2, mask, th=th,
        device=device), axis=1)


def _good_from_stats(stats_row, opts: ErrorCorrectOptions) -> bool:
    good, total, baseline = stats_row
    if baseline < opts.pure_rotation_th:
        return True  # pure rotation: skip (reference behavior)
    return bool(good >= opts.min_good_ratio * max(total, 1.0))


def check_all_relative_pose(m: SfMMap, frame: int,
                            opts: ErrorCorrectOptions,
                            engage_all: bool = False, *,
                            device) -> List[int]:
    """Neighbours whose relative pose to `frame` disagrees with the
    matches (reference: CheckAllRelativePose, error_detector.cc:103-159).
    engage_all=True checks every registered pair; otherwise only weakly
    covisible pairs, as in the reference."""
    todo = []
    for pid in m.frame_pairs_of[frame]:
        id1, id2, matches = m.pairs[pid]
        other = id2 if id1 == frame else id1
        if not m.registered[other] or len(matches) < 8:
            continue
        if not engage_all:
            p2d = matches[:, 0] if id1 == frame else matches[:, 1]
            tids = m.track_of[frame][p2d]
            tids = tids[tids >= 0]
            tids = tids[m.track_valid[tids]]
            shared = sum(1 for t in tids if other in m.track_obs[int(t)])
            if shared >= opts.min_covis_engage:
                continue
        todo.append((id1, id2, matches, other))
    if not todo:
        return []
    stats = _pair_stats_many(m, [(a, b, mt) for a, b, mt, _ in todo], opts,
                             device=device)
    return [
        other for (_, _, _, other), s in zip(todo, stats)
        if not _good_from_stats(s, opts)
    ]


def registration_is_consistent(m: SfMMap, frame: int,
                               opts: Optional[ErrorCorrectOptions] = None,
                               *, device):
    """Post-registration gate: the new pose must satisfy the epipolar
    geometry of at least half of its matched registered neighbours.
    Catches the planar-PnP two-fold ambiguity, a mirrored pose whose
    reprojections fit but whose relative geometry is wrong."""
    opts = opts or ErrorCorrectOptions()
    todo = []
    for pid in m.frame_pairs_of[frame]:
        id1, id2, matches = m.pairs[pid]
        other = id2 if id1 == frame else id1
        if not m.registered[other] or other == frame or len(matches) < 8:
            continue
        todo.append((id1, id2, matches))
    if not todo:
        return True
    stats = _pair_stats_many(m, todo, opts, device=device)
    n_bad = sum(1 for s in stats if not _good_from_stats(s, opts))
    return n_bad <= 0.5 * len(todo)
