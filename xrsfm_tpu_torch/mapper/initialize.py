"""Two-view map initialization (port of xrsfm_tpu/mapper/initialize.py;
reference: FindInitFramePair / CheckInitFramePair / InitializeMap,
src/geometry/map_initializer.cc:13-206).

Candidates are probed in chunks: one batched device pass (essential
RANSAC + pose recovery + triangulation stats) per chunk of candidate
pairs, and every gate of the relaxation ladder is evaluated on the host
from the cached stats.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import kernels
from ..base.map import SfMMap

# candidates per probe: the first probe takes only the top 4, since the
# best-matched pair passes the strictest gates in most scenes
_CHUNK_FIRST = 4
_CHUNK = 16


@dataclasses.dataclass
class InitOptions:
    # reference thresholds (map_initializer.cc): E RANSAC at 10px/f,
    # >= 50% triangulable, >= 50% of those above 16 deg (retry 8 deg),
    # > 200 points for large scenes
    ransac_px: float = 10.0
    min_tri_ratio: float = 0.5
    good_angle_deg: float = 16.0
    retry_angle_deg: float = 8.0
    min_points: int = 100
    max_candidates: int = 50


def _probe_chunk(m: SfMMap, cands, ransac_px: float, device):
    """Essential RANSAC + pose/triangulation probe of a chunk of candidate
    pairs in one batched pass.  Returns per-candidate host dicts (q, t,
    n_good, X, good, ang, n_inl, success), cropped to the match count."""
    K = len(cands)
    b = max(len(mt) for _, _, mt in cands)
    uv1 = np.zeros((K, b, 2), np.float32)
    uv2 = np.zeros((K, b, 2), np.float32)
    mask = np.zeros((K, b), bool)
    th = np.zeros(K, np.float32)
    gens = []
    for k, (id1, id2, matches) in enumerate(cands):
        n = len(matches)
        uv1[k, :n] = m.kps_norm[id1][matches[:, 0]]
        uv2[k, :n] = m.kps_norm[id2][matches[:, 1]]
        mask[k, :n] = True
        focal = float(m.cameras[int(m.cam_of_frame[id1])][0])
        th[k] = (ransac_px / focal) ** 2
        # the integer the JAX package seeds its PRNGKey with
        gens.append(torch.Generator(device=device).manual_seed(
            (id1 * 32768 + id2) & 0x7FFFFFFF))
    q, t, n_good, X, good, ang, n_inl, success = kernels.on_device(
        kernels.init_probe_batch, uv1, uv2, mask, th, generators=gens,
        device=device)
    out = []
    for k, (_, _, matches) in enumerate(cands):
        n = len(matches)
        out.append(dict(
            q=q[k], t=t[k], n_good=int(n_good[k]), X=X[k, :n],
            good=good[k, :n], ang=ang[k, :n], n_inl=int(n_inl[k]),
            success=bool(success[k]),
        ))
    return out


def _gate(stats, opts: InitOptions):
    """Host-side CheckInitFramePair gates over cached probe stats.
    Returns the accept mask, or None if the candidate fails."""
    if not stats["success"]:
        return None
    n_inl, n_good = stats["n_inl"], stats["n_good"]
    if n_inl == 0 or n_good < opts.min_tri_ratio * n_inl:
        return None
    good, ang = stats["good"], stats["ang"]
    for ang_th in (opts.good_angle_deg, opts.retry_angle_deg):
        n_wide = int(np.count_nonzero(good & (ang > np.deg2rad(ang_th))))
        if n_wide >= opts.min_tri_ratio * n_good and n_good >= opts.min_points:
            return good & np.isfinite(stats["X"]).all(axis=1)
    return None


def check_init_pair(m: SfMMap, id1: int, id2: int, matches,
                    opts: InitOptions, *, device):
    """Single-candidate probe + gate.  Returns (ok, q2, t2, xyz [M, 3],
    accept_mask [M])."""
    if len(matches) < 8:
        return False, None, None, None, None
    stats = _probe_chunk(m, [(id1, id2, matches)], opts.ransac_px, device)[0]
    accept = _gate(stats, opts)
    if accept is None:
        return False, None, None, None, None
    return True, stats["q"], stats["t"], stats["X"], accept


def _gate_ladder(opts: InitOptions):
    """Graceful degradation: if no pair clears the gates, retry with
    relaxed minimums.  The reference's fixed gates (>200 points, 16/8 deg
    tri-angle, map_initializer.cc:13-139) assume 8k-feature wide-baseline
    internet images; small scenes need a lower point minimum, and
    video-like forward/arc motion (e.g. KITTI) has single-digit
    triangulation angles on EVERY pair, so the angle ladder extends
    downward rather than failing outright — BA and the track filters
    recover the weaker initial conditioning."""
    attempts = [opts]
    for mp in (50, 30):
        if mp < opts.min_points:
            attempts.append(dataclasses.replace(opts, min_points=mp))
    mp = min(opts.min_points, 30)
    for good_deg, retry_deg in ((4.0, 2.0), (1.0, 0.5)):
        if good_deg < opts.good_angle_deg:
            attempts.append(dataclasses.replace(
                opts, min_points=mp, good_angle_deg=good_deg,
                retry_angle_deg=retry_deg,
            ))
    return attempts


def find_and_initialize(m: SfMMap, opts: InitOptions = InitOptions(),
                        init_id1: int = -1, init_id2: int = -1, *,
                        device) -> bool:
    """Pick the best init pair, set the two poses, create initial tracks.

    Candidate order: pairs sorted by inlier-match count descending
    (reference sorts by #matched-frames then #correspondences,
    map_initializer.cc:67-139 — match count is the dense-graph
    equivalent).  A user-forced (init_id1, init_id2) pair probes first.
    """
    order = sorted(
        range(len(m.pairs)), key=lambda i: -len(m.pairs[i][2])
    )[: opts.max_candidates]
    attempts = _gate_ladder(opts)
    if init_id1 >= 0 and init_id2 >= 0:
        # explicit init ids are authoritative (reference: user-set
        # init_id1/init_id2, incremental_mapper.h:14-24): run the forced
        # pair through the ENTIRE relaxation ladder before considering
        # any automatic candidate
        forced = [
            i for i in range(len(m.pairs))
            if {m.pairs[i][0], m.pairs[i][1]} == {init_id1, init_id2}
            and len(m.pairs[i][2]) >= 8
        ]
        for pi in forced:
            id1, id2, matches = m.pairs[pi]
            stats = _probe_chunk(m, [(id1, id2, matches)], opts.ransac_px,
                                 device)[0]
            for att in attempts:
                accept = _gate(stats, att)
                if accept is not None:
                    _commit(m, id1, id2, matches, stats, accept)
                    return True
        order = [i for i in order if i not in forced]
    cands = [m.pairs[pi] for pi in order if len(m.pairs[pi][2]) >= 8]

    # Probe chunk by chunk in priority order.  If any probed candidate
    # passes the STRICTEST attempt we can commit immediately (all
    # unprobed candidates have lower priority); otherwise cache stats
    # and walk the relaxation ladder once everything is probed.
    probed = []
    c0 = 0
    while c0 < len(cands):
        size = _CHUNK_FIRST if c0 == 0 else _CHUNK
        chunk = cands[c0:c0 + size]
        probed.extend(zip(chunk, _probe_chunk(m, chunk, opts.ransac_px,
                                              device)))
        for (id1, id2, matches), stats in probed[c0:]:
            accept = _gate(stats, attempts[0])
            if accept is not None:
                _commit(m, id1, id2, matches, stats, accept)
                return True
        c0 += size
    for att in attempts[1:]:
        for (id1, id2, matches), stats in probed:
            accept = _gate(stats, att)
            if accept is not None:
                _commit(m, id1, id2, matches, stats, accept)
                return True
    return False


def _commit(m: SfMMap, id1: int, id2: int, matches, stats, accept):
    """frame1 at identity, frame2 at (q, t); create the initial tracks
    (reference: InitializeMap, map_initializer.cc:141-206)."""
    m.q[id1] = [1.0, 0, 0, 0]
    m.t[id1] = 0.0
    m.q[id2] = stats["q"]
    m.t[id2] = stats["t"]
    m.registered[id1] = True
    m.registered[id2] = True
    m.init_id1, m.init_id2 = id1, id2
    X = stats["X"]
    for k in np.nonzero(accept)[0]:
        tid = m.new_track(X[k])
        m.add_observation(tid, id1, int(matches[k, 0]))
        m.add_observation(tid, id2, int(matches[k, 1]))
