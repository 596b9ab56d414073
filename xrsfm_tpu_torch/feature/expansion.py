"""Covisibility-based match expansion, EC-SfM (port of
xrsfm_tpu/feature/expansion.py; reference: src/feature/match_expansion.
{h,cc} and ExpansionAndMatching, src/feature/feature_processing.cc:324-377;
run_matching.cc "covisibility" branch :214-253).

Per iteration, as the reference:
  (a) BFS the current pair graph from the init pair (GetConnectedFrames,
      match_expansion.cc:479-515);
  (b) SimulationSfM: a simulated incremental reconstruction over the
      correspondence graph, giving the frames that could register at
      thresholds 30 and 100 (:534-623);
  (c) covisibility candidates: connected pairs with few matches that
      share >= 2 transitive tracks landing in the same cell of a 10x10
      grid on both sides (GetCandidateCovisibility :660-766);
  (d) retrieval candidates for frames not yet connected that enough
      registered frames retrieve (GetMayreg :625-658,
      GetCandidateSimilarity :381-400);
then match and verify the proposed pairs on the device
(feature/matching) and repeat.  The graph logic is host numpy and scipy,
run while the device waits.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from . import matching as fmatch
from ..utils.io_features import (FrameFeatures, FramePairData,
                                 read_frame_pairs, write_frame_pairs)

_NUM_PATCH = 10  # reference: _Np_, match_expansion.h:14
_MIN_COVIS_FEATURES = 2  # reference: _T_, match_expansion.h:13
_MAX_EXISTING_MATCHES = 50  # reference: match_expansion.cc:660-741
_NUM_ITERATIONS = 5  # reference: feature_processing.cc:324-377


class MatchMapLite:
    """Track structure over (frame, p2d) nodes + patch grid
    (reference: MatchMap, match_expansion.h:21-96).

    Track identity = connected components over the accumulated inlier
    match edges, computed BATCHED (scipy csgraph over one edge array)
    and cached until the next add_pair, in place of a per-edge Python
    union-find."""

    def __init__(self, features: Sequence[FrameFeatures], sizes=None):
        self.nf = len(features)
        self.kps = [f.keypoints[:, :2] for f in features]
        self._pending: List[np.ndarray] = []  # [M,2] int64 node-id pairs
        self._labels = None  # (sorted node ids, component label per node)
        self.patch = []
        for i, f in enumerate(features):
            if len(f.keypoints) == 0:
                self.patch.append(np.zeros(0, np.int32))
                continue
            kp = f.keypoints[:, :2]
            w = max(kp[:, 0].max(), 1.0) if sizes is None else sizes[i][0]
            h = max(kp[:, 1].max(), 1.0) if sizes is None else sizes[i][1]
            px = np.clip((kp[:, 0] / (w + 1e-6) * _NUM_PATCH), 0, _NUM_PATCH - 1)
            py = np.clip((kp[:, 1] / (h + 1e-6) * _NUM_PATCH), 0, _NUM_PATCH - 1)
            self.patch.append((py.astype(np.int32) * _NUM_PATCH + px.astype(np.int32)))
        self.pairs: Dict[Tuple[int, int], int] = {}  # (id1,id2) -> n_matches
        self.adj: Dict[int, Set[int]] = {}

    def add_pair(self, p: FramePairData):
        key = (min(p.id1, p.id2), max(p.id1, p.id2))
        self.pairs[key] = len(p.matches)
        self.adj.setdefault(p.id1, set()).add(p.id2)
        self.adj.setdefault(p.id2, set()).add(p.id1)
        inl = p.inlier_matches() if p.inlier_mask is not None else p.matches
        if len(inl):
            e = np.empty((len(inl), 2), np.int64)
            e[:, 0] = p.id1 * (1 << 22) + inl[:, 0].astype(np.int64)
            e[:, 1] = p.id2 * (1 << 22) + inl[:, 1].astype(np.int64)
            self._pending.append(e)

    @staticmethod
    def _cc(ii, n):
        """Batched connected components over edge index pairs [M,2]."""
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        # int32 data: duplicate edges (a pair re-added) are summed on CSR
        # conversion — int8 would wrap to 0 at 256 duplicates and drop
        # the edge from the component graph
        g = coo_matrix(
            (np.ones(len(ii), np.int32), (ii[:, 0], ii[:, 1])), shape=(n, n)
        )
        _, lab = connected_components(g, directed=False)
        return lab.astype(np.int64)

    def _components(self):
        """(node ids [N], component label per node [N]) over every
        matched keypoint.  Incremental: edges added since the last call
        are merged by running connected components over the (much
        smaller) LABEL graph instead of rebuilding the full node graph,
        since iterations 2+ add only a few hundred pairs."""
        if self._labels is not None and not self._pending:
            return self._labels
        if self._labels is None:
            if not self._pending:
                self._labels = (
                    np.zeros(0, np.int64), np.zeros(0, np.int64)
                )
                return self._labels
            E = np.concatenate(self._pending)
            self._pending = []
            nodes, idx = np.unique(E.reshape(-1), return_inverse=True)
            lab = self._cc(idx.reshape(-1, 2), len(nodes))
            self._labels = (nodes, lab)
            return self._labels
        nodes, lab = self._labels
        E = np.concatenate(self._pending)
        self._pending = []
        enodes = np.unique(E.reshape(-1))
        pos = np.searchsorted(nodes, enodes)
        pos_c = np.clip(pos, 0, len(nodes) - 1)
        is_new = (pos >= len(nodes)) | (nodes[pos_c] != enodes)
        nodes2 = np.union1d(nodes, enodes[is_new])
        lab2 = np.empty(len(nodes2), np.int64)
        lab2[np.searchsorted(nodes2, nodes)] = lab
        n_old_lab = int(lab.max()) + 1 if len(lab) else 0
        new_nodes = enodes[is_new]
        lab2[np.searchsorted(nodes2, new_nodes)] = n_old_lab + np.arange(
            len(new_nodes)
        )
        n_lab = n_old_lab + len(new_nodes)
        l1 = lab2[np.searchsorted(nodes2, E[:, 0])]
        l2 = lab2[np.searchsorted(nodes2, E[:, 1])]
        lpairs = np.unique(np.stack([l1, l2], 1), axis=0)
        merge = self._cc(lpairs, n_lab)
        self._labels = (nodes2, merge[lab2])
        return self._labels

    def connected_frames(self, seed: int) -> Set[int]:
        """BFS over the pair graph (reference: GetConnectedFrames)."""
        seen = {seed}
        stack = [seed]
        while stack:
            f = stack.pop()
            for g in self.adj.get(f, ()):
                if g not in seen:
                    seen.add(g)
                    stack.append(g)
        return seen

    def frame_tracks(self, frame: int) -> Dict[int, int]:
        """track label -> p2d for a frame's matched features."""
        nodes, lab = self._components()
        lo = int(np.searchsorted(nodes, frame << 22))
        hi = int(np.searchsorted(nodes, (frame + 1) << 22))
        p2d = (nodes[lo:hi] & ((1 << 22) - 1)).astype(np.int64)
        return {
            int(lb): int(pp) for lb, pp in zip(lab[lo:hi], p2d)
        }

    def sfm_cache(self):
        """(frame -> {track root -> p2d}, track root -> [frames]) — built
        once per expansion iteration and shared by both simulate_sfm
        thresholds and the covisibility candidate search (it was rebuilt
        3x per iteration before; each build is O(total matched
        keypoints) union-find traffic)."""
        ft = {f: self.frame_tracks(f) for f in range(self.nf)}
        tf: Dict[int, List[int]] = {}
        for f, tracks in ft.items():
            for r in tracks:
                tf.setdefault(r, []).append(f)
        return ft, tf

    def simulate_sfm(self, init_pair: Tuple[int, int], threshold: int,
                     cache=None) -> Set[int]:
        """Simulated incremental registration: greedily register the
        frame seeing the most already-triangulated tracks until none
        reaches `threshold` (reference: SimulationSfM,
        match_expansion.cc:534-601).

        Incremental counters + a lazy max-heap replace the reference's
        full rescan per registration round (O(F^2 x tracks/frame)): when
        a frame registers,
        only the frames sharing its newly-triangulated tracks get their
        counters bumped (total work O(sum of track lengths)).  Greedy
        order is preserved exactly: the heap pops max count, ties to the
        lowest frame id, and an entry is acted on only if still fresh."""
        import heapq

        ft, tf = cache if cache is not None else self.sfm_cache()
        tri: Set[int] = set()
        registered: Set[int] = set(init_pair)
        cnt = [0] * self.nf
        heap: List[Tuple[int, int]] = []

        def add_frame_tracks(f: int):
            for r in ft[f].keys():
                if r in tri:
                    continue
                tri.add(r)
                for g in tf.get(r, ()):
                    if g not in registered:
                        cnt[g] += 1
                        heapq.heappush(heap, (-cnt[g], g))

        for f in init_pair:
            add_frame_tracks(f)
        while heap:
            c, f = heapq.heappop(heap)
            if f in registered or -c != cnt[f]:
                continue  # stale entry
            if -c < threshold:
                break  # fresh heap top below threshold: nobody qualifies
            registered.add(f)
            add_frame_tracks(f)
        return registered


def _covisibility_candidates(
    mm: MatchMapLite,
    connected: Set[int],
    registered: Set[int],
    id2rank: Dict[int, List[int]],
    frame_tracks: Dict[int, Dict[int, int]] | None = None,
) -> List[Tuple[int, int]]:
    """(reference: GetCandidateCovisibility, match_expansion.cc:660-766)."""
    out = []
    if frame_tracks is None:
        frame_tracks = {f: mm.frame_tracks(f) for f in connected}
    for id1 in connected:
        ranks = id2rank.get(id1, [])
        for id2 in ranks:
            if id2 not in connected or id1 == id2:
                continue
            if id1 not in registered and id2 not in registered:
                continue
            key = (min(id1, id2), max(id1, id2))
            if mm.pairs.get(key, 0) > _MAX_EXISTING_MATCHES:
                continue
            t1 = frame_tracks[id1]
            t2 = frame_tracks[id2]
            common = t1.keys() & t2.keys()
            if len(common) < _MIN_COVIS_FEATURES:
                continue
            # patch test: >= 2 common tracks landing in the same patch on
            # both sides
            groups: Dict[Tuple[int, int], int] = {}
            ok = False
            for r in common:
                g = (int(mm.patch[id1][t1[r]]), int(mm.patch[id2][t2[r]]))
                groups[g] = groups.get(g, 0) + 1
                if groups[g] >= _MIN_COVIS_FEATURES:
                    ok = True
                    break
            if ok:
                out.append(key)
    return sorted(set(out))


def _mayreg_candidates(
    mm: MatchMapLite,
    connected: Set[int],
    registered: Set[int],
    id2rank: Dict[int, List[int]],
) -> List[Tuple[int, int]]:
    """(reference: GetMayreg :625-658 + GetCandidateSimilarity :381-400)."""
    votes25: Dict[int, int] = {}
    votes50: Dict[int, int] = {}
    for r in registered:
        for rank, j in enumerate(id2rank.get(r, [])):
            if j in connected:
                continue
            if rank < 25:
                votes25[j] = votes25.get(j, 0) + 1
            if rank < 50:
                votes50[j] = votes50.get(j, 0) + 1
    mayreg = {
        j for j in set(votes25) | set(votes50)
        if votes25.get(j, 0) >= 15 or votes50.get(j, 0) >= 35
    }
    out = []
    for j in mayreg:
        for rank, r in enumerate(id2rank.get(j, [])):
            if rank >= 40:
                break
            if r in registered:
                out.append((min(j, r), max(j, r)))
    return sorted(set(out))


def get_init_id(pairs: List[FramePairData]) -> Tuple[int, int]:
    """Most-connected verified pair with >= 100 inliers
    (reference: GetInitId, run_matching.cc:92-123)."""
    deg: Dict[int, int] = {}
    for p in pairs:
        deg[p.id1] = deg.get(p.id1, 0) + 1
        deg[p.id2] = deg.get(p.id2, 0) + 1
    best, best_score = None, -1
    for p in pairs:
        if p.inlier_num < 100 and best is not None:
            continue
        score = deg.get(p.id1, 0) + deg.get(p.id2, 0) + p.inlier_num * 1e-6
        if score > best_score:
            best, best_score = (p.id1, p.id2), score
    return best if best else (0, 1)


def covisibility_matching(
    features: Sequence[FrameFeatures],
    id2rank: Dict[int, List[int]],
    opts: fmatch.MatchingOptions = fmatch.MatchingOptions(),
    init_pairs_path: str = "",
    num_iterations: int = _NUM_ITERATIONS,
    init_topk: int = 5,
    verbose: bool = True,
    stats=None,
    device="cuda",
) -> List[FramePairData]:
    """Full EC-SfM covisibility matching on `device` (reference:
    run_matching.cc "covisibility" branch and ExpansionAndMatching).

    stats (optional dict) receives pairs_proposed (the seeds and every
    expansion candidate matched and verified), and the host seconds of
    the candidate search (search_s) and of matching and verification
    (match_s, each call ending in a device-to-host copy)."""
    n_proposed = 0
    search_s = match_s = 0.0
    # seed pairs: top-k retrieval (cached like fp_init.bin)
    seed_pairs = fmatch.retrieval_pairs(id2rank, init_topk)
    n_proposed += len(seed_pairs)
    if init_pairs_path and os.path.exists(init_pairs_path):
        verified = read_frame_pairs(init_pairs_path)
    else:
        t0 = time.time()
        verified = fmatch.match_and_verify_pairs(
            features, seed_pairs, opts, verbose=verbose, device=device)
        match_s += time.time() - t0
        if init_pairs_path:
            write_frame_pairs(init_pairs_path, verified)
    matched: Set[Tuple[int, int]] = {
        (min(p.id1, p.id2), max(p.id1, p.id2)) for p in verified
    }
    init_pair = get_init_id(verified)

    t0 = time.time()
    mm = MatchMapLite(features)
    for p in verified:
        mm.add_pair(p)
    search_s += time.time() - t0

    for it in range(num_iterations):
        t0 = time.time()
        connected = mm.connected_frames(init_pair[0])
        cache = mm.sfm_cache()
        reg30 = mm.simulate_sfm(init_pair, 30, cache=cache)
        reg100 = mm.simulate_sfm(init_pair, 100, cache=cache)
        cands = _covisibility_candidates(mm, connected, reg100, id2rank,
                                         frame_tracks=cache[0])
        cands += _mayreg_candidates(mm, connected, reg30, id2rank)
        cands = [c for c in sorted(set(cands)) if c not in matched]
        search_s += time.time() - t0
        if verbose:
            print(f"[expansion] iter {it + 1}: {len(connected)} connected, "
                  f"{len(reg30)}/{len(reg100)} registrable(30/100), "
                  f"{len(cands)} new candidates "
                  f"({time.time() - t0:.1f}s search)", flush=True)
        if not cands:
            break
        n_proposed += len(cands)
        t0 = time.time()
        new_pairs = fmatch.match_and_verify_pairs(
            features, cands, opts, verbose=verbose, device=device)
        match_s += time.time() - t0
        t0 = time.time()
        matched.update(cands)
        for p in new_pairs:
            mm.add_pair(p)
        verified.extend(new_pairs)
        search_s += time.time() - t0
        if verbose:
            print(f"[expansion] iter {it + 1}: {len(new_pairs)}/{len(cands)} "
                  f"verified (precision "
                  f"{len(new_pairs) / max(len(cands), 1):.2f})", flush=True)
    if stats is not None:
        stats["pairs_proposed"] = n_proposed
        stats["search_s"] = search_s
        stats["match_s"] = match_s
    return verified
