"""The port's EC-SfM covisibility expansion (xrsfm_tpu_torch.feature.
expansion) against the JAX package's (xrsfm_tpu/feature/expansion.py) on
the same pair lists, and covisibility matching on a small unordered
workspace against the JAX package's and against ground truth, on the
CPU."""

import collections
import os

import numpy as np
import pytest
import torch

from xrsfm_tpu.feature import expansion as JE
from xrsfm_tpu.feature import matching as JM
from xrsfm_tpu.utils import io_features as JIO
from xrsfm_tpu_torch.feature import expansion as TE
from xrsfm_tpu_torch.feature import matching as TM
from xrsfm_tpu_torch.feature import retrieval as TR
from xrsfm_tpu_torch.utils import io_features as TIO
from xrsfm_tpu_torch.utils import synth

torch.set_num_threads(2)

GT_COVIS_POINTS = 30  # ground-truth covisible: >= 30 shared scene points


def _both(kps, raw):
    """Frames with keypoints kps and inlier pairs raw ((i, j, matches,
    inlier_num) each) in both packages' types: [(port features, port
    pairs), (JAX features, JAX pairs)]."""
    out = []
    for io in (TIO, JIO):
        feats = [io.FrameFeatures(f"f{i}", k,
                                  np.zeros((len(k), 128), np.uint8))
                 for i, k in enumerate(kps)]
        pairs = [io.FramePairData(i, j, m, np.zeros(len(m)), np.eye(3), n_inl,
                                  np.ones(len(m), bool))
                 for i, j, m, n_inl in raw]
        out.append((feats, pairs))
    return out


def _random_graph(seed, nf=12, nk=40, n_pairs=30):
    """Random keypoints and random inlier matches between random frames."""
    rng = np.random.default_rng(seed)
    kps = [np.column_stack([rng.uniform(0, 640, nk), rng.uniform(0, 480, nk),
                            np.ones(nk), np.zeros(nk)]).astype(np.float32)
           for _ in range(nf)]
    raw = []
    for _ in range(n_pairs):
        i, j = sorted(rng.choice(nf, 2, replace=False))
        n = int(rng.integers(3, 15))
        m = np.column_stack([rng.choice(nk, n, replace=False),
                             rng.choice(nk, n, replace=False)]).astype(np.int32)
        raw.append((int(i), int(j), m, int(rng.integers(20, 300))))
    return _both(kps, raw)


def _track_graph(seed, nf=60, n_conn=50, n_pts=400, reach=5):
    """A scene of n_pts points, each at one image position in every frame
    that sees it; frame f < n_conn sees the points whose home lies within
    `reach` of f (80% of them), and is matched to frames f + 1 and f + 2 on
    the points they share, so that frames further apart share tracks
    without a pair; frames from n_conn on see 30 random points and have no
    pair."""
    rng = np.random.default_rng(seed)
    uv = np.column_stack([rng.uniform(0, 640, n_pts),
                          rng.uniform(0, 480, n_pts)])
    home = rng.uniform(0, n_conn, n_pts)
    seen = [np.nonzero((np.abs(home - f) < reach)
                       & (rng.uniform(size=n_pts) < 0.8))[0] if f < n_conn
            else rng.choice(n_pts, 30, replace=False) for f in range(nf)]
    kps = [np.column_stack([uv[s], np.ones(len(s)), np.zeros(len(s))])
           .astype(np.float32) for s in seen]
    raw = []
    for i in range(n_conn):
        for j in (i + 1, i + 2):
            if j < n_conn:
                _, a, b = np.intersect1d(seen[i], seen[j], return_indices=True)
                raw.append((i, j, np.column_stack([a, b]).astype(np.int32),
                            len(a)))
    return _both(kps, raw)


def _partition(nodes, lab):
    part = collections.defaultdict(set)
    for n, lb in zip(nodes, lab):
        part[int(lb)].add(int(n))
    return sorted(map(sorted, part.values()))


@pytest.mark.parametrize("seed", [0, 7])
def test_components_match_jax_and_batch(seed):
    """Pairs added across several _components() calls give the partition
    of one batch build (the incremental label-graph merge) and the JAX
    package's, node for node; connected_frames and frame_tracks agree."""
    (tf, tp), (jf, jp) = _random_graph(seed)
    mm_t, mm_j, mm_b = TE.MatchMapLite(tf), JE.MatchMapLite(jf), \
        TE.MatchMapLite(tf)
    for i, (a, b) in enumerate(zip(tp, jp)):
        mm_t.add_pair(a)
        mm_j.add_pair(b)
        mm_b.add_pair(a)
        if i % 7 == 0:
            mm_t._components()
            mm_j._components()
    nt, lt = mm_t._components()
    nj, lj = mm_j._components()
    nb, lb = mm_b._components()
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(nt, nb)
    assert _partition(nt, lt) == _partition(nj, lj) == _partition(nb, lb)
    for f in range(mm_t.nf):
        assert mm_t.connected_frames(f) == mm_j.connected_frames(f)
        assert sorted(mm_t.frame_tracks(f).values()) == \
            sorted(mm_j.frame_tracks(f).values())
    for i in range(mm_t.nf):
        np.testing.assert_array_equal(mm_t.patch[i], mm_j.patch[i])


def _brute_greedy(mm, init_pair, threshold):
    """The reference's SimulationSfM as a full rescan a round: register
    the unregistered frame with the most triangulated tracks (ties to the
    lowest id) until none reaches the threshold (match_expansion.cc
    :534-601)."""
    ft = {f: mm.frame_tracks(f) for f in range(mm.nf)}
    tri, registered = set(), set(init_pair)
    for f in init_pair:
        tri.update(ft[f].keys())
    while True:
        best, best_cnt = -1, threshold - 1
        for f in range(mm.nf):
            if f not in registered:
                cnt = sum(1 for r in ft[f] if r in tri)
                if cnt > best_cnt:
                    best, best_cnt = f, cnt
        if best < 0:
            return registered
        registered.add(best)
        tri.update(ft[best].keys())


@pytest.mark.parametrize("seed", range(4))
def test_simulate_sfm_and_init_id_match_jax(seed):
    """simulate_sfm (lazy heap) registers the set the JAX package's and
    the brute-force greedy register, at thresholds 2, 5 and 10, with and
    without the shared cache; get_init_id picks the JAX package's pair."""
    (tf, tp), (jf, jp) = _random_graph(100 + seed)
    mm_t, mm_j = TE.MatchMapLite(tf), JE.MatchMapLite(jf)
    for a, b in zip(tp, jp):
        mm_t.add_pair(a)
        mm_j.add_pair(b)
    init = TE.get_init_id(tp)
    assert init == JE.get_init_id(jp)
    cache = mm_t.sfm_cache()
    for th in (2, 5, 10):
        got = mm_t.simulate_sfm(init, th)
        assert got == mm_t.simulate_sfm(init, th, cache=cache)
        assert got == mm_j.simulate_sfm(init, th)
        assert got == _brute_greedy(mm_t, init, th), (th, sorted(got))


def test_candidates_match_jax():
    """The covisibility candidates (unmatched pairs that share >= 2 tracks
    in one grid cell on both sides) and the retrieval-vote candidates of
    the frames not yet connected (ranked first by every frame) equal the
    JAX package's, with part of the connected frames registered."""
    (tf, tp), (jf, jp) = _track_graph(3)
    mm_t, mm_j = TE.MatchMapLite(tf), JE.MatchMapLite(jf)
    for a, b in zip(tp, jp):
        mm_t.add_pair(a)
        mm_j.add_pair(b)
    id2rank = {i: list(range(50, 60)) + sorted(
        (j for j in range(50) if j != i), key=lambda j: (abs(i - j), j))
        for i in range(60)}
    init = TE.get_init_id(tp)
    assert init == JE.get_init_id(jp)
    connected = mm_t.connected_frames(init[0])
    assert connected == mm_j.connected_frames(init[0]) == set(range(50))
    registered = mm_t.simulate_sfm(init, 30) - set(range(20, 35))
    ct = TE._covisibility_candidates(mm_t, connected, registered, id2rank)
    cj = JE._covisibility_candidates(mm_j, connected, registered, id2rank)
    assert ct == cj and len(ct) > 0
    mt = TE._mayreg_candidates(mm_t, connected, registered, id2rank)
    mj = JE._mayreg_candidates(mm_j, connected, registered, id2rank)
    assert mt == mj and len(mt) > 0


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The unordered landmark ring at 24 genuine + 8 distractor frames
    (seed 1): its features in both packages' types, the port's VLAD ranks,
    the scene point id of every keypoint, and the ground-truth
    covisibility counts (shared scene points; distractor clutter is
    private to its frame)."""
    ws = str(tmp_path_factory.mktemp("unordered") / "ws")
    names, obs, n_scene = synth.write_unordered_workspace(
        ws, "unordered", 24, 1, 8)
    vis = np.zeros((len(names), n_scene), np.float32)
    for f, ids in enumerate(obs):
        vis[f, ids[ids < n_scene]] = 1.0
    covis = vis @ vis.T
    np.fill_diagonal(covis, 0)
    tf = TIO.read_features(os.path.join(ws, "ftr.bin"))
    jf = JIO.read_features(os.path.join(ws, "ftr.bin"))
    ranks, _ = TR.build_retrieval([f.descriptors for f in tf], device="cpu")
    return tf, jf, TR.ranks_to_id2rank(ranks), obs, covis


def _precision(pairs, covis):
    """Share of pairs that are covisible in ground truth (>= 30 points)."""
    good = sum(1 for p in pairs if covis[p.id1, p.id2] >= GT_COVIS_POINTS)
    return good / max(len(pairs), 1)


def test_covisibility_matching_matches_jax_on_unordered_scene(workspace,
                                                              tmp_path):
    """covisibility_matching from the same VLAD ranks on the CPU: the
    port's verified pairs overlap the JAX package's by >= 95% (their
    RANSAC streams differ); every inlier match of every pair joins two
    keypoints of one scene point; precision against ground-truth
    covisibility (>= 30 shared points) within 0.02 of the JAX package's
    and recall >= 0.95.  At this size more of the verified pairs share
    only 15 to 29 points (correct matches, but under the threshold), so
    precision itself is held at the 500-frame scale, on the card.  The
    seeds are cached in fp_init.bin in the reference's format, and a
    second run reads them back."""
    tf, jf, id2rank, obs, covis = workspace
    opts = TM.MatchingOptions()
    st = {}
    init_path = str(tmp_path / "fp_init.bin")
    vt = TE.covisibility_matching(tf, id2rank, opts, init_pairs_path=init_path,
                                  verbose=False, stats=st, device="cpu")
    vj = JE.covisibility_matching(jf, id2rank, JM.MatchingOptions(),
                                  verbose=False)
    pt = {(p.id1, p.id2) for p in vt}
    pj = {(p.id1, p.id2) for p in vj}
    assert len(pj) >= 20
    assert len(pt & pj) >= 0.95 * max(len(pt), len(pj)), (len(pt), len(pj))
    for p in vt:
        inl = p.inlier_matches()
        assert len(inl) >= 15
        np.testing.assert_array_equal(obs[p.id1][inl[:, 0]],
                                      obs[p.id2][inl[:, 1]])
    assert _precision(vt, covis) >= _precision(vj, covis) - 0.02
    n_gt = int(np.count_nonzero(np.triu(covis >= GT_COVIS_POINTS, k=1)))
    assert sum(1 for i, j in pt if covis[i, j] >= GT_COVIS_POINTS) \
        >= 0.95 * n_gt
    assert st["pairs_proposed"] >= len(TM.retrieval_pairs(id2rank, 5))
    assert st["search_s"] > 0 and st["match_s"] > 0
    seeds = TIO.read_frame_pairs(init_path)
    assert {(p.id1, p.id2) for p in seeds} <= pt
    again = TE.covisibility_matching(tf, id2rank, opts,
                                     init_pairs_path=init_path,
                                     verbose=False, device="cpu")
    assert len({(p.id1, p.id2) for p in again} & pt) >= 0.95 * len(pt)
