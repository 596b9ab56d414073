"""The port's descriptor matcher (xrsfm_tpu_torch.ops.matching) against
the JAX package's, on the same seeded numpy inputs, on the CPU.

The JAX fused kernel runs as the JAX tests run it here: Pallas in
interpret mode.  The port's CPU path is its plain PyTorch version.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from xrsfm_tpu.ops import matching as JM
from xrsfm_tpu_torch.ops import matching as TM
from xrsfm_tpu_torch.utils.synth import descriptor_case, descriptor_tie_case

from test_matching import quantize_desc, random_descriptors

torch.set_num_threads(2)

# (pairs, N, M): the JAX tests' 256 size, and a ragged size that is not a
# multiple of the kernel's 128-row tiles
SHAPES = [(3, 256, 256), (3, 200, 184)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_topstats(d1, d2, m1, m2):
    """JAX kernel (interpret mode) on inputs zero-padded to multiples of
    128 with the padding masked, sliced back.  Padded rows and columns
    can only tie with masked real ones, never beat them, and ties go to
    the lower (real) index, so the slice is the unpadded answer."""
    B, N, _ = d1.shape
    M = d2.shape[1]
    Np, Mp = -(-N // 128) * 128, -(-M // 128) * 128

    def pad(a, n):
        w = [(0, 0)] * a.ndim
        w[1] = (0, n - a.shape[1])
        return np.pad(a, w)

    out = JM._topstats_pallas(
        jnp.asarray(pad(d1, Np)), jnp.asarray(pad(d2, Mp)),
        jnp.asarray(pad(m1, Np)), jnp.asarray(pad(m2, Mp)), interpret=True,
    )
    best, sec, bestj, carg = (np.asarray(o) for o in out)
    return best[:, :N], sec[:, :N], bestj[:, :N], carg[:, :M]


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_topstats_reference_bit_equal_to_pallas(B, N, M):
    """All four outputs bit-equal (tolerance 0), sentinels included."""
    d1, d2, m1, m2 = descriptor_case(21 + N, B, N, M)
    exp = _jax_topstats(d1, d2, m1, m2)
    got = [g.numpy() for g in TM.topstats(*_t(d1, d2, m1, m2))]
    for g, e, name in zip(got, exp, ("best", "second", "best_j", "col_arg")):
        assert g.dtype == e.dtype, name
        assert np.array_equal(g.view(np.uint32), e.view(np.uint32)), name
    best, sec = got[0], got[1]
    assert (best == sec).any(), "the case must hold exact row ties"
    assert (best < -5e8).any(), "the case must hold sentinel values"


def test_topstats_dispatch_counts_plain_launches_on_cpu():
    args = _t(*descriptor_case(3, 2, 128, 128))
    before = dict(TM.LAUNCHES)
    TM.topstats(*args)
    assert TM.LAUNCHES["topstats_plain"] == before["topstats_plain"] + 1
    assert TM.LAUNCHES["topstats_cuda"] == before["topstats_cuda"]


def _sift_case(seed, B, N, M):
    """SIFT-like uint8 descriptors (L1-root normalized, 512*v): half of d2
    are exact or noisy copies of d1 rows, a few d2 rows are duplicated
    (ambiguous for the ratio test), masks have random holes and a ragged
    tail."""
    rng = np.random.default_rng(seed)
    f1 = random_descriptors(rng, B * N).reshape(B, N, 128)
    f2 = random_descriptors(rng, B * M).reshape(B, M, 128)
    for b in range(B):
        k = min(N, M) // 2
        src = rng.choice(N, k, replace=False)
        dst = rng.choice(M, k, replace=False)
        noisy = np.abs(f1[b, src] + rng.normal(scale=0.02, size=(k, 128)))
        noisy /= np.linalg.norm(noisy, axis=-1, keepdims=True)
        f2[b, dst] = np.where(np.arange(k)[:, None] % 2 == 0, f1[b, src],
                              noisy)
    d1, d2 = quantize_desc(f1), quantize_desc(f2)
    for b in range(B):
        d2[b, rng.choice(M, 6)] = d2[b, rng.choice(M, 6)]
    m1 = rng.random((B, N)) > 0.05
    m2 = rng.random((B, M)) > 0.05
    m1[:, N - N // 16:] = False
    m2[:, M - M // 16:] = False
    return d1, d2, m1, m2


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_match_descriptors_batch_equal_to_jax(B, N, M):
    """Same routing as the JAX package (fused at 256, the bf16 path at
    200x184): matches and counts equal; distances within 1e-7 (arccos
    of the same f32 cosines in two libraries; observed 3.0e-8)."""
    d1, d2, m1, m2 = _sift_case(5 + N, B, N, M)
    assert TM._pallas_ok(N, M, 128) == JM._pallas_ok(N, M, 128)
    mj, cj, dj = JM.match_descriptors_batch(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        0.7, 0.8, 128,
    )
    mt, ct, dt = TM.match_descriptors_batch(*_t(d1, d2, m1, m2), 0.7, 0.8,
                                            128)
    assert np.array_equal(np.asarray(cj), ct.numpy())
    assert np.asarray(cj).min() > 20, "the case must produce matches"
    assert np.array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,m", [(150, 130), (50, 60)])
def test_match_pair_host_equal_to_jax(n, m):
    """150x130 pads to 256 (fused path), 50x60 to 64 (bf16 path):
    matches equal, distances within 1e-7."""
    d1, d2, _, _ = _sift_case(9 + n, 1, n, m)
    mj, dj = JM.match_pair_host(d1[0], d2[0])
    mt, dt = TM.match_pair_host(d1[0], d2[0], device="cpu")
    assert len(mj) > 10
    assert np.array_equal(mj, mt)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-7)


# --- the CUDA kernel's reduction order, replayed in plain PyTorch ---------

_NEG_INF = float("-inf")


def _merge(a, b):
    """csrc/topstats.cu `merge` on (best, arg, second) triples of row
    vectors: the larger best wins, ties go to the lower index, and the
    loser's best joins the seconds."""
    b_wins = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    best = torch.where(b_wins, b[0], a[0])
    arg = torch.where(b_wins, b[1], a[1])
    lose = torch.where(b_wins, a[0], b[0])
    second = torch.maximum(torch.maximum(a[2], b[2]), lose)
    return best, arg, second


def _replay_pass(own, strm, own_mask, str_mask, col):
    """One pass of the kernel for one pair, in its order: the streamed
    side in tiles of 128; within a group of 8 streamed indices lane q of a
    quad holds 2q and 2q+1; each lane keeps a running (best, arg, second)
    over its indices in ascending order with a strict `>`, noting per tile
    the local position of the last improvement; the four lanes merge as
    by two xor-shuffles (1, then 2).  Returns (best, arg, second) over the
    own indices."""
    n_own, n_str = own.shape[0], strm.shape[0]
    sim = own.float() @ strm.float().T  # exact: integers below 2^24
    pen_s = torch.where(str_mask, 0.0, -TM._BIG).float()
    if col:
        sim = sim + torch.where(own_mask, 0.0, -TM._BIG).float()[:, None]
    val = sim + pen_s[None, :]
    tiles = -(-n_str // 128)
    # past the end of the pair the kernel adds -inf to a zero-filled dot
    val = torch.cat([val, torch.full((n_own, tiles * 128 - n_str), _NEG_INF)],
                    dim=1)
    lanes = []
    for q in range(4):
        best = torch.full((n_own,), _NEG_INF)
        second = torch.full((n_own,), -TM._BIG, dtype=torch.float32)
        arg = torch.full((n_own,), 0x7FFFFFFF, dtype=torch.int32)
        for t in range(tiles):
            loc = torch.full((n_own,), -1, dtype=torch.int32)
            for j in range(16):
                for e in range(2):
                    v = val[:, t * 128 + 8 * j + 2 * q + e]
                    up = v > best
                    if not col:
                        second = torch.maximum(second,
                                               torch.minimum(v, best))
                    best = torch.maximum(best, v)
                    loc = torch.where(up, 8 * j + e, loc).to(torch.int32)
            arg = torch.where(loc >= 0, t * 128 + 2 * q + loc,
                              arg).to(torch.int32)
        lanes.append((best, arg, second))
    # shuffle-xor 1 pairs lanes (0,1) and (2,3); xor 2 pairs the results
    return _merge(_merge(lanes[0], lanes[1]), _merge(lanes[2], lanes[3]))


def _replay_topstats(d1, d2, m1, m2):
    out = [[], [], [], []]
    for b in range(d1.shape[0]):
        best, arg, second = _replay_pass(d1[b], d2[b], m1[b], m2[b], False)
        _, carg, _ = _replay_pass(d2[b], d1[b], m2[b], m1[b], True)
        for o, x in zip(out, (best, second, arg, carg)):
            o.append(x)
    return [torch.stack(o) for o in out]


@pytest.mark.parametrize("case", ["256x256", "200x184", "ties"])
def test_kernel_reduction_order_bit_equal_to_reference(case):
    """The kernel's order of reduction (fragment lanes, 128-wide tiles,
    per-lane running statistics, quad merge), written out above in plain
    PyTorch, gives the plain version's four outputs bit for bit (tolerance
    0), ties and sentinels included.  This checks the algorithm, not the
    CUDA source: the kernel itself meets the same planted ties on the card
    in tests/test_torch_kernels_cuda.py."""
    arrays = {"256x256": lambda: descriptor_case(31, 2, 256, 256),
              "200x184": lambda: descriptor_case(32, 3, 200, 184),
              "ties": descriptor_tie_case}[case]()
    args = _t(*arrays)
    exp = TM.topstats_reference(*args)
    got = _replay_topstats(*args)
    for g, e, name in zip(got, exp, ("best", "second", "best_j", "col_arg")):
        assert g.dtype == e.dtype and g.shape == e.shape, name
        assert torch.equal(g.view(torch.int32), e.view(torch.int32)), name
    if case == "ties":
        assert (exp[0] == exp[1]).sum() >= 6, "tied best columns expected"
        assert (exp[0][2] < -5e8).all(), "pair 2 has every column masked"
