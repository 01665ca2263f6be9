"""The two-level search that the ``scan_probe`` and ``probe_sorted_many``
kernels share (``csrc/rdf_kernels.cu``: ``search4``) emulated in numpy on
the CPU, against ``np.searchsorted`` left and right.

The kernel cannot run here, so its index arithmetic is emulated as it
runs, from the plan the launcher takes (``join_probe.probe_plan``):
probes outside the keys' range skip the search; every ``stride``-th key
sits in the shared-memory sample, searched in a fixed number of steps
(four rows in lockstep); binary steps narrow the window of ``stride - 1``
keys that follows (read as INT32_MAX past K) to PROBE_SPAN keys; four
16-byte loads read the 16 keys around those, whose keys below the probe
(and up to it) are prefixes, giving lo and, where the probe's run ends
among them, hi; else the gallop and the binary search that ends it. Keys
off 16 bytes take the scalar path. Cases: K of 0, 1 and around the
sample size, all keys equal, runs of equal keys across every sample
boundary, -1 and the int32 extremes as probes, and the serving K; and the
grid's walk over quads of rows covers every row once. The
``probe_sorted_many`` route: n probes off a multiple of 4 (a scalar last
quad), -1 padding, probes off 16 bytes, the sample shrunk for small n,
and the serving K = P."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels.join_probe import (PROBE_MIN_QUADS,  # noqa: E402
                                            PROBE_ROWS, PROBE_SPAN,
                                            PROBE_THREADS,
                                            SAMPLE_MAX, SAMPLE_MIN,
                                            SAMPLE_PER_PROBE, probe_plan,
                                            sample_cap)

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
SERVING_K = 1_347_882        # sorted follows subjects at WatDiv scale 1000


def _lockstep_lower(at, n, v):
    """#(a[0:n) < v) for every v in ceil(log2 n) steps, whatever v
    (Khuong and Morin's branch-free form); ``at(i)`` reads a[i]."""
    b = np.zeros(v.shape, np.int64)
    while n > 1:
        half = n >> 1
        b = np.where(at(b + half) < v, b + half, b)
        n -= half
    return b + (at(b) < v)


def emulate(keys, v, plan, keys16=True):
    """(lo, hi) of probes v against keys as the kernel computes them;
    ``keys16``: the keys' pointer is on 16 bytes (the span's 16-byte
    loads)."""
    keys = np.asarray(keys, np.int64)
    v = np.asarray(v, np.int64)
    K = keys.shape[0]
    stride = plan.stride
    # probes outside [keys[0], keys[K-1]] take (0, 0) below, (K, K) above
    inside = np.zeros(v.shape, bool)
    above = np.zeros(v.shape, bool)
    if K:
        inside = (v >= keys[0]) & (v <= keys[-1])
        above = v > keys[-1]
    lo = np.where(above, K, 0)
    hi = lo.copy()
    if not inside.any():
        return lo, hi

    def padded(i):
        return np.where(i < K, keys[np.minimum(i, K - 1)], INT32_MAX)

    if stride:
        sample = keys[np.arange(plan.n_samples) * stride]
        j = _lockstep_lower(lambda i: sample[i], plan.n_samples, v)
        b = np.where(j > 0, (j - 1) * stride + 1, 0)
        n = stride - 1
    else:                       # no sample: the window is every key
        j, b, n = np.ones(v.shape, np.int64), np.zeros(v.shape, np.int64), K
    while n > PROBE_SPAN:
        half = n >> 1
        b = np.where(padded(b + half) < v, b + half, b)
        n -= half
    # the n <= PROBE_SPAN keys left lie in the 16 from b rounded down to a
    # multiple of 4; where those 16 are keys (the four 16-byte loads), the
    # keys < v and <= v among them are prefixes
    a = b & ~3
    assert (b - a + n <= 16).all()
    wide = keys16 & (a + 16 <= K)
    span = padded(a[:, None] + np.arange(16))
    lt = (span < v[:, None]).sum(axis=1)
    le = (span <= v[:, None]).sum(axis=1)
    at = b[:, None] + np.arange(PROBE_SPAN)
    scalar = ((np.arange(PROBE_SPAN) < n) & (padded(at) < v[:, None])
              ).sum(axis=1)
    below = np.where(wide, np.clip(lt - (b - a), 0, n), scalar)
    lo = np.where(inside, np.where(j > 0, b + below, 0), lo)
    done = inside & wide & (le < 16)
    hi = np.where(done, a + le, hi)
    # the gallop (every key before `from` is <= v), then a binary search
    gal = inside & ~done
    start = np.where(wide, a + 16, lo)
    prev, probe = start.copy(), start.copy()
    jump = np.ones(v.shape, np.int64)
    up = gal & (probe < K)
    while up.any():
        idx = np.nonzero(up)[0]
        ok = keys[probe[idx]] <= v[idx]
        go, stop = idx[ok], idx[~ok]
        prev[go] = probe[go] + 1
        probe[go] = np.where(jump[go] < K - prev[go], prev[go] + jump[go], K)
        jump[go] <<= 1
        up[stop] = False
        up[go] = probe[go] < K
    hi = np.where(gal, prev, hi)
    length = np.where(gal, probe - prev, 0)
    while (length > 0).any():
        idx = np.nonzero(length > 0)[0]
        half = length[idx] >> 1
        right = keys[hi[idx] + half] <= v[idx]
        hi[idx] = np.where(right, hi[idx] + half + 1, hi[idx])
        length[idx] = np.where(right, length[idx] - half - 1, half)
    return lo, hi


def _walk(n, plan):
    """The kernels' walk over n rows or probes (``first_quad``): thread
    (block b, warp w, lane l) starts at quad (w * blocks + b) * 32 + l and
    steps by the grid's threads. Returns how often each row is taken, the
    number of partial quads (scalar loads and stores) and the number of
    blocks with work."""
    quads = -(-n // PROBE_ROWS)
    b, t = np.meshgrid(np.arange(plan.blocks), np.arange(PROBE_THREADS),
                       indexing="ij")
    first = ((t // 32) * plan.blocks + b) * 32 + t % 32
    cover = np.zeros(n, np.int64)
    partial = 0
    busy = int((first.min(axis=1) < quads).sum())
    step = plan.blocks * PROBE_THREADS
    for q0 in range(0, quads, step):
        q = (first + q0).ravel()
        q = q[q < quads]
        rows = (q[:, None] * PROBE_ROWS + np.arange(PROBE_ROWS)).ravel()
        np.add.at(cover, rows[rows < n], 1)
        partial += int(((q + 1) * PROBE_ROWS > n).sum())
    return cover, partial, busy


def _probes(keys, rng, n=2000):
    """Every key value near its run ends, neighbours of key values,
    random values, and -1 / INT32_MIN / INT32_MAX."""
    keys = np.asarray(keys, np.int64)
    extremes = np.asarray([-1, INT32_MIN, INT32_MAX, 0, 1], np.int64)
    if keys.size == 0:
        return np.concatenate([extremes, rng.integers(-5, 5, n)])
    pick = rng.choice(keys, n)
    return np.concatenate([extremes, pick, pick - 1, pick + 1,
                           rng.integers(keys.min() - 3, keys.max() + 4, n)])


def _check(keys, probes, n=None):
    """The plan for ``n`` probes (by default len(probes)) and its search
    of ``probes``, with the keys on and off 16 bytes."""
    keys = np.asarray(keys, np.int32)
    n = len(probes) if n is None else n
    plan = probe_plan(n, len(keys), aligned=True)
    cap = sample_cap(n, plan.blocks)
    assert plan.n_samples <= cap <= SAMPLE_MAX
    assert plan.n_samples == -(-len(keys) // max(1, plan.stride))
    # the smallest stride that fits: one less would need too many samples
    assert plan.stride <= 1 or -(-len(keys) // (plan.stride - 1)) > cap
    for keys16 in (True, False):
        lo, hi = emulate(keys, probes, plan, keys16)
        np.testing.assert_array_equal(lo, np.searchsorted(keys, probes,
                                                          "left"))
        np.testing.assert_array_equal(hi, np.searchsorted(keys, probes,
                                                          "right"))
    return plan


@pytest.mark.parametrize("K", [0, 1, SAMPLE_MAX - 1, SAMPLE_MAX,
                               SAMPLE_MAX + 1, 10 * SAMPLE_MAX + 3,
                               20 * SAMPLE_MAX + 11])
def test_two_level_search_equals_searchsorted(K):
    rng = np.random.default_rng(K)
    keys = np.sort(rng.integers(0, 3 * K + 10, K))
    plan = _check(keys, _probes(keys, rng), n=10 ** 7)
    assert (plan.stride == 1) == (K <= SAMPLE_MAX)
    _check(keys, _probes(keys, rng))


@pytest.mark.parametrize("K", [1, SAMPLE_MAX, 3 * SAMPLE_MAX + 7])
def test_two_level_search_all_keys_equal(K):
    rng = np.random.default_rng(1)
    keys = np.full(K, 7)
    _check(keys, np.concatenate([[6, 7, 8], _probes(keys, rng, 50)]))


@pytest.mark.parametrize("K", [10 * SAMPLE_MAX + 3, 4 * SAMPLE_MAX + 1])
def test_two_level_search_runs_across_every_sample_boundary(K):
    """keys[m] = 2 * ((m + 1) // stride): a run of ``stride`` equal keys
    covers keys[i * stride - 1 : i * stride + stride - 1], across every
    sample boundary; a second array adds runs of three strides."""
    rng = np.random.default_rng(2)
    stride = probe_plan(10 ** 7, K, True).stride
    assert stride > 2
    m = np.arange(K)
    keys = 2 * ((m + 1) // stride)
    b = np.arange(1, K // stride) * stride
    assert (keys[b - 1] == keys[b]).all() and (keys[b] == keys[b + 1]).all()
    _check(keys, _probes(keys, rng), n=10 ** 7)
    long_runs = 2 * ((m + 1) // (3 * stride))
    _check(long_runs, _probes(long_runs, rng), n=10 ** 7)


def test_two_level_search_at_the_serving_k():
    """scan_probe's rows (T = 9,963,797) and probe_sorted_many's probes
    (P = K) at the serving K both take the full sample."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 2_000_000, SERVING_K))
    for n in (9_963_797, SERVING_K):
        plan = _check(keys, _probes(keys, rng, 20_000), n=n)
        assert plan.stride == 42 and plan.n_samples == 32_093
        assert plan.blocks == 132


@pytest.mark.parametrize("T", [1, 3, 4, 5, 1023, 100_003, 9_963_797])
def test_grid_covers_every_row_once(T):
    """Threads of the persistent grid walk quads of PROBE_ROWS rows in
    runs of 32 a warp, interleaved over the blocks; a last partial quad
    takes its live rows only."""
    plan = probe_plan(T, 100, aligned=True)
    assert 1 <= plan.blocks <= 132
    cover, _, busy = _walk(T, plan)
    assert (cover == 1).all()
    assert busy == min(plan.blocks, -(-T // PROBE_ROWS))


def test_plan_alignment_and_refusals():
    assert probe_plan(8, 10, aligned=False).vec is False
    assert probe_plan(8, 10, aligned=True).vec is True
    assert probe_plan(8, 0, True)[:2] == (1, 0)
    with pytest.raises(ValueError):
        probe_plan(-1, 3, True)




@pytest.mark.parametrize("n", [1, 3, 5, 4_001, 100_003])
@pytest.mark.parametrize("aligned", [True, False])
def test_probe_sorted_many_route(n, aligned):
    """n probes of a [Q, P] array, -1 padding among them: every probe
    taken once, a last partial quad when n is not a multiple of 4, and
    the bounds of np.searchsorted; probes off 16 bytes read scalar."""
    rng = np.random.default_rng(n)
    K = 3 * SAMPLE_MAX + 5
    keys = np.sort(rng.integers(0, 4 * K, K)).astype(np.int32)
    probes = rng.integers(-3, 4 * K + 3, n)
    probes[rng.random(n) < 0.2] = -1
    plan = probe_plan(n, K, aligned)
    assert plan.vec is aligned
    cover, partial, busy = _walk(n, plan)
    assert (cover == 1).all() and partial == (n % PROBE_ROWS != 0)
    # every block of a small call's grid has quads to search
    assert busy == plan.blocks
    for keys16 in (True, False):
        lo, hi = emulate(keys, probes, plan, keys16)
        np.testing.assert_array_equal(lo, np.searchsorted(keys, probes,
                                                          "left"))
        np.testing.assert_array_equal(hi, np.searchsorted(keys, probes,
                                                          "right"))
        assert (lo[probes == -1] == 0).all() and (hi[probes == -1] == 0).all()


@pytest.mark.parametrize("n", [1, 4, 12, 31, 32, 100, 1_000, 4_000, 30_000,
                               200_000])
def test_small_n_plans_shrink_the_sample(n):
    """A block copies the whole sample: for few probes the plan keeps it
    to SAMPLE_PER_PROBE keys for each probe the block searches (never
    under SAMPLE_MIN), so a few thousand probes copy a few KB a block; a
    call of under 32 probes (most of a cold batch's joins) takes none."""
    K = SERVING_K
    plan = probe_plan(n, K, True)
    per_block = -(-n // plan.blocks)
    assert plan.n_samples <= max(SAMPLE_MIN, SAMPLE_PER_PROBE * per_block)
    assert plan.blocks * plan.n_samples <= max(
        plan.blocks * SAMPLE_MIN, SAMPLE_PER_PROBE * (n + plan.blocks))
    # a block takes at least PROBE_MIN_QUADS quads: small calls spread
    assert plan.blocks == min(132, max(1, -(-n // (4 * PROBE_MIN_QUADS))))
    if SAMPLE_PER_PROBE * n < SAMPLE_MIN:   # no sample, no gather
        assert plan.blocks == 1 and plan[:2] == (0, 0)
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, 2 * K, K)).astype(np.int32)
    probes = np.concatenate([[-1], rng.integers(0, 2 * K, n - 1)])
    lo, hi = emulate(keys, probes, plan)
    np.testing.assert_array_equal(lo, np.searchsorted(keys, probes, "left"))
    np.testing.assert_array_equal(hi, np.searchsorted(keys, probes, "right"))
