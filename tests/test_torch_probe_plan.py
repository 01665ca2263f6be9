"""The two-level search of the ``scan_probe`` kernel
(``csrc/rdf_kernels.cu``) emulated in numpy on the CPU, against
``np.searchsorted`` left and right.

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
grid's walk over quads of rows covers every row once."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels.join_probe import (PROBE_ROWS,  # noqa: E402
                                            PROBE_SPAN, PROBE_THREADS,
                                            SAMPLE_MAX, probe_plan)

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

    sample = keys[np.arange(plan.n_samples) * stride]
    j = _lockstep_lower(lambda i: sample[i], plan.n_samples, v)
    b = np.where(j > 0, (j - 1) * stride + 1, 0)
    n = stride - 1
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


def _check(keys, probes):
    keys = np.asarray(keys, np.int32)
    plan = probe_plan(len(probes), len(keys), aligned=True)
    assert plan.n_samples <= SAMPLE_MAX
    assert plan.n_samples == -(-len(keys) // plan.stride)
    # the smallest stride that fits: one less would need too many samples
    assert plan.stride == 1 or -(-len(keys) // (plan.stride - 1)) > \
        SAMPLE_MAX
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
    plan = _check(keys, _probes(keys, rng))
    assert (plan.stride == 1) == (K <= SAMPLE_MAX)


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
    stride = probe_plan(1, K, True).stride
    assert stride > 2
    m = np.arange(K)
    keys = 2 * ((m + 1) // stride)
    b = np.arange(1, K // stride) * stride
    assert (keys[b - 1] == keys[b]).all() and (keys[b] == keys[b + 1]).all()
    _check(keys, _probes(keys, rng))
    long_runs = 2 * ((m + 1) // (3 * stride))
    _check(long_runs, _probes(long_runs, rng))


def test_two_level_search_at_the_serving_k():
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 2_000_000, SERVING_K))
    plan = _check(keys, _probes(keys, rng, 20_000))
    assert plan.stride == 42 and plan.n_samples == 32_093


@pytest.mark.parametrize("T", [1, 3, 4, 5, 1023, 100_003, 9_963_797])
def test_grid_covers_every_row_once(T):
    """Threads of the persistent grid walk quads of PROBE_ROWS rows by
    the grid's stride; a last partial quad takes its live rows only."""
    plan = probe_plan(T, 100, aligned=True)
    threads = plan.blocks * PROBE_THREADS
    quads = -(-T // PROBE_ROWS)
    assert 1 <= plan.blocks <= 132
    cover = np.zeros(T, np.int64)
    for q0 in range(0, quads, threads):
        q = np.arange(q0, min(q0 + threads, quads))
        rows = (q[:, None] * PROBE_ROWS + np.arange(PROBE_ROWS)).ravel()
        np.add.at(cover, rows[rows < T], 1)
    assert (cover == 1).all()


def test_plan_alignment_and_refusals():
    assert probe_plan(8, 10, aligned=False).vec is False
    assert probe_plan(8, 10, aligned=True).vec is True
    assert probe_plan(8, 0, True)[:2] == (1, 0)
    with pytest.raises(ValueError):
        probe_plan(-1, 3, True)
