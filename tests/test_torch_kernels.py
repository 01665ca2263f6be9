"""The port's query kernels: plain torch versions against the JAX package's
Pallas kernels (interpret mode), and the wrappers' CPU dispatch and
argument checks. Every comparison is exact: all results are integers.
The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.join_probe import probe_sorted as j_probe_sorted  # noqa: E402
from repro.kernels.join_probe import probe_sorted_many as j_probe_many  # noqa: E402
from repro.kernels.join_probe import scan_probe as j_scan_probe  # noqa: E402
from repro.kernels.triple_scan import triple_scan as j_triple_scan  # noqa: E402
from repro.kernels.triple_scan import \
    triple_scan_many as j_triple_scan_many  # noqa: E402

from repro_torch.kernels import launch_counts, ref  # noqa: E402
from repro_torch.kernels.join_probe import (probe_sorted,  # noqa: E402
                                            probe_sorted_many, scan_probe)
from repro_torch.kernels.triple_scan import (triple_scan,  # noqa: E402
                                             triple_scan_many)

PATTERNS = [(-1, 3, -1), (7, -1, -1), (-1, -1, -1), (1, 2, 3), (-1, 4, 9)]
# (K, P): empty keys, single key, block boundaries of the Pallas kernel
PROBE_CASES = [(0, 7), (1, 1), (100, 33), (512, 512), (513, 511),
               (2048, 129), (5000, 1000)]
# probes the contract names: -1 padding and values outside the key range
EDGE_PROBES = np.asarray([-1, -1, -10, 0, 59, 60, 10 ** 6, 2 ** 31 - 1],
                         np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("T", [100, 2048, 5000])
def test_triple_scan_matches_pallas(T):
    rng = np.random.default_rng(0)
    tri = rng.integers(0, 50, (T, 3)).astype(np.int32)
    for pat in PATTERNS:
        want = j_triple_scan(jnp.asarray(tri), jnp.asarray(pat), bt=512,
                             interpret=True)
        got = triple_scan(_t(tri), pat)
        assert got.dtype == torch.int32
        _eq(got, want)
        _eq(ref.triple_scan_reference(_t(tri), *pat),
            jref.triple_scan_reference(jnp.asarray(tri), *pat))


@pytest.mark.parametrize("T", [33, 1000, 2049])
def test_triple_scan_many_matches_pallas(T):
    rng = np.random.default_rng(T)
    tri = rng.integers(0, 20, (T, 3)).astype(np.int32)
    pats = np.asarray(PATTERNS + [(-1, 2, 5), (3, -1, 4)], np.int32)
    want = j_triple_scan_many(jnp.asarray(tri), jnp.asarray(pats), bt=512,
                              interpret=True)
    got = triple_scan_many(_t(tri), _t(pats))
    assert got.shape == (len(pats), T) and got.dtype == torch.int32
    _eq(got, want)
    assert triple_scan_many(_t(tri), _t(pats[:0])).shape == (0, T)


@pytest.mark.parametrize("K,P", PROBE_CASES)
def test_probe_sorted_matches_pallas(K, P):
    """Duplicate keys, probes outside the key range on both sides, and -1
    padding probes (lo == hi == 0 against non-negative keys)."""
    rng = np.random.default_rng(K * 1009 + P)
    keys = np.sort(rng.integers(0, 60, K)).astype(np.int32)
    probes = np.concatenate([rng.integers(-10, 90, P), EDGE_PROBES]
                            ).astype(np.int32)
    jlo, jhi = j_probe_sorted(jnp.asarray(keys), jnp.asarray(probes),
                              bk=512, bp=128, interpret=True)
    lo, hi = probe_sorted(_t(keys), _t(probes))
    assert lo.dtype == hi.dtype == torch.int32
    _eq(lo, jlo)
    _eq(hi, jhi)
    _eq(lo, np.searchsorted(keys, probes, side="left"))
    _eq(hi, np.searchsorted(keys, probes, side="right"))
    if K:
        pad = np.flatnonzero(probes == -1)
        assert (lo.numpy()[pad] == 0).all() and (hi.numpy()[pad] == 0).all()


def test_probe_sorted_many_matches_pallas():
    rng = np.random.default_rng(7)
    keys = np.sort(rng.integers(0, 500, 777)).astype(np.int32)
    probes = rng.integers(-5, 600, (5, 300)).astype(np.int32)
    jlo, jhi = j_probe_many(jnp.asarray(keys), jnp.asarray(probes), bk=256,
                            bp=128, interpret=True)
    lo, hi = probe_sorted_many(_t(keys), _t(probes))
    assert lo.shape == hi.shape == (5, 300)
    _eq(lo, jlo)
    _eq(hi, jhi)


@pytest.mark.parametrize("T,K,bt", [(100, 50, 512), (2500, 0, 512),
                                    (2048, 2048, 1024), (33, 5, 2048)])
def test_scan_probe_matches_pallas(T, K, bt):
    """Empty key columns, T off the block size, all-wildcard patterns,
    both probe columns."""
    rng = np.random.default_rng(T + K)
    tri = rng.integers(0, 60, (T, 3)).astype(np.int32)
    keys = np.sort(rng.integers(0, 60, K)).astype(np.int32)
    for pat in [(-1, 3, -1), (-1, -1, -1), (7, 2, -1), (1, 2, 3)]:
        for col in (0, 2):
            want = j_scan_probe(jnp.asarray(tri), jnp.asarray(pat, jnp.int32),
                                jnp.asarray(keys), col, bt=bt, bk=bt,
                                interpret=True)
            got = scan_probe(_t(tri), pat, _t(keys), col)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                _eq(g, w)


def test_scan_probe_rejects_predicate_column():
    with pytest.raises(ValueError):
        j_scan_probe(jnp.zeros((8, 3), jnp.int32),
                     jnp.asarray([-1, -1, -1], jnp.int32),
                     jnp.zeros(4, jnp.int32), col=1, interpret=True)
    with pytest.raises(ValueError):
        scan_probe(_t(np.zeros((8, 3))), (-1, -1, -1), _t(np.zeros(4)),
                   col=1)


@pytest.mark.parametrize("call", [
    lambda: triple_scan(torch.zeros((4, 3), dtype=torch.int64), (0, 0, 0)),
    lambda: triple_scan(torch.zeros((4, 2), dtype=torch.int32), (0, 0, 0)),
    lambda: triple_scan_many(torch.zeros((4, 3), dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32)),
    lambda: probe_sorted(torch.zeros(4, dtype=torch.float32),
                         torch.zeros(2, dtype=torch.int32)),
    lambda: probe_sorted_many(torch.zeros(4, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32)),
    lambda: scan_probe(torch.zeros((4, 3), dtype=torch.int32), (0, 0, 0),
                       torch.zeros((2, 2), dtype=torch.int32), 0),
])
def test_wrappers_check_arguments(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = launch_counts()
    tri = _t(np.arange(30).reshape(10, 3) % 7)
    keys = _t(np.arange(5))
    triple_scan(tri, (-1, 1, -1))
    triple_scan_many(tri, _t([[-1, 1, -1]]))
    probe_sorted(keys, _t([1, 2]))
    scan_probe(tri, (-1, -1, -1), keys, 0)
    assert launch_counts() == before
