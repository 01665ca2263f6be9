"""The port's engine against the JAX package's engine: the port runs
``TorchBackend(device="cpu")`` (the plain torch versions of its kernels),
the reference ``JaxBackend(bt=512)`` (Pallas in interpret mode). Both get
the same arrays; bindings and edge ids must agree as multisets, and the
transfer, device-routing, scan and join counters must be equal."""

from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.rdf.deltas import TripleDelta as RTripleDelta  # noqa: E402
from repro.rdf.generator import generate_watdiv_like  # noqa: E402
from repro.rdf.generator import \
    workload_sparql as r_workload_sparql  # noqa: E402
from repro.rdf.sharding import ShardedTripleStore as RSharded  # noqa: E402
from repro.sparql.engine import JaxBackend  # noqa: E402
from repro.sparql.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.sparql.matcher import MatchCapacityError as RCapErr  # noqa: E402
from repro.sparql.query import QueryGraph as RQG  # noqa: E402
from repro.sparql.query import TriplePattern as RTP  # noqa: E402

from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.rdf import generator as tgen  # noqa: E402
from repro_torch.rdf.deltas import TripleDelta  # noqa: E402
from repro_torch.rdf.graph import TripleStore  # noqa: E402
from repro_torch.rdf.sharding import ShardedTripleStore  # noqa: E402
from repro_torch.sparql import engine as teng  # noqa: E402
from repro_torch.sparql.engine import QueryEngine, TorchBackend  # noqa: E402
from repro_torch.sparql.device_join import device_eligible  # noqa: E402
from repro_torch.sparql.matcher import (MatchCapacityError,  # noqa: E402
                                        plan_bgp)
from repro_torch.sparql.query import QueryGraph, TriplePattern  # noqa: E402

# the device-join shape matrix of tests/test_device_join.py, as plain tuples
DEVICE_SHAPES = [
    [("?x", 0, "?y")],
    [("?x", 0, "?y"), ("?y", 1, "?z")],
    [("?x", 0, "?y"), ("?x", 1, "?z")],
    [("?x", 0, "?y"), ("?y", 1, "?z"), ("?z", 2, "?w")],
    [(3, 0, "?y"), ("?y", 1, "?z")],
]
HOST_SHAPES = [
    [("?x", "?p", "?y")],
    [("?x", 0, "?x")],
    [("?x", 0, "?y"), ("?y", "?p", "?z")],
    [("?x", 0, "?y"), ("?y", 1, "?z"), ("?z", 2, "?x")],
]
COUNTERS = ["queries", "batches", "cache_hits", "cache_misses",
            "scans_requested", "scans_executed", "scan_cache_hits",
            "scan_cache_misses", "device_queries", "device_fallbacks",
            "host_transfers", "host_transfer_bytes", "scalar_syncs"]


def _rq(shapes):
    return [RQG([RTP(*p) for p in pats], []) for pats in shapes]


def _tq(shapes):
    return [QueryGraph([TriplePattern(*p) for p in pats], [])
            for pats in shapes]


def _rows(res):
    """Multiset of (sorted-var bindings + pattern-order edge ids) rows."""
    idx = [res.var_names.index(v) for v in sorted(res.var_names)]
    rows = np.concatenate([res.bindings[:, idx], res.edge_ids], axis=1)
    return sorted(map(tuple, rows.tolist()))


def _stores(sharded, scale=0.5, seed=11):
    g = generate_watdiv_like(scale=scale, seed=seed)
    ref = RSharded.from_store(g.store, 4) if sharded else g.store
    port, _ = from_reference(ref.to_arrays(), g.dictionary.to_arrays())
    return ref, port


def _assert_same(ref_eng, port_eng, ref_out, port_out):
    for a, b in zip(ref_out, port_out):
        assert _rows(a) == _rows(b)
    for name in COUNTERS:
        assert getattr(port_eng.stats, name) == getattr(ref_eng.stats, name), \
            name
    assert asdict(port_eng.stats.join) == asdict(ref_eng.stats.join)


@pytest.mark.parametrize("sharded", [False, True])
def test_engine_matches_jax_engine(sharded):
    ref, port = _stores(sharded)
    shapes = DEVICE_SHAPES + HOST_SHAPES
    r_eng = RQueryEngine(backend=JaxBackend(bt=512))
    t_eng = QueryEngine(backend=TorchBackend(device="cpu"))
    _assert_same(r_eng, t_eng, r_eng.execute_batch(ref, _rq(shapes)),
                 t_eng.execute_batch(port, _tq(shapes)))
    assert t_eng.stats.device_queries >= len(DEVICE_SHAPES)
    assert t_eng.stats.device_fallbacks > 0
    assert t_eng.stats.join.joins_device > 0
    assert t_eng.stats.backend_mode == "torch-cpu"


@pytest.mark.parametrize("sharded", [False, True])
def test_transfer_contract_matches_jax_engine(sharded):
    """1 transfer for an all-device batch, 2 for a mixed batch, 0 warm —
    with equal byte and scalar-sync counts at every step."""
    ref, port = _stores(sharded)
    rb, tb = JaxBackend(bt=512), TorchBackend(device="cpu")
    r_eng, t_eng = RQueryEngine(backend=rb), QueryEngine(backend=tb)
    steps = [(DEVICE_SHAPES, 1, False), (DEVICE_SHAPES + HOST_SHAPES, 2, True),
             (DEVICE_SHAPES, 0, False)]
    for shapes, want, clear in steps:
        if clear:
            r_eng.clear_cache()
            t_eng.clear_cache()
        before = tb.host_transfers
        _assert_same(r_eng, t_eng, r_eng.execute_batch(ref, _rq(shapes)),
                     t_eng.execute_batch(port, _tq(shapes)))
        assert tb.host_transfers - before == want
        assert (tb.host_transfers, tb.host_transfer_bytes,
                tb.scalar_syncs) == (rb.host_transfers,
                                     rb.host_transfer_bytes, rb.scalar_syncs)


@pytest.mark.parametrize("slack", [0, -1])
def test_capacity_error_parity(slack):
    n = 200
    s = np.concatenate([np.arange(n), np.zeros(n, np.int64)])
    p = np.concatenate([np.zeros(n, np.int64), np.ones(n, np.int64)])
    o = np.concatenate([np.zeros(n, np.int64), np.arange(n)])
    shape = [[("?x", 0, "?y"), ("?y", 1, "?z")]]
    ref = RSharded(s, p, o, n + 1, 2, num_shards=2)
    port = ShardedTripleStore(s, p, o, n + 1, 2, num_shards=2)
    r_eng = RQueryEngine(backend=JaxBackend(bt=512), max_rows=n * n + slack)
    t_eng = QueryEngine(backend=TorchBackend(device="cpu"),
                        max_rows=n * n + slack)
    if slack < 0:
        with pytest.raises(RCapErr):
            r_eng.execute(ref, _rq(shape)[0])
        with pytest.raises(MatchCapacityError):
            t_eng.execute(port, _tq(shape)[0])
    else:
        assert t_eng.execute(port, _tq(shape)[0]).num_matches == n * n
        assert r_eng.execute(ref, _rq(shape)[0]).num_matches == n * n
    assert t_eng.stats.device_queries == r_eng.stats.device_queries == 1


def test_delta_restages_views_like_jax_engine():
    rng = np.random.default_rng(31)
    s, p, o = (rng.integers(0, 20, 80), rng.integers(0, 4, 80),
               rng.integers(0, 20, 80))
    ref = RSharded(s, p, o, 20, 4, num_shards=2)
    port = ShardedTripleStore(s, p, o, 20, 4, num_shards=2)
    shape = [[("?x", 0, "?y"), ("?y", 1, "?z")]]
    tb = TorchBackend(device="cpu")
    r_eng = RQueryEngine(backend=JaxBackend(bt=512))
    t_eng = QueryEngine(backend=tb)
    _assert_same(r_eng, t_eng, [r_eng.execute(ref, _rq(shape)[0])],
                 [t_eng.execute(port, _tq(shape)[0])])
    staged = dict(tb._staged_views)
    assert staged
    rows = np.stack([np.arange(5), np.ones(5, np.int64), np.arange(5) + 5],
                    axis=1)
    ref.apply_delta(RTripleDelta(base_version=ref.version, add=rows))
    port.apply_delta(TripleDelta(base_version=port.version, add=rows))
    _assert_same(r_eng, t_eng, [r_eng.execute(ref, _rq(shape)[0])],
                 [t_eng.execute(port, _tq(shape)[0])])
    assert t_eng.stats.device_queries == 2
    assert set(tb._staged_views) - set(staged)     # re-staged new version


def test_staged_view_lru_bounded():
    _, port = _stores(True, scale=0.3, seed=7)
    tb = TorchBackend(device="cpu")
    tb.max_staged_views = 2
    eng = QueryEngine(backend=tb)
    shapes = [[("?x", pid, "?y"), ("?y", (pid + 1) % 4, "?z")]
              for pid in range(4)]
    ref = QueryEngine(backend="numpy")
    for a, b in zip(eng.execute_batch(port, _tq(shapes)),
                    ref.execute_batch(port, _tq(shapes))):
        assert _rows(a) == _rows(b)
    assert len(tb._staged_views) <= 2


def test_device_resident_off_runs_host_path():
    _, port = _stores(True)
    eng = QueryEngine(backend=TorchBackend(device="cpu",
                                           device_resident=False))
    ref = QueryEngine(backend="numpy")
    for a, b in zip(eng.execute_batch(port, _tq(DEVICE_SHAPES)),
                    ref.execute_batch(port, _tq(DEVICE_SHAPES))):
        assert _rows(a) == _rows(b)
    assert eng.stats.device_queries == 0
    assert eng.stats.join.joins_device == 0


@pytest.mark.parametrize("sharded", [False, True])
def test_from_reference_same_triples_and_views(sharded):
    g = generate_watdiv_like(scale=0.3, seed=5)
    ref = RSharded.from_store(g.store, 3) if sharded else g.store
    port, d = from_reference(ref.to_arrays(), g.dictionary.to_arrays())
    assert type(port).__name__ == type(ref).__name__
    assert port.num_triples == ref.num_triples
    np.testing.assert_array_equal(port.triples(), ref.triples())
    assert (d.num_entities, d.num_predicates) == (
        g.dictionary.num_entities, g.dictionary.num_predicates)
    assert d.entity(17) == g.dictionary.entity(17)
    for pid in range(ref.num_predicates):
        a, b = port.pred_index(pid), ref.pred_index(pid)
        for f in ("tids", "s_order", "s_sorted", "o_order", "o_sorted"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    mono, _ = from_reference(ref.to_arrays(), g.dictionary.to_arrays(),
                             num_shards=2)
    assert mono.num_shards == 2


def test_generator_copy_gives_the_same_arrays():
    a = generate_watdiv_like(scale=0.3, seed=9)
    b = tgen.generate_watdiv_like(scale=0.3, seed=9)
    np.testing.assert_array_equal(a.store.triples(), b.store.triples())
    assert tgen.workload_sparql(b, 12, seed=4) == \
        r_workload_sparql(a, 12, seed=4)


def test_registry_and_no_cpu_fallback(monkeypatch):
    """Entry points default to cuda and raise instead of running on the
    CPU when CUDA is missing; the CPU runs only when asked for."""
    assert teng.available_backends() == ["numpy", "torch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.get_backend("torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine()
    assert TorchBackend(device="cpu").mode == "torch-cpu"
    assert QueryEngine(backend="numpy").stats.backend_mode == "numpy"


def test_int32_id_guard():
    """Ids past int32 never reach a kernel: staging refuses them and the
    device route declines the query."""
    store = TripleStore(np.zeros(1, np.int64), np.zeros(1, np.int64),
                        np.zeros(1, np.int64), 2 ** 31, 1)
    with pytest.raises(ValueError, match="int32"):
        TorchBackend(device="cpu")._triples(store)
    q = _tq([[("?x", 0, "?y")]])[0]
    assert not device_eligible(store, q, plan_bgp(store, q))


def test_fetch_is_one_transfer_of_int32_leaves():
    tb = TorchBackend(device="cpu")
    tree = [({"?x": torch.arange(4, dtype=torch.int32)},
             {0: torch.zeros((2, 3), dtype=torch.int32)}), []]
    out = tb._fetch(tree)
    assert tb.host_transfers == 1 and tb.host_transfer_bytes == 40
    np.testing.assert_array_equal(out[0][0]["?x"], np.arange(4))
    assert out[0][1][0].shape == (2, 3) and out[1] == []
    with pytest.raises(TypeError):
        tb._fetch([torch.zeros(2, dtype=torch.int64)])
