"""The port's ``EdgeCloudSystem`` on ``TorchBackend(device="cpu")`` against
the reference's (numpy backend, and the jax backend in interpret mode on
one small case): placement from the same histories, all five policies'
schedules, objectives and results, the partial-evaluation matrix of the
reference's suite and the stale-plan fallback, delta against full
rebalance, the fork guard of process overlap, and a CPU rehearsal of
``chip_smoke.py``'s system phase."""

import importlib
import multiprocessing
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cost import SystemParams as RParams  # noqa: E402
from repro.core.pattern import pattern_of as r_pattern_of  # noqa: E402
from repro.edge.system import EdgeCloudSystem as RSystem  # noqa: E402
from repro.rdf.generator import generate_watdiv_like  # noqa: E402
from repro.rdf.generator import workload_sparql  # noqa: E402
from repro.rdf.graph import TripleStore as RStore  # noqa: E402
from repro.rdf.sharding import ShardedTripleStore as RSharded  # noqa: E402
from repro.sparql.endpoint import SparqlEndpoint as REndpoint  # noqa: E402
from repro.sparql.query import parse_sparql as r_parse_sparql  # noqa: E402

from repro_torch.convert import (from_reference,  # noqa: E402
                                 system_params_from_reference)
from repro_torch.core.pattern import pattern_of  # noqa: E402
from repro_torch.edge import system as tsys  # noqa: E402
from repro_torch.edge.system import PARTIAL, EdgeCloudSystem  # noqa: E402
from repro_torch.sparql.algebra import evaluate_many  # noqa: E402
from repro_torch.sparql.endpoint import SparqlEndpoint  # noqa: E402
from repro_torch.sparql.engine import QueryEngine  # noqa: E402
from repro_torch.sparql.partial_eval import (  # noqa: E402
    execute_partial_batch, plan_partial)
from repro_torch.sparql.query import parse_sparql  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TEMPLATES = ["chain2", "chain3", "anchored_star", "anchored_chain"]
ALGEBRA = [
    "SELECT ?x ?g WHERE { ?x <likes> ?p . OPTIONAL { ?p <hasGenre> ?g } }",
    "SELECT ?x ?y WHERE { { ?x <follows> ?y } UNION { ?x <likes> ?y } } "
    "LIMIT 50",
    "SELECT DISTINCT ?c WHERE { ?u <country> ?c } ORDER BY ?c",
    "ASK { ?x <subgenreOf> ?y }",
    "SELECT ?x ?y WHERE { ?x <follows> ?y . ?y <follows> ?x }",
]
POLICIES = ["cloud_only", "random", "edge_first", "greedy", "bnb"]
# the reference's partial-evaluation matrix: no edge holds every leaf of
# any query, so the binary scheduler could only send them to the cloud
LEAVES = {
    0: ["SELECT ?x ?p WHERE { ?x <likes> ?p }"],
    1: ["SELECT ?p ?gn WHERE { ?p <hasGenre> ?gn }",
        "SELECT ?x ?y WHERE { ?x <follows> ?y }"],
    2: ["SELECT ?x ?c WHERE { ?x <country> ?c }"],
}
QUERIES = {
    "path2": "SELECT ?x ?gn WHERE { { ?x <likes> ?p } "
             "{ ?p <hasGenre> ?gn } }",
    "star3": "SELECT ?x ?y ?c WHERE { { ?x <likes> ?p } "
             "{ ?x <follows> ?y } { ?x <country> ?c } }",
    "flower": "SELECT ?x ?gn ?c WHERE { { ?x <likes> ?p } "
              "{ ?p <hasGenre> ?gn } { ?x <country> ?c } }",
}


def rows(tbl):
    order = sorted(tbl.var_names)
    b = np.asarray(tbl.bindings)
    return sorted(map(tuple, b[:, [tbl.var_names.index(v)
                                   for v in order]].tolist()))


@pytest.fixture(scope="module")
def graph():
    return generate_watdiv_like(scale=1.0, seed=42)


def fresh(g, kind):
    """A new reference store (and its port copy) of the fixture's triples:
    systems that rebalance or ingest mutate their stores."""
    base = RStore(np.asarray(g.store.s).copy(), np.asarray(g.store.p).copy(),
                  np.asarray(g.store.o).copy(), g.dictionary.num_entities,
                  g.dictionary.num_predicates)
    ref = RSharded.from_store(base, 4) if kind == "sharded" else base
    port, d = from_reference(ref.to_arrays(), g.dictionary.to_arrays())
    return ref, port, d


def history(g):
    return [workload_sparql(g, 5, seed=100 + n, templates=TEMPLATES)
            for n in range(20)]


def pairs(g):
    texts = workload_sparql(g, 16, seed=77, templates=TEMPLATES) + ALGEBRA
    return [(n % 20, t) for n, t in enumerate(texts)]


def build(g, kind, prepare=True, ref_engine=None):
    rs, ts, d = fresh(g, kind)
    params = RParams.synthetic(n_users=20, n_edges=4, seed=1)
    budget = int(0.69 * rs.size_bytes())
    ref = RSystem(rs, g.dictionary, params, budget, engine=ref_engine)
    port = EdgeCloudSystem(ts, d, system_params_from_reference(params),
                           budget, device="cpu")
    if prepare:
        ref.prepare(history(g))
        port.prepare(history(g))
    return ref, port


@pytest.fixture(scope="module")
def prepared(graph):
    return {kind: build(graph, kind) for kind in ("mono", "sharded")}


@pytest.mark.parametrize("kind", ["mono", "sharded"])
def test_prepare_matches_reference(prepared, kind):
    ref, port = prepared[kind]
    assert port.engine.stats.backend_mode == "torch-cpu"
    for a, b in zip(ref.edges, port.edges):
        assert sorted(b._resident) == sorted(a._resident)
        assert b.used_bytes() == a.used_bytes() > 0
        assert np.array_equal(b.resident_eids, a.resident_eids)
        assert np.array_equal(np.asarray(b.store.triples()),
                              np.asarray(a.store.triples()))
        assert len(b.index) == len(a.index)
        assert b.placement.sizes == a.placement.sizes
    assert port.placement_epoch == ref.placement_epoch == 1


def _check_round(a, b, with_results=True):
    assert [o.assigned_to for o in b.outcomes] == \
        [o.assigned_to for o in a.outcomes]
    assert [o.executable_edges for o in b.outcomes] == \
        [o.executable_edges for o in a.outcomes]
    assert b.objective == pytest.approx(a.objective, rel=1e-12)
    assert b.assignment_counts == a.assignment_counts
    assert [o.n_matches for o in b.outcomes] == \
        [o.n_matches for o in a.outcomes]
    for x, y in zip(a.outcomes, b.outcomes):
        assert y.modeled_latency == pytest.approx(x.modeled_latency,
                                                  rel=1e-12)
    if with_results:
        for x, y in zip(a.results, b.results):
            assert y.var_names == x.var_names
            assert rows(y) == rows(x)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["mono", "sharded"])
def test_rounds_match_reference(graph, prepared, kind, policy):
    ref, port = prepared[kind]
    rep_r = REndpoint.from_system(ref).run_round(
        pairs(graph), policy=policy, observe=False, collect_results=True)
    rep_p = SparqlEndpoint.from_system(port).run_round(
        pairs(graph), policy=policy, observe=False, collect_results=True)
    _check_round(rep_r, rep_p)
    if policy == "bnb":
        assert rep_p.schedule_info["optimal"]
    if policy != "cloud_only":
        assert rep_p.assignment_counts.get(-1, 0) < len(rep_p.outcomes)
    # the cloud's answers: every result equals the cloud store's
    oracle = evaluate_many([SparqlEndpoint.from_system(port).parse(t)
                            for _, t in pairs(graph)],
                           port.cloud.store, QueryEngine(backend="numpy"))
    for got, want, (_, t) in zip(rep_p.results, oracle, pairs(graph)):
        assert rows(got) == rows(want), t


def test_unbatched_round_matches_reference(graph, prepared):
    ref, port = prepared["mono"]
    qs_r = [(u, r_parse_sparql(t, ref.dictionary))
            for u, t in pairs(graph)[:16]]
    qs_p = [(u, parse_sparql(t, port.dictionary))
            for u, t in pairs(graph)[:16]]
    a = ref.run_round(qs_r, policy="bnb", observe=False)
    b = port.run_round(qs_p, policy="bnb", observe=False)
    _check_round(a, b, with_results=False)


def test_round_matches_jax_reference(graph):
    """One bnb round against the reference on its jax backend (Pallas in
    interpret mode, as the reference's own tests run it)."""
    pytest.importorskip("jax")
    from repro.sparql.engine import JaxBackend
    from repro.sparql.engine import QueryEngine as RQueryEngine
    small = generate_watdiv_like(scale=0.3, seed=42)
    ref, port = build(small, "mono",
                      ref_engine=RQueryEngine(backend=JaxBackend(bt=512)))
    ps = pairs(small)[:10]
    rep_r = REndpoint.from_system(ref).run_round(
        ps, policy="bnb", observe=False, collect_results=True)
    rep_p = SparqlEndpoint.from_system(port).run_round(
        ps, policy="bnb", observe=False, collect_results=True)
    assert ref.engine.stats.backend_mode.startswith("jax")
    _check_round(rep_r, rep_p)


def _collab(g, kind):
    """The reference partial suite's system on both sides."""
    rs, ts, d = fresh(g, kind)
    K, N = 3, 4
    params = RParams(F=np.full(K, 1.0e9), r_edge=np.full((N, K), 75e6),
                     r_cloud=np.full(N, 5e6),
                     assoc=np.ones((N, K), dtype=bool),
                     r_backhaul=np.full(K, 1e9), F_cloud=0.05e9)
    ref = RSystem(rs, g.dictionary, params, storage_budgets=10_000_000)
    port = EdgeCloudSystem(ts, d, system_params_from_reference(params),
                           storage_budgets=10_000_000, device="cpu")
    for k, texts in LEAVES.items():
        ref.edges[k].deploy(rs, [r_pattern_of(r_parse_sparql(
            t, g.dictionary)) for t in texts])
        port.edges[k].deploy(ts, [pattern_of(parse_sparql(t, d))
                                  for t in texts])
    return ref, port


@pytest.mark.parametrize("shape", list(QUERIES))
@pytest.mark.parametrize("kind", ["mono", "sharded"])
def test_partial_matrix_matches_reference(graph, kind, shape):
    ref, port = _collab(graph, kind)
    text = QUERIES[shape]
    rep_r = REndpoint.from_system(ref).run_round(
        [(0, text)], policy="bnb", collect_results=True)
    ep = SparqlEndpoint.from_system(port)
    rep_p = ep.run_round([(0, text)], policy="bnb", collect_results=True)
    o = rep_p.outcomes[0]
    assert o.assigned_to == PARTIAL
    assert rep_p.partial_queries == 1 and rep_p.partial_fallbacks == 0
    assert len(o.partial_servers) >= 2
    assert o.partial_servers == rep_r.outcomes[0].partial_servers
    assert rep_p.partial_bytes_shipped == rep_r.partial_bytes_shipped > 0
    assert o.shipped_bits == rep_r.outcomes[0].shipped_bits
    _check_round(rep_r, rep_p)
    oracle = evaluate_many([ep.parse(text)], port.cloud.store,
                           QueryEngine(backend="numpy"))[0]
    assert rows(rep_p.results[0]) == rows(oracle)
    assert port.explain_assignment(ep.parse(text)) == \
        ref.explain_assignment(REndpoint.from_system(ref).parse(text))


def test_stale_partial_plan_falls_back(graph):
    _, port = _collab(graph, "mono")
    ep = SparqlEndpoint.from_system(port)
    plan = ep.parse(QUERIES["path2"])
    pp = plan_partial(plan, port.edges)
    assert pp is not None and len(pp.edge_set) == 2
    edges = {es.server_id: es for es in port.edges}
    fresh_run = execute_partial_batch([pp], port.cloud.store, port.engine,
                                      edges)[0]
    assert not fresh_run.fallback
    # a contributing edge's store moves between planning and execution
    port.edges[0].deploy(port.cloud.store, [pattern_of(parse_sparql(
        LEAVES[0][0], port.dictionary))])
    stale = execute_partial_batch([pp], port.cloud.store, port.engine,
                                  edges)[0]
    assert stale.fallback and stale.shipped_bits == 0.0
    oracle = evaluate_many([plan], port.cloud.store,
                           QueryEngine(backend="numpy"))[0]
    assert rows(stale.result) == rows(oracle) == rows(fresh_run.result)


@pytest.mark.parametrize("kind", ["mono", "sharded"])
def test_delta_and_full_rebalance_agree(graph, kind):
    """Observed rounds, then a delta rebalance on one port system and a
    full re-ship on another: the same edge contents, and the same changes
    and bytes as the reference's delta rebalance."""
    systems = {}
    for mode in ("delta", "full"):
        ref, port = build(graph, kind)
        for s, ep_cls in ((ref, REndpoint), (port, SparqlEndpoint)):
            ep_cls.from_system(s).run_round(pairs(graph), policy="bnb",
                                            observe=True)
        systems[mode] = (ref, port)
    ref, port = systems["delta"]
    want = ref.rebalance_all(use_deltas=True)
    got = port.rebalance_all(use_deltas=True)
    assert got == want and any(a or e for a, e in got.values())
    assert port.last_rebalance.shipped_bytes == ref.last_rebalance.shipped_bytes
    assert [e.mode for e in port.last_rebalance.per_edge] == \
        [e.mode for e in ref.last_rebalance.per_edge]
    full = systems["full"][1]
    assert full.rebalance_all(use_deltas=False) == got
    for a, b, c in zip(ref.edges, port.edges, full.edges):
        want_rows = np.unique(np.asarray(a.store.triples()), axis=0)
        assert np.array_equal(np.unique(np.asarray(b.store.triples()),
                                        axis=0), want_rows)
        assert np.array_equal(np.unique(np.asarray(c.store.triples()),
                                        axis=0), want_rows)
    assert full.last_rebalance.shipped_bytes >= \
        port.last_rebalance.shipped_bytes
    # a round on the new placement still answers as the reference does
    rep_r = REndpoint.from_system(ref).run_round(
        pairs(graph), policy="bnb", observe=False, collect_results=True)
    rep_p = SparqlEndpoint.from_system(port).run_round(
        pairs(graph), policy="bnb", observe=False, collect_results=True)
    _check_round(rep_r, rep_p)


def test_async_rebalance_overlapping_a_round(graph):
    ref, port = build(graph, "mono")
    ep = SparqlEndpoint.from_system(port)
    ep.run_round(pairs(graph), policy="bnb", observe=True)
    REndpoint.from_system(ref).run_round(pairs(graph), policy="bnb",
                                         observe=True)
    handle = port.rebalance_async()
    rep = ep.run_round(pairs(graph), policy="greedy", collect_results=True)
    report = handle.join()
    assert report.changes == ref.rebalance_all()
    assert report.epoch == port.placement_epoch
    assert report.matcher_calls > 0
    oracle = evaluate_many([ep.parse(t) for _, t in pairs(graph)],
                           port.cloud.store, QueryEngine(backend="numpy"))
    for got, want in zip(rep.results, oracle):
        assert rows(got) == rows(want)


def test_resolve_overlap_mode_rules():
    assert tsys.resolve_overlap_mode(False, "torch") == ""
    assert tsys.resolve_overlap_mode(True, "numpy") == "process"
    assert tsys.resolve_overlap_mode(True, "torch") == "thread"
    assert tsys.resolve_overlap_mode("process", "torch") == "process"
    assert tsys.resolve_overlap_mode("thread", "numpy") == "thread"


@pytest.mark.parametrize("engine",
                         ["torch", "numpy", "numpy-with-cuda-context"])
def test_process_overlap_never_forks_a_cuda_context(graph, prepared,
                                                    monkeypatch, engine):
    """``overlap="process"`` turns into thread overlap for every engine: a
    torch engine, a numpy engine, and a numpy engine once CUDA is
    initialized in the process. No child process is started."""
    _, port = prepared["mono"]
    system = port
    if engine != "torch":
        if engine == "numpy-with-cuda-context":
            monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        system = EdgeCloudSystem(port.cloud.store, port.dictionary,
                                 port.params, port.edges[0].budget,
                                 backend="numpy")
        system.prepare(history(graph))
    rep = system.run_round_batched(
        [(u, SparqlEndpoint.from_system(system).parse(t))
         for u, t in pairs(graph)], policy="bnb", observe=False,
        overlap="process")
    assert rep.overlap_mode == "thread" and rep.overlapped
    assert not multiprocessing.active_children()
    want = SparqlEndpoint.from_system(port).run_round(
        pairs(graph), policy="bnb", observe=False)
    assert [o.n_matches for o in rep.outcomes] == \
        [o.n_matches for o in want.outcomes]


def test_system_runs_on_cuda_unless_asked(graph, monkeypatch):
    rs, ts, d = fresh(graph, "mono")
    params = system_params_from_reference(RParams.synthetic(4, 2, seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EdgeCloudSystem(ts, d, params, 10_000)
    with pytest.raises(RuntimeError, match="CUDA"):
        SparqlEndpoint(ts, d)
    numpy_sys = EdgeCloudSystem(ts, d, params, 10_000, backend="numpy")
    assert numpy_sys.engine.stats.backend_mode == "numpy"
    ep = SparqlEndpoint(system=numpy_sys)
    assert ep.engine is numpy_sys.engine and ep.store is ts
    cpu_sys = EdgeCloudSystem(ts, d, params, 10_000, device="cpu")
    assert cpu_sys.engine.stats.backend_mode == "torch-cpu"
    with pytest.raises(ValueError, match="EdgeCloudSystem"):
        SparqlEndpoint(ts, d, device="cpu").run_round([(0, ALGEBRA[2])])


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_system_phase_on_cpu():
    """The system phase's checks (placement, five policies cold and warm
    against the numpy oracle, bnb lowest, edges used, the staging LRU, no
    fork, the partial split; then the write path and the rebalance on a
    4-shard store) at a small scale, with the plain torch versions on the
    CPU."""
    smoke = _chip_smoke()
    from repro_torch.rdf.generator import generate_watdiv_like as tgen
    from repro_torch.rdf.sharding import ShardedTripleStore
    gen = tgen(scale=1.0, seed=0)
    a = smoke.system_phase(gen, gen.store, "cpu", 200_000)
    assert a["launches"] == {}              # the CPU never launches a kernel
    assert set(a["rounds"]) == set(smoke.POLICIES)
    assert a["rounds"]["bnb"]["cold"]["optimal"]
    assert a["partial"]["servers"] == [0, 1] and a["partial"]["rows"] > 0
    assert a["staged"]["missing"] == []
    small = tgen(scale=1.0, seed=1)
    b = smoke.ingest_phase(small, ShardedTripleStore.from_store(
        small.store, 4), "cpu", 200_000)
    steps = b["steps"]
    assert steps["insert"]["ack"]["edges_updated"] > 0
    assert [c["coalesced"] for c in steps["window"]["acks"]] == [2, 2, 1]
    assert len(steps["window"]["commits"]) == 2
    assert steps["rebalance"]["epoch"] > 0
    assert b["staged_slots"]["flat_arrays"] > 4
