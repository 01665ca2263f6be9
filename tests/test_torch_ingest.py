"""The port's write path against the reference's: ``SparqlEndpoint.update``
/ ``update_many`` on a standalone store, and ``EdgeCloudSystem.apply_update``
/ ``apply_delta`` / ``update_many`` on a placed system (monolithic and
4-shard). Acks, store triples after each step, dictionary versions, the
plan and result memos, coalescing, failure isolation, edge propagation
and the rounds after each write must all agree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cost import SystemParams as RParams  # noqa: E402
from repro.edge.system import EdgeCloudSystem as RSystem  # noqa: E402
from repro.rdf.generator import generate_watdiv_like  # noqa: E402
from repro.rdf.generator import workload_sparql  # noqa: E402
from repro.rdf.graph import TripleStore as RStore  # noqa: E402
from repro.rdf.sharding import ShardedTripleStore as RSharded  # noqa: E402
from repro.sparql.endpoint import SparqlEndpoint as REndpoint  # noqa: E402
from repro.sparql.engine import QueryEngine as RQueryEngine  # noqa: E402

from repro_torch.convert import (from_reference,  # noqa: E402
                                 system_params_from_reference)
from repro_torch.edge.system import EdgeCloudSystem  # noqa: E402
from repro_torch.sparql.endpoint import SparqlEndpoint  # noqa: E402
from repro_torch.sparql.query import ParseError  # noqa: E402

KINDS = ["mono", "sharded"]
TEMPLATES = ["chain2", "chain3", "anchored_star", "anchored_chain"]
REPORT_FIELDS = ["kind", "n_add", "n_evict", "new_terms", "dropped_rows",
                 "touched_predicates", "patterns_carried",
                 "patterns_invalidated", "edges_updated", "shipped_bytes",
                 "placement_epoch", "is_noop"]
PROBES = ["SELECT ?p WHERE { <wA> <likes> ?p }",
          "SELECT ?x ?c WHERE { ?x <country> ?c }",
          "SELECT ?x ?u ?c WHERE { ?x <likes> ?p . ?x <follows> ?u . "
          "?x <country> ?c }",
          "SELECT ?s ?o WHERE { ?s <follows> ?o }"]


def stream(tag: str) -> list[str]:
    """Inserts of new terms, a star that completes a resident star3
    match, deletes of present, absent and unknown rows, a re-insert and a
    DELETE WHERE."""
    return [
        f"INSERT DATA {{ <{tag}_u0> <likes> <Product0> . "
        f"<{tag}_u0> <country> <Country1> }}",
        f"INSERT DATA {{ <{tag}_s> <likes> <{tag}_p> . "
        f"<{tag}_s> <follows> <{tag}_f> . <{tag}_s> <country> <{tag}_c> }}",
        "INSERT DATA { <wA> <likes> <Product0> . <wA> <likes> <Product1> }",
        "DELETE DATA { <wA> <likes> <Product0> }",
        f"DELETE DATA {{ <{tag}_never> <likes> <Product0> }}",
        "INSERT DATA { <wA> <likes> <Product0> }",
        "INSERT DATA { <wA> <likes> <Product0> }",         # already there
        f"DELETE WHERE {{ <{tag}_u0> ?p ?o }}",
        f"DELETE WHERE {{ <{tag}_s> <follows> ?f }}",
    ]


@pytest.fixture(scope="module")
def graph():
    return generate_watdiv_like(scale=1.0, seed=42)


def fresh(g, kind):
    """New stores (reference and port) and a port copy of the dictionary:
    the tests mutate all three. The reference side writes into a copy of
    the fixture's dictionary too."""
    from repro.rdf.dictionary import Dictionary as RDictionary
    rd = RDictionary.from_arrays(g.dictionary.to_arrays())
    base = RStore(np.asarray(g.store.s).copy(), np.asarray(g.store.p).copy(),
                  np.asarray(g.store.o).copy(), rd.num_entities,
                  rd.num_predicates)
    ref = RSharded.from_store(base, 4) if kind == "sharded" else base
    port, d = from_reference(ref.to_arrays(), rd.to_arrays())
    return ref, rd, port, d


def triples(store):
    return np.unique(np.asarray(store.triples()), axis=0)


def same(a, b):
    """Acks equal, exceptions of the same type where a text failed."""
    if isinstance(a, Exception):
        return type(b).__name__ == type(a).__name__
    return a == b


def rows(tbl):
    order = sorted(tbl.var_names)
    b = np.asarray(tbl.bindings)
    return sorted(map(tuple, b[:, [tbl.var_names.index(v)
                                   for v in order]].tolist()))


def answer(ep, text):
    """The query's rows, or the name of the error it raised (a query that
    names a term the dictionary does not hold yet does not parse)."""
    try:
        return rows(ep.query(text))
    except Exception as err:             # each package's own ParseError
        return type(err).__name__


@pytest.mark.parametrize("kind", KINDS)
def test_standalone_updates_match_reference(graph, kind):
    rs, rd, ts, d = fresh(graph, kind)
    ref = REndpoint(rs, rd, engine=RQueryEngine(backend="numpy"))
    port = SparqlEndpoint(ts, d, device="cpu")
    for text in stream("solo"):
        for probe in PROBES:
            assert answer(port, probe) == answer(ref, probe)
        assert port.update(text) == ref.update(text), text
        assert np.array_equal(triples(ts), triples(rs)), text
        assert d.version == rd.version and d.num_entities == rd.num_entities
        assert ts.num_entities == rs.num_entities
    for probe in PROBES:
        assert answer(port, probe) == answer(ref, probe) != "ParseError"
    # the result memo is keyed on the store version and the plan memo on
    # the dictionary's: both endpoints hit and miss alike
    assert (port.memo_hits, port.memo_misses) == (ref.memo_hits,
                                                  ref.memo_misses)
    assert len(port._plans) == len(ref._plans)
    assert port.write_commits == ref.write_commits == len(stream("solo"))


def test_new_terms_invalidate_the_plan_memo(graph):
    rs, rd, ts, d = fresh(graph, "mono")
    ref = REndpoint(rs, rd, engine=RQueryEngine(backend="numpy"))
    port = SparqlEndpoint(ts, d, device="cpu")
    probe = "SELECT ?p WHERE { <memoUser> <likes> ?p }"
    for ep in (ref, port):
        other = "SELECT ?p WHERE { <User0> <likes> ?p }"
        plan = ep.parse(other)
        assert answer(ep, probe) == "ParseError"  # unknown term
        v0 = ep.dictionary.version
        ack = ep.update("INSERT DATA { <memoUser> <likes> <Product0> }")
        assert ack["new_terms"] == 1 and ep.dictionary.version == v0 + 1
        assert ep.parse(other) is not plan        # recompiled
        assert ep.query(probe).num_matches == 1
        ep.update("DELETE DATA { <memoUser> <likes> <Product0> }")
        assert ep.query(probe).num_matches == 0   # new store version
    assert (port.memo_hits, port.memo_misses) == (ref.memo_hits,
                                                  ref.memo_misses)


WINDOW = [
    "INSERT DATA { <wA> <likes> <Product0> . <wB> <likes> <Product1> }",
    "DELETE DATA { <wA> <likes> <Product0> }",      # cancels half of #0
    "INSERT DATA { <wA> <likes> <Product0> }",      # re-adds it
    "NOT AN UPDATE {",                              # isolated failure
    "DELETE WHERE { <wB> ?p ?o }",                  # flushes, runs alone
    "DELETE DATA { <wNever> <likes> <Product0> }",  # unknown: no-op
    "INSERT DATA { <wC> <follows> <wA> }",
    "INSERT DATA { <wC> <country> <Country0> }",
]


@pytest.mark.parametrize("kind", KINDS)
def test_standalone_update_many_matches_reference(graph, kind):
    rs, rd, ts, d = fresh(graph, kind)
    ref = REndpoint(rs, rd, engine=RQueryEngine(backend="numpy"))
    port = SparqlEndpoint(ts, d, device="cpu")
    want, got = ref.update_many(WINDOW), port.update_many(WINDOW)
    assert all(same(a, b) for a, b in zip(want, got)), (want, got)
    assert isinstance(got[3], ParseError)
    assert [a["coalesced"] for a in got if isinstance(a, dict)] == \
        [3, 3, 3, 1, 3, 3, 3]
    assert port.write_commits == ref.write_commits == 3
    assert np.array_equal(triples(ts), triples(rs))
    assert d.version == rd.version


def build(g, kind):
    rs, rd, ts, d = fresh(g, kind)
    params = RParams.synthetic(n_users=20, n_edges=4, seed=1)
    budget = int(0.69 * rs.size_bytes())
    ref = RSystem(rs, rd, params, budget)
    port = EdgeCloudSystem(ts, d, system_params_from_reference(params),
                           budget, device="cpu")
    hist = [workload_sparql(g, 5, seed=100 + n, templates=TEMPLATES)
            for n in range(20)]
    ref.prepare(hist)
    port.prepare(hist)
    return ref, port


def check_systems(ref, port, g):
    assert np.array_equal(triples(port.cloud.store), triples(ref.cloud.store))
    for a, b in zip(ref.edges, port.edges):
        assert np.array_equal(triples(b.store), triples(a.store))
        assert np.array_equal(b.resident_eids, a.resident_eids)
    assert port.placement_epoch == ref.placement_epoch
    assert port.dictionary.version == ref.dictionary.version
    texts = workload_sparql(g, 8, seed=77, templates=TEMPLATES) + PROBES[1:]
    user_texts = [(n % 20, t) for n, t in enumerate(texts)]
    a = REndpoint.from_system(ref).run_round(user_texts, policy="bnb",
                                             observe=False,
                                             collect_results=True)
    b = SparqlEndpoint.from_system(port).run_round(
        user_texts, policy="bnb", observe=False, collect_results=True)
    assert [o.assigned_to for o in b.outcomes] == \
        [o.assigned_to for o in a.outcomes]
    for x, y in zip(a.results, b.results):
        assert rows(y) == rows(x)


def report(rep) -> dict:
    return {f: getattr(rep, f) for f in REPORT_FIELDS}


@pytest.mark.parametrize("kind", KINDS)
def test_system_ingest_matches_reference(graph, kind):
    ref, port = build(graph, kind)
    edges_reached = 0
    for text in stream(f"sys_{kind}"):
        want, got = ref.apply_update(text), port.apply_update(text)
        assert report(got) == report(want), text
        edges_reached += got.edges_updated
        check_systems(ref, port, graph)
    assert edges_reached > 0        # the star3 insert reached the edges
    # raw rows through apply_delta: re-add one evicted triple, drop another
    add = np.asarray(ref.cloud.store.triples())[:2].copy()
    add[:, 0] = port.dictionary.entity_id("wA")
    evict = np.asarray(ref.cloud.store.triples())[5:7].copy()
    want = ref.apply_delta(add=add, evict=evict)
    got = port.apply_delta(add=add, evict=evict)
    assert report(got) == report(want)
    check_systems(ref, port, graph)
    assert report(port.apply_delta()) == report(ref.apply_delta())


@pytest.mark.parametrize("kind", KINDS)
def test_system_update_many_matches_reference(graph, kind):
    ref, port = build(graph, kind)
    r_ep, t_ep = REndpoint.from_system(ref), SparqlEndpoint.from_system(port)
    window = WINDOW + stream("win")[1:2]
    want, got = r_ep.update_many(window), t_ep.update_many(window)
    assert all(same(a, b) for a, b in zip(want, got)), (want, got)
    assert t_ep.write_commits == r_ep.write_commits == 3
    check_systems(ref, port, graph)
    # a commit that fails rejects every text of its group, and only those
    for sys_ in (ref, port):
        def boom(*a, **kw):
            raise RuntimeError("commit failed")
        sys_.apply_delta = boom
    window = ["INSERT DATA { <fA> <likes> <Product0> }",
              "INSERT DATA { <fB> <likes> <Product0> }",
              "DELETE WHERE { <wC> <country> ?c }"]
    want, got = r_ep.update_many(window), t_ep.update_many(window)
    assert all(same(a, b) for a, b in zip(want, got))
    assert [type(a).__name__ for a in got[:2]] == ["RuntimeError"] * 2
    assert got[2]["deleted"] == 1
    check_systems(ref, port, graph)
