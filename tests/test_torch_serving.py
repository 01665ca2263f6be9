"""The port's serving front end (``repro_torch.runtime``: admission, HTTP,
the offload pool) re-run on the matrices of ``tests/test_serving_http.py``
on ``device="cpu"``: the torch backend on CPU tensors (the plain versions
of the kernels) and the numpy backend, mono and sharded stores.

Every HTTP body is held to the reference's ``table_to_json`` over the
reference endpoint on the same store (and to the port's own serializer);
admission batches, deadlines, backpressure and the status codes to the
reference's contract; round and pool modes to the endpoint; and
``admit_many``'s assignments and objective to the reference pool's on the
same requests."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from collections import Counter
from urllib.parse import urlencode

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.rdf.dictionary import Dictionary as RDictionary  # noqa: E402
from repro.rdf.graph import TripleStore as RTripleStore  # noqa: E402
from repro.runtime.http import table_to_json as r_table_to_json  # noqa: E402
from repro.runtime import serving as r_serving  # noqa: E402
from repro.sparql.endpoint import SparqlEndpoint as RSparqlEndpoint  # noqa
from repro.rdf.generator import generate_watdiv_like as r_generate  # noqa
from repro.rdf.generator import workload_sparql as r_workload  # noqa: E402

from repro_torch.core.cost import SystemParams  # noqa: E402
from repro_torch.edge.system import EdgeCloudSystem  # noqa: E402
from repro_torch.rdf.deltas import TripleDelta  # noqa: E402
from repro_torch.rdf.dictionary import Dictionary  # noqa: E402
from repro_torch.rdf.generator import (generate_watdiv_like,  # noqa: E402
                                       workload_sparql)
from repro_torch.rdf.graph import TripleStore  # noqa: E402
from repro_torch.rdf.sharding import ShardedTripleStore  # noqa: E402
from repro_torch.runtime.admission import (AdmissionClosed,  # noqa: E402
                                           AdmissionFullError,
                                           AdmissionQueue, DeadlineExceeded)
from repro_torch.runtime.http import (SparqlHttpServer,  # noqa: E402
                                      ask_to_json, table_to_json)
from repro_torch.runtime import serving as t_serving  # noqa: E402
from repro_torch.runtime.serving import (PARTIAL,  # noqa: E402
                                         OffloadServingPool, Replica,
                                         make_sparql_runner)
from repro_torch.sparql.endpoint import SparqlEndpoint  # noqa: E402
from repro_torch.sparql.engine import QueryEngine, TorchBackend  # noqa: E402
from repro_torch.sparql.query import ParseError  # noqa: E402

BACKENDS = ["numpy", "torch"]
KINDS = ["mono", "sharded"]

TRIPLES = [
    ("alice", "knows", "bob"), ("bob", "knows", "carol"),
    ("alice", "knows", "carol"), ("carol", "knows", "dave"),
    ("alice", "likes", "p1"), ("bob", "likes", "p1"),
    ("carol", "likes", "p2"), ("dave", "likes", "p3"),
    ("alice", "city", "paris"), ("bob", "city", "paris"),
    ("carol", "city", "tokyo"),          # dave: no city
]

QUERIES = [
    'SELECT ?a ?b WHERE { ?a <knows> ?b }',
    'SELECT ?a ?c WHERE { ?a <knows> ?b . OPTIONAL { ?b <city> ?c } }',
    'SELECT ?x WHERE { { ?x <likes> <p1> } UNION { ?x <city> <tokyo> } }',
    'SELECT DISTINCT ?c WHERE { ?a <city> ?c } ORDER BY ?c',
    'SELECT ?p WHERE { <alice> ?p ?x }',
]


def build_graph(dict_cls=Dictionary, store_cls=TripleStore):
    """``tests/test_serving_http.py:build_graph`` for either package."""
    d = dict_cls()
    for t in ["alice", "bob", "carol", "dave", "p1", "p2", "p3", "paris",
              "tokyo"]:
        d.add_entity(t)
    for p in ["knows", "likes", "city"]:
        d.add_predicate(p)
    s = np.array([d.entity_id(a) for a, _, _ in TRIPLES])
    p = np.array([d.predicate_id(b) for _, b, _ in TRIPLES])
    o = np.array([d.entity_id(c) for _, _, c in TRIPLES])
    return store_cls(s, p, o, d.num_entities, d.num_predicates), d


def store_of(kind, store):
    return (ShardedTripleStore.from_store(store, 3) if kind == "sharded"
            else store)


def endpoint(store, d, backend="torch", **kw):
    if backend == "torch":
        return SparqlEndpoint(store, d, device="cpu", **kw)
    return SparqlEndpoint(store, d, backend="numpy", **kw)


def table_multiset(table):
    return Counter(table.rows(decoded=True))


def bindings_multiset(payload):
    return Counter(json.dumps(b, sort_keys=True)
                   for b in payload["results"]["bindings"])


def http_get(url, query, **params):
    qs = urlencode({"query": query, **params})
    with urllib.request.urlopen(f"{url}/sparql?{qs}") as r:
        return r.status, json.loads(r.read())


@pytest.fixture()
def graph():
    return build_graph()


@pytest.fixture(scope="module")
def reference_json():
    """The reference endpoint's W3C JSON for every query of the matrix."""
    store, d = build_graph(RDictionary, RTripleStore)
    ep = RSparqlEndpoint(store, d)
    return {t: json.loads(json.dumps(r_table_to_json(ep.query(t))))
            for t in QUERIES}


# ---------------------------------------------------------------------------
# admission queue semantics
# ---------------------------------------------------------------------------


def test_admission_coalesces_concurrent_submissions(graph):
    store, d = graph
    ep = endpoint(store, d)
    texts = QUERIES + QUERIES[:3]
    with AdmissionQueue(ep, window_s=0.25, max_batch=32) as q:
        tickets = [q.submit(t) for t in texts]
        tables = [t.result(timeout=10) for t in tickets]
    ref = endpoint(store, d, "numpy").query_many(texts)
    for got, want in zip(tables, ref):
        assert table_multiset(got) == table_multiset(want)
    assert q.stats.batches == 1
    assert q.stats.max_coalesced == len(texts)
    assert len({t.batch_seq for t in tickets}) == 1
    bs = q.stats.recent[-1]
    assert bs.size == len(texts)
    assert bs.unique_texts == len(QUERIES)
    assert bs.window_fill == pytest.approx(len(texts) / 32)


def test_admission_sequential_degenerate_mode(graph):
    store, d = graph
    ep = endpoint(store, d)
    with AdmissionQueue(ep, window_s=0.0, max_batch=1) as q:
        for t in QUERIES:
            got = q.query(t)
            assert table_multiset(got) == table_multiset(ep.query(t))
    assert q.stats.batches == len(QUERIES)
    assert q.stats.max_coalesced == 1


def test_queue_full_backpressure_and_drain(graph):
    store, d = graph
    ep = endpoint(store, d)
    q = AdmissionQueue(ep, window_s=5.0, max_batch=64, max_queue=2,
                       retry_after_s=0.125)
    t1, t2 = q.submit(QUERIES[0]), q.submit(QUERIES[1])
    with pytest.raises(AdmissionFullError) as exc:
        q.submit(QUERIES[2])
    assert exc.value.retry_after_s == 0.125
    assert q.stats.rejected == 1
    q.close(drain=True)
    assert t1.result(timeout=10).num_matches == \
        ep.query(QUERIES[0]).num_matches
    assert t2.result(timeout=10).num_matches == \
        ep.query(QUERIES[1]).num_matches
    with pytest.raises(AdmissionClosed):
        q.submit(QUERIES[0])


def test_deadline_expired_tickets_dropped_before_dispatch(graph):
    store, d = graph
    ep = endpoint(store, d)
    with AdmissionQueue(ep, window_s=0.3, max_batch=64) as q:
        doomed = q.submit(QUERIES[0], timeout_s=0.01)
        alive = q.submit(QUERIES[1], timeout_s=30.0)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=10)
        assert alive.result(timeout=10).num_matches == \
            ep.query(QUERIES[1]).num_matches
    assert q.stats.expired == 1
    assert q.stats.completed == 1
    assert q.stats.recent[-1].expired == 1


def test_submit_parses_eagerly_without_occupying_queue(graph):
    store, d = graph
    ep = endpoint(store, d)
    with AdmissionQueue(ep, window_s=1.0) as q:
        with pytest.raises(ParseError):
            q.submit("SELECT garbage")
        with pytest.raises(ParseError):
            q.submit("INSERT DATA { <a> }")
        assert q.depth == 0
        assert q.stats.submitted == 0


def test_close_without_drain_rejects_pending(graph):
    store, d = graph
    ep = endpoint(store, d)
    q = AdmissionQueue(ep, window_s=5.0, max_batch=64)
    t = q.submit(QUERIES[0])
    q.close(drain=False)
    with pytest.raises(AdmissionClosed):
        t.result(timeout=10)


def test_admission_mode_validation(graph):
    store, d = graph
    ep = endpoint(store, d)
    with pytest.raises(ValueError):
        AdmissionQueue(ep, mode="round")
    with pytest.raises(ValueError):
        AdmissionQueue(ep, mode="pool")
    with pytest.raises(ValueError):
        AdmissionQueue(ep, mode="warp")


def test_window_reads_see_the_pre_window_store(graph):
    """The write-serialization contract: a window's reads run against the
    pre-window store, then its writes commit in arrival order (coalesced
    into one commit)."""
    store, d = graph
    ep = endpoint(store, d)
    text = 'SELECT ?a ?b WHERE { ?a <knows> ?b }'
    before = ep.query(text).num_matches
    with AdmissionQueue(ep, window_s=0.3, max_batch=64,
                        coalesce_writes=True) as q:
        w1 = q.submit('INSERT DATA { <erin> <knows> <alice> }')
        r1 = q.submit(text)
        w2 = q.submit('INSERT DATA { <frank> <knows> <alice> }')
        r2 = q.submit(text)
        assert r1.result(10).num_matches == before
        assert r2.result(10).num_matches == before
        acks = [w1.result(10), w2.result(10)]
    assert [a["inserted"] for a in acks] == [1, 1]
    assert [a["coalesced"] for a in acks] == [2, 2]
    assert q.stats.write_commits == 1 and q.stats.updates_served == 2
    assert ep.query(text).num_matches == before + 2


# ---------------------------------------------------------------------------
# HTTP layer: JSON parity, W3C shape, status codes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_http_json_parity_with_reference(graph, reference_json, backend,
                                         kind):
    store, d = graph
    ep = endpoint(store_of(kind, store), d, backend)
    with SparqlHttpServer(ep, window_s=0.002) as srv:
        for text in QUERIES:
            status, payload = http_get(srv.url, text)
            assert status == 200
            want = reference_json[text]
            assert payload["head"] == want["head"]
            assert bindings_multiset(payload) == bindings_multiset(want)
            mine = ep.query(text)
            assert payload == table_to_json(mine)
            assert len(payload["results"]["bindings"]) == mine.num_matches


def test_http_post_both_encodings_and_ask(graph):
    store, d = graph
    ep = endpoint(store, d)
    with SparqlHttpServer(ep, window_s=0.002) as srv:
        want = json.loads(json.dumps(table_to_json(ep.query(QUERIES[0]))))
        raw = urllib.request.Request(
            srv.url + "/sparql", data=QUERIES[0].encode(),
            headers={"Content-Type": "application/sparql-query"})
        with urllib.request.urlopen(raw) as r:
            assert r.status == 200 and json.loads(r.read()) == want
        form = urllib.request.Request(
            srv.url + "/sparql",
            data=urlencode({"query": QUERIES[0]}).encode(),
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(form) as r:
            assert r.status == 200 and json.loads(r.read()) == want
        _, yes = http_get(srv.url, 'ASK { ?x <knows> <carol> }')
        assert yes == {"head": {}, "boolean": True}
        _, no = http_get(srv.url, 'ASK { <dave> <city> ?c }')
        assert no == {"head": {}, "boolean": False}
        assert ask_to_json(ep.query(QUERIES[0])) == \
            {"head": {}, "boolean": True}


def test_http_update_routes(graph):
    store, d = graph
    ep = endpoint(store, d)
    with SparqlHttpServer(ep, window_s=0.002) as srv:
        req = urllib.request.Request(
            srv.url + "/sparql", data=b"INSERT DATA { <erin> <city> <rome> }",
            headers={"Content-Type": "application/sparql-update"})
        with urllib.request.urlopen(req) as r:
            ack = json.loads(r.read())
        assert ack["inserted"] == 1 and ack["new_terms"] >= 2
        form = urllib.request.Request(
            srv.url + "/sparql",
            data=urlencode({"update": "DELETE DATA { <erin> <city> <rome> }"}
                           ).encode(),
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(form) as r:
            assert json.loads(r.read())["deleted"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                srv.url + "/sparql", data=b"INSERT DATA { <x> }",
                headers={"Content-Type": "application/sparql-update"}))
        assert e.value.code == 400
        # the separate update endpoint takes the same writes
        req = urllib.request.Request(
            srv.url + "/update", data=b"INSERT DATA { <erin> <city> <oslo> }",
            headers={"Content-Type": "application/sparql-update"})
        with urllib.request.urlopen(req) as r:
            assert json.loads(r.read())["inserted"] == 1
        _, yes = http_get(srv.url, 'ASK { <erin> <city> <oslo> }')
        assert yes["boolean"] is True
        for data, ctype, code in (
                (QUERIES[0].encode(), "application/sparql-query", 415),
                (urlencode({"query": QUERIES[0]}).encode(),
                 "application/x-www-form-urlencoded", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    srv.url + "/update", data=data,
                    headers={"Content-Type": ctype}))
            assert e.value.code == code


def test_http_w3c_shape_unbound_omitted_and_pred_typing(graph):
    store, d = graph
    ep = endpoint(store, d)
    with SparqlHttpServer(ep, window_s=0.002) as srv:
        _, payload = http_get(srv.url, QUERIES[1])
        bindings = payload["results"]["bindings"]
        assert [b for b in bindings if "c" not in b]
        for b in bindings:
            for var, term in b.items():
                assert set(term) == {"type", "value"}
        _, preds = http_get(srv.url, QUERIES[4])
        kinds = {b["p"]["type"] for b in preds["results"]["bindings"]}
        assert kinds == {"uri"}
        vals = {b["p"]["value"] for b in preds["results"]["bindings"]}
        assert vals == {"knows", "likes", "city"}


def test_http_error_codes(graph):
    store, d = graph
    ep = endpoint(store, d)
    with SparqlHttpServer(ep, window_s=0.002) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/sparql")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            http_get(srv.url, "SELECT garbage")
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/nope")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                srv.url + "/sparql", data=b"x",
                headers={"Content-Type": "text/plain"}))
        assert e.value.code == 415
        with pytest.raises(urllib.error.HTTPError) as e:
            http_get(srv.url, QUERIES[0], timeout="banana")
        assert e.value.code == 400
        with urllib.request.urlopen(srv.url + "/healthz") as r:
            assert r.status == 200
        stats = json.loads(
            urllib.request.urlopen(srv.url + "/stats").read())
        assert stats["admission"]["rejected"] == 0
        assert stats["mode"] == "endpoint"


def test_http_503_queue_full_with_retry_after(graph):
    store, d = graph
    ep = endpoint(store, d)
    with SparqlHttpServer(ep, window_s=1.0, max_batch=64,
                          max_queue=1, retry_after_s=0.25) as srv:
        codes = {}

        def first():
            codes["first"] = http_get(srv.url, QUERIES[0])[0]

        t = threading.Thread(target=first)
        t.start()
        wait = threading.Event()
        for _ in range(100):
            if srv.queue.depth == 1:
                break
            wait.wait(0.01)
        assert srv.queue.depth == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            http_get(srv.url, QUERIES[1])
        assert e.value.code == 503
        assert e.value.headers["Retry-After"] == "0.250"
        t.join(15)
        assert codes["first"] == 200


def test_http_504_deadline(graph):
    store, d = graph
    ep = endpoint(store, d)
    with SparqlHttpServer(ep, window_s=0.3, max_batch=64) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            http_get(srv.url, QUERIES[0], timeout="0.01")
        assert e.value.code == 504


def test_http_concurrent_clients_one_batch(graph):
    store, d = graph
    ep = endpoint(store, d)
    texts = QUERIES * 4
    with SparqlHttpServer(ep, window_s=0.25, max_batch=64) as srv:
        out = [None] * len(texts)

        def client(i, t):
            out[i] = http_get(srv.url, t)

        ths = [threading.Thread(target=client, args=(i, t))
               for i, t in enumerate(texts)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(30)
        for (status, payload), text in zip(out, texts):
            assert status == 200
            assert payload == table_to_json(ep.query(text))
        stats = json.loads(
            urllib.request.urlopen(srv.url + "/stats").read())
    assert stats["admission"]["batches"] <= 3
    assert stats["admission"]["max_coalesced"] >= len(QUERIES)
    assert stats["endpoint_memo"]["hits"] >= 1


# ---------------------------------------------------------------------------
# round and pool modes, and placement churn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def watdiv():
    return generate_watdiv_like(scale=0.5, seed=11)


def make_system(g, n_edges=2):
    params = SystemParams.synthetic(n_users=6, n_edges=n_edges, seed=3,
                                    cloud_mbps=0.05, f_ghz=2.0)
    sys_ = EdgeCloudSystem(g.store, g.dictionary, params,
                           storage_budgets=10 ** 9, device="cpu")
    sys_.prepare([workload_sparql(g, 3, seed=100 + n) for n in range(6)])
    return sys_


def oracle(g, texts):
    return {t: table_multiset(r) for t, r in zip(
        texts, endpoint(g.store, g.dictionary, "numpy").query_many(texts))}


@pytest.mark.parametrize("bound", ["marginal", "rqad"])
def test_round_mode_collects_results_and_matches_endpoint(watdiv, bound):
    g = watdiv
    sys_ = make_system(g)
    ep = SparqlEndpoint.from_system(sys_)
    texts = workload_sparql(g, 6, seed=5)
    with AdmissionQueue(ep, window_s=0.2, max_batch=32, mode="round",
                        mode_kw={"policy": "bnb", "bound": bound}) as q:
        tickets = [q.submit(t, user=i % sys_.params.N)
                   for i, t in enumerate(texts)]
        tables = [t.result(timeout=30) for t in tickets]
    want = oracle(g, texts)
    for t, got in zip(texts, tables):
        assert table_multiset(got) == want[t]
    assert q.stats.batches == 1
    assert sum(q.stats.assignment_counts.values()) == len(texts)
    assert q.stats.recent[-1].objective is not None


def test_pool_mode_matches_endpoint(watdiv):
    g = watdiv
    eng = QueryEngine(backend=TorchBackend(device="cpu"))
    runner = make_sparql_runner(g.store, eng)
    pool = OffloadServingPool(
        replicas=[Replica(0, {0}, 2e9, 50e6, runner)],
        cloud_runner=runner)
    ep = SparqlEndpoint(g.store, g.dictionary, engine=eng, pool=pool)
    texts = workload_sparql(g, 6, seed=5)
    with AdmissionQueue(ep, window_s=0.2, max_batch=32, mode="pool",
                        mode_kw={"policy": "greedy"}) as q:
        tables = [t.result(timeout=30) for t in
                  [q.submit(t) for t in texts]]
    want = oracle(g, texts)
    for t, got in zip(texts, tables):
        assert table_multiset(got) == want[t]
    assert q.stats.recent[-1].assignment_counts


def test_round_mode_admission_racing_rebalance_async(watdiv):
    """Concurrent clients against ``rebalance_async``: every admitted
    batch holds the placement-epoch barrier."""
    g = watdiv
    sys_ = make_system(g, n_edges=3)
    ep = SparqlEndpoint.from_system(sys_)
    texts = workload_sparql(g, 8, seed=5)
    ref = oracle(g, texts)
    errors = []
    with AdmissionQueue(ep, window_s=0.01, max_batch=64,
                        mode="round") as q:
        stop = threading.Event()

        def client(seed):
            rng = np.random.default_rng(seed)
            try:
                while not stop.is_set():
                    t = texts[rng.integers(len(texts))]
                    got = q.query(t, user=int(rng.integers(6)))
                    assert table_multiset(got) == ref[t], t
            except Exception as exc:      # pragma: no cover - fail path
                errors.append(exc)

        clients = [threading.Thread(target=client, args=(s,))
                   for s in range(3)]
        for c in clients:
            c.start()
        for _ in range(2):
            sys_.rebalance_async().join(30)
        stop.set()
        for c in clients:
            c.join(30)
    assert not errors, errors[:1]
    assert q.stats.completed > 0 and q.stats.failed == 0


def test_pool_mode_admission_racing_republish(watdiv):
    g = watdiv
    eng = QueryEngine(backend=TorchBackend(device="cpu"))
    runner = make_sparql_runner(g.store, eng)
    pool = OffloadServingPool(
        replicas=[Replica(0, {0}, 2e9, 50e6, runner),
                  Replica(1, {0}, 2e9, 80e6, runner)],
        cloud_runner=runner)
    ep = SparqlEndpoint(g.store, g.dictionary, engine=eng, pool=pool)
    texts = workload_sparql(g, 8, seed=5)
    ref = oracle(g, texts)
    errors = []
    with AdmissionQueue(ep, window_s=0.01, max_batch=64, mode="pool") as q:
        stop = threading.Event()

        def client(seed):
            rng = np.random.default_rng(seed)
            try:
                while not stop.is_set():
                    t = texts[rng.integers(len(texts))]
                    assert table_multiset(q.query(t)) == ref[t], t
            except Exception as exc:      # pragma: no cover - fail path
                errors.append(exc)

        clients = [threading.Thread(target=client, args=(s,))
                   for s in range(3)]
        for c in clients:
            c.start()
        for i in range(30):
            pool.republish(i % 2, {0} if i % 3 else set())
        stop.set()
        for c in clients:
            c.join(30)
    assert not errors, errors[:1]
    assert pool.epoch == 30 and q.stats.failed == 0
    with pytest.raises(KeyError):
        pool.republish(7, {0})


def test_runnerless_replica_reassigned_to_cloud():
    cloud_calls = []

    def cloud_runner(ps):
        cloud_calls.append(len(ps))
        return ["cloud"] * len(ps)

    pool = OffloadServingPool(
        replicas=[Replica(0, {0}, 2e9, 1e8, None)],
        cloud_runner=cloud_runner)
    reqs = [{"class_id": 0, "cycles": 1e6, "result_bits": 8e3,
             "payload": i} for i in range(4)]
    sim = pool.admit(reqs, policy="edge_first", execute=False)
    assert list(sim.assignments) == [0, 0, 0, 0]
    out = pool.admit(reqs, policy="edge_first", execute=True)
    assert list(out.assignments) == [-1, -1, -1, -1]
    assert out.responses == ["cloud"] * 4
    assert cloud_calls == [4]


def _pool_requests():
    rng = np.random.default_rng(4)
    reqs = []
    for i in range(10):
        reqs.append({"class_id": int(i % 3), "cycles": float(
            rng.uniform(1e7, 5e8)), "result_bits": float(
            rng.uniform(1e5, 5e7)), "payload": i})
    # a partial spec on a class no replica serves whole, heavy at the
    # (congested) cloud
    reqs[2]["class_id"] = 9
    reqs[2]["cycles"] = 5e9
    reqs[2]["partial"] = {"replicas": [0, 1], "cycles": [1e6, 2e6],
                          "ship_bits": [1e4, 2e4],
                          "assemble_cycles": 1e5,
                          "payloads": {0: "a", 1: "b"},
                          "assemble": lambda subs: "+".join(subs)}
    return reqs


def _replicas(mod, runner):
    return [mod.Replica(0, {0, 1}, 2e8, 75e6, runner),
            mod.Replica(1, {1, 2}, 4e8, 75e6, runner)]


@pytest.mark.parametrize("policy,kw", [("bnb", {}), ("greedy", {}),
                                       ("edge_first", {}),
                                       ("bnb", {"bound": "rqad"})])
def test_pool_admit_matches_reference(policy, kw):
    """Assignments, objective and responses equal the reference pool's on
    the same requests, partial plans and thread overlap included."""
    def runner(ps):
        return [f"r{p}" for p in ps]

    ref = r_serving.OffloadServingPool(_replicas(r_serving, runner), runner,
                                       cloud_cycles_per_s=5e7)
    port = t_serving.OffloadServingPool(_replicas(t_serving, runner), runner,
                                       cloud_cycles_per_s=5e7)
    pkw = dict(kw, device="cpu") if kw.get("bound") == "rqad" else kw
    want = ref.admit(_pool_requests(), policy=policy, **kw)
    got = port.admit(_pool_requests(), policy=policy, overlap=True, **pkw)
    assert np.array_equal(got.assignments, want.assignments)
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert got.responses == want.responses
    assert (got.partial_queries, got.partial_bytes_shipped) == \
        (want.partial_queries, want.partial_bytes_shipped)
    if policy == "bnb":
        assert (got.assignments == PARTIAL).any()


def test_admit_many_matches_reference_pool(watdiv):
    """``admit_many`` on the same texts: the port's cost estimates feed
    the same schedule as the reference's."""
    g = watdiv
    rg = r_generate(scale=0.5, seed=11)
    texts = workload_sparql(g, 8, seed=5)
    assert texts == r_workload(rg, 8, seed=5)

    def classes(plan):
        return len(plan.bgp_leaves()) % 2

    eng = QueryEngine(backend=TorchBackend(device="cpu"))
    runner = make_sparql_runner(g.store, eng)
    port = OffloadServingPool(
        [Replica(0, {0}, 2e8, 75e6, runner),
         Replica(1, {0, 1}, 4e8, 75e6, runner)], runner)
    ep = SparqlEndpoint(g.store, g.dictionary, engine=eng, pool=port)
    rrunner = r_serving.make_sparql_runner(rg.store, None)
    ref = r_serving.OffloadServingPool(
        [r_serving.Replica(0, {0}, 2e8, 75e6, rrunner),
         r_serving.Replica(1, {0, 1}, 4e8, 75e6, rrunner)], rrunner)
    rep = RSparqlEndpoint(rg.store, rg.dictionary, pool=ref)
    for policy in ("bnb", "greedy"):
        got = ep.admit_many(texts, class_of=classes, policy=policy)
        want = rep.admit_many(texts, class_of=classes, policy=policy,
                              execute=False)
        assert np.array_equal(got.assignments, want.assignments)
        assert got.objective == pytest.approx(want.objective, rel=1e-12)
        ref_tables = oracle(g, texts)
        for t, table in zip(texts, got.responses):
            assert table_multiset(table) == ref_tables[t]
    with pytest.raises(ValueError):
        endpoint(g.store, g.dictionary).admit_many(texts)


# ---------------------------------------------------------------------------
# the endpoint's memos under live ingest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_plan_memo_invalidated_by_dictionary_growth(graph, kind):
    store, d = graph
    st = store_of(kind, store)
    ep = endpoint(st, d)
    text = ('SELECT ?x WHERE { ?x <likes> ?prod . '
            'FILTER (?prod = "pnew") }')
    assert ep.query(text).num_matches == 0
    pid = d.add_entity("pnew")
    row = np.array([[d.entity_id("alice"), d.predicate_id("likes"), pid]])
    st.apply_delta(TripleDelta(base_version=st.version, add=row))
    got = ep.query(text)
    assert got.num_matches == 1
    assert got.rows(decoded=True) == [("alice",)]


def test_plan_memo_still_memoizes_within_a_version(graph):
    store, d = graph
    ep = endpoint(store, d)
    assert ep.parse(QUERIES[0]) is ep.parse(QUERIES[0])
    v = d.version
    d.add_entity("alice")
    assert d.version == v
    assert ep.parse(QUERIES[0]) is ep.parse(QUERIES[0])


def test_midbatch_version_move_skips_result_caching(graph, monkeypatch):
    import repro_torch.sparql.endpoint as ep_mod
    store, d = graph
    ep = endpoint(store, d)
    text = QUERIES[0]
    real = ep_mod.evaluate_many

    def racing(plans, st, engine):
        row = st.triples()[:1]
        st.apply_delta(TripleDelta(base_version=st.version,
                                   add=row, evict=row))
        return real(plans, st, engine)

    monkeypatch.setattr(ep_mod, "evaluate_many", racing)
    v_old = store.version
    got = ep.query(text)
    assert got.num_matches == 4
    assert (text, v_old) not in ep._results
    assert not any(k[0] == text for k in ep._results)
    monkeypatch.setattr(ep_mod, "evaluate_many", real)
    ep.query(text)
    assert (text, store.version) in ep._results


# ---------------------------------------------------------------------------
# the serve phase of chip_smoke.py, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_serve_phase_on_cpu():
    """The serve phase's seven checks, each with its planted fault, at
    scale 1 on the CPU (the plain versions; no launches, no timing row)."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke as smoke
    finally:
        sys.path.remove(str(root))
    gen = generate_watdiv_like(scale=1.0, seed=0)
    small = generate_watdiv_like(scale=1.0, seed=1)
    kept_a, kept_b = {}, {}
    smoke.system_phase(gen, gen.store, "cpu", 200_000, keep=kept_a)
    smoke.ingest_phase(small, ShardedTripleStore.from_store(small.store, 4),
                       "cpu", 200_000, keep=kept_b)
    info, row = smoke.serve_phase(gen, small, kept_a, kept_b, "cpu",
                                  200_000, 3.35e12)
    assert row is None and info["launches"] == {}
    assert all(c["ok"] for c in info["qad"]["cases"])
    assert not info["qad"]["planted"]["ok"]
    assert info["bnb"]["nodes_explored"]["rqad"] <= \
        info["bnb"]["nodes_explored"]["marginal"]
    assert info["http_pool"]["batches"] < info["http_pool"]["submitted"]
    assert all(w["optimal"] for w in info["http_round"]["windows"])
    ww = info["write_window"]
    assert ww["rows_after"] == ww["rows_before"] + 2
    assert info["workload"]["verified"] == info["workload"]["completed"]
