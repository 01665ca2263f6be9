"""The port's workload harness (``repro_torch.workload``) re-run on the
matrix of ``tests/test_workload.py``: for the same seeds the sampled texts,
their cardinalities and the schedules equal the reference's; the port's
engines (torch on CPU tensors, numpy; mono and sharded) answer every
sampled query with its recorded cardinality; replay through the port's
``AdmissionQueue`` verifies every answer, under a churn write mix with
coalesced writes too."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.rdf.generator import generate_watdiv_like as r_generate  # noqa
from repro.workload import PatternSampler as RSampler  # noqa: E402
from repro.workload import ShapeConfig as RShape  # noqa: E402
from repro.workload import TrafficConfig as RTraffic  # noqa: E402
from repro.workload import build_schedule as r_build  # noqa: E402

from repro_torch.rdf.dictionary import Dictionary  # noqa: E402
from repro_torch.rdf.generator import generate_watdiv_like  # noqa: E402
from repro_torch.rdf.graph import TripleStore  # noqa: E402
from repro_torch.rdf.sharding import ShardedTripleStore  # noqa: E402
from repro_torch.runtime.admission import AdmissionQueue  # noqa: E402
from repro_torch.sparql.algebra import compile_query, evaluate_plan  # noqa
from repro_torch.sparql.endpoint import SparqlEndpoint  # noqa: E402
from repro_torch.sparql.engine import QueryEngine, TorchBackend  # noqa: E402
from repro_torch.sparql.query import parse_query  # noqa: E402
from repro_torch.workload import (PatternSampler, SampledQuery,  # noqa: E402
                                  Schedule, ScheduledEvent, ShapeConfig,
                                  TrafficConfig, build_schedule, replay)
from repro_torch.workload.sampler import SHAPES  # noqa: E402

KINDS = ["mono", "sharded"]
BACKENDS = ["numpy", "torch"]


@pytest.fixture(scope="module")
def graphs():
    g = generate_watdiv_like(scale=0.4, seed=13)
    rg = r_generate(scale=0.4, seed=13)
    assert np.array_equal(g.store.triples(), rg.store.triples())
    return g, rg


def make_store(store, kind):
    if kind == "mono":
        return store
    return ShardedTripleStore(store.s, store.p, store.o,
                              store.num_entities, store.num_predicates,
                              num_shards=3)


def engine_of(backend):
    return QueryEngine(backend=TorchBackend(device="cpu")
                       if backend == "torch" else "numpy")


def endpoint(g):
    return SparqlEndpoint(g.store, g.dictionary, device="cpu")


def ref_count(store, patterns) -> int:
    """Independent pure-Python backtracking count
    (``tests/test_workload.py:ref_count``)."""
    by_sp: dict[tuple, list] = {}
    by_p: dict[int, list] = {}
    for s, p, o in store.triples().tolist():
        by_sp.setdefault((s, p), []).append(o)
        by_p.setdefault(p, []).append((s, o))

    def extend(i: int, env: dict) -> int:
        if i == len(patterns):
            return 1
        sv, pid, ov = patterns[i]
        s_bound = env.get(sv, sv) if isinstance(sv, str) else sv
        o_bound = env.get(ov, ov) if isinstance(ov, str) else ov
        if not isinstance(s_bound, str):
            pairs = [(s_bound, o) for o in by_sp.get((s_bound, pid), [])]
        else:
            pairs = by_p.get(pid, [])
        total = 0
        for s, o in pairs:
            if not isinstance(o_bound, str) and o != o_bound:
                continue
            child = dict(env)
            if isinstance(sv, str):
                child[sv] = s
            if isinstance(ov, str):
                child[ov] = o
            total += extend(i + 1, child)
        return total

    return extend(0, {})


def key(queries):
    return [(q.name, q.shape, q.text, q.cardinality, q.n_patterns,
             q.n_consts, q.pids, q.decoration) for q in queries]


# ---------------------------------------------------------------------------
# the sampler against the reference and against the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,const_frac,decorations",
                         [(21, 0.4, ()),
                          (22, 0.3, ("filter", "optional", "union", "values",
                                     "limit")),
                          (7, 0.5, ("filter", "limit"))])
def test_sampled_queries_equal_reference(graphs, seed, const_frac,
                                         decorations):
    g, rg = graphs
    cfgs = [ShapeConfig(s, size=3, const_frac=const_frac,
                        decorations=decorations) for s in SHAPES]
    rcfgs = [RShape(s, size=3, const_frac=const_frac,
                    decorations=decorations) for s in SHAPES]
    got = PatternSampler(g.store, g.dictionary, seed=seed).sample_mix(cfgs, 3)
    want = RSampler(rg.store, rg.dictionary, seed=seed).sample_mix(rcfgs, 3)
    assert key(got) == key(want)
    assert {q.shape for q in got} == set(SHAPES)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_undecorated_shapes_match_reference_count(graphs, backend, kind):
    g, _ = graphs
    d = g.dictionary
    queries = PatternSampler(g.store, d, seed=21).sample_mix(
        [ShapeConfig(s, size=3, const_frac=0.4) for s in SHAPES], 3)
    target = make_store(g.store, kind)
    engine = engine_of(backend)
    for q in queries:
        root = compile_query(parse_query(q.text, d), d)
        (leaf,) = root.bgp_leaves()
        pats = [(tp.s, tp.p, tp.o) for tp in leaf.patterns]
        expected = ref_count(g.store, pats)
        assert q.cardinality == expected >= 1, q.text
        assert len(evaluate_plan(root, target, engine)) == expected


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_decorated_shapes_cross_impl_parity(graphs, backend, kind):
    g, _ = graphs
    d = g.dictionary
    queries = PatternSampler(g.store, d, seed=22).sample_mix(
        [ShapeConfig(s, size=3, const_frac=0.3,
                     decorations=("filter", "optional", "union", "values",
                                  "limit")) for s in SHAPES], 3)
    assert len({q.decoration for q in queries}) >= 3
    target = make_store(g.store, kind)
    engine = engine_of(backend)
    for q in queries:
        root = compile_query(parse_query(q.text, d), d)
        assert len(evaluate_plan(root, target, engine)) == q.cardinality


def test_recorded_metadata(graphs):
    g, _ = graphs
    d = g.dictionary
    smp = PatternSampler(g.store, d, seed=23, exclude_predicates=["country"])
    excluded = d.predicate_id("country")
    for q in smp.sample_mix([ShapeConfig(s, size=3) for s in SHAPES], 4):
        assert isinstance(q, SampledQuery)
        assert q.store_version == g.store.version
        assert q.n_patterns >= 2 and q.pids and excluded not in q.pids
        root = compile_query(parse_query(q.text, d), d)
        used = {tp.p for leaf in root.bgp_leaves() for tp in leaf.patterns}
        assert used == set(q.pids)


def test_sampler_empty_and_tiny_stores():
    d = Dictionary()
    z = np.zeros(0, dtype=np.int64)
    assert PatternSampler(TripleStore(z, z, z, 0, 0), d, seed=1).sample(
        ShapeConfig("star"), 4) == []
    for t in ("a", "b", "c"):
        d.add_entity(t)
    pid = d.add_predicate("edge")
    tiny = TripleStore(np.array([0, 1]), np.array([pid, pid]),
                       np.array([1, 2]), d.num_entities, 1)
    smp = PatternSampler(tiny, d, seed=1, max_attempts=8)
    for shape in SHAPES:
        for q in smp.sample(ShapeConfig(shape, size=3), 4):
            assert q.cardinality >= 1
    assert smp.sample(ShapeConfig("path", size=2), 2)


def test_shape_and_traffic_config_validation():
    with pytest.raises(ValueError):
        ShapeConfig("triangle")
    with pytest.raises(ValueError):
        ShapeConfig("star", size=0)
    with pytest.raises(ValueError):
        ShapeConfig("star", const_frac=1.5)
    with pytest.raises(ValueError):
        ShapeConfig("star", decorations=("sparkle",))
    with pytest.raises(ValueError):
        TrafficConfig(arrival="uniformish")
    with pytest.raises(ValueError):
        TrafficConfig(qps=0)


# ---------------------------------------------------------------------------
# the traffic model against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def templates(graphs):
    g, rg = graphs
    cfgs = [ShapeConfig(s, size=3) for s in SHAPES]
    got = PatternSampler(g.store, g.dictionary, seed=31,
                         exclude_predicates=["country"]).sample_mix(cfgs, 4)
    want = RSampler(rg.store, rg.dictionary, seed=31,
                    exclude_predicates=["country"]).sample_mix(
        [RShape(s, size=3) for s in SHAPES], 4)
    assert key(got) == key(want) and len(got) >= 12
    return got, want


def events(sched):
    return [(e.at_s, e.kind, e.text, e.template, e.shape, e.cardinality,
             e.cold) for e in sched.events]


TRAFFIC = [dict(duration_s=0.5, qps=400, cold_fraction=0.2, zipf_s=1.2,
                seed=5),
           dict(duration_s=1.0, qps=200, arrival="burst", seed=9),
           dict(duration_s=2.0, qps=300, arrival="burst", burst_factor=2.0,
                seed=9),
           dict(duration_s=0.5, qps=300, write_fraction=0.3,
                write_style="churn", seed=4),
           dict(duration_s=0.5, qps=300, write_fraction=0.3,
                write_style="touch", seed=4)]


@pytest.mark.parametrize("cfg", TRAFFIC)
def test_schedules_equal_reference(graphs, templates, cfg):
    g, rg = graphs
    got_t, want_t = templates
    kw = ({"churn_predicate": "country"}
          if cfg.get("write_style") == "churn" else {})
    rkw = dict(kw)
    if cfg.get("write_style") == "touch":
        kw = {"store": g.store, "dictionary": g.dictionary}
        rkw = {"store": rg.store, "dictionary": rg.dictionary}
    got = build_schedule(got_t, TrafficConfig(**cfg), **kw)
    want = r_build(want_t, RTraffic(**cfg), **rkw)
    assert events(got) == events(want)
    assert (got.n_queries, got.n_updates, got.verifiable) == \
        (want.n_queries, want.n_updates, want.verifiable)
    assert got.template_counts() == want.template_counts()


def test_zipf_skew_and_cold_reserve(templates):
    sched = build_schedule(templates[0], TrafficConfig(
        duration_s=2.0, qps=500, cold_fraction=0.2, zipf_s=1.4, seed=8))
    counts = sched.template_counts()
    ranked = sorted(counts.values(), reverse=True)
    assert ranked[0] >= 3 * max(1, ranked[len(ranked) // 2])
    cold_uses = Counter(e.template for e in sched.events if e.cold)
    assert cold_uses and all(n == 1 for n in cold_uses.values())


def test_write_config_validation(templates):
    with pytest.raises(ValueError):
        build_schedule(templates[0], TrafficConfig(write_fraction=0.5))
    with pytest.raises(ValueError):
        build_schedule(templates[0], TrafficConfig(
            write_fraction=0.5, write_style="touch"))
    with pytest.raises(ValueError):
        build_schedule([], TrafficConfig())


# ---------------------------------------------------------------------------
# replay through the port's admission queue
# ---------------------------------------------------------------------------


def test_replay_read_only_verifies_every_answer(graphs, templates):
    g, _ = graphs
    sched = build_schedule(templates[0], TrafficConfig(
        duration_s=0.3, qps=250, cold_fraction=0.15, seed=12))
    with AdmissionQueue(endpoint(g), window_s=0.004, max_batch=32) as q:
        rep = replay(q, sched, speed=2.0)
    assert rep.completed == rep.n_events == len(sched.events)
    assert rep.errors == 0 and rep.verification_ok
    assert rep.verified == sched.n_queries
    assert set(rep.per_shape) <= set(SHAPES)
    assert rep.cache_trajectory
    p = rep.per_temperature
    assert p["cold"].count + p["warm"].count == sched.n_queries
    assert rep.as_dict()["admission"]["completed"] >= rep.completed


def test_replay_trajectory_spans_all_batches(graphs, templates):
    g, _ = graphs
    q0 = templates[0][0]
    evs = [ScheduledEvent(at_s=0.0, kind="query", text=q0.text,
                          template=q0.name, shape=q0.shape,
                          cardinality=q0.cardinality) for _ in range(80)]
    sched = Schedule(events=evs, config=TrafficConfig(), templates=[q0])
    with AdmissionQueue(endpoint(g), window_s=0.0, max_batch=1) as q:
        q.query(q0.text)
        rep = replay(q, sched, speed=1000.0)
    assert rep.completed == 80 and rep.errors == 0
    assert len(q.stats.recent) <= 64
    assert len(rep.cache_trajectory) == 80
    seqs = [b["seq"] for b in rep.cache_trajectory]
    assert seqs == sorted(seqs) and seqs[0] >= 1


def test_replay_stays_interruptible():
    class FakeTicket:
        def done(self):
            return True

        def result(self, timeout=None):
            raise KeyboardInterrupt

    class FakeStats:
        recent: list = []
        assignment_counts: dict = {}

        def as_dict(self):
            return {}

    class FakeQueue:
        stats = FakeStats()

        def submit(self, text):
            return FakeTicket()

    q0 = SampledQuery(name="t0", shape="star", text="SELECT * WHERE {}",
                      cardinality=1, n_patterns=1, n_consts=0, pids=(0,),
                      decoration=None, store_version=0)
    sched = Schedule(events=[ScheduledEvent(
        at_s=0.0, kind="query", text=q0.text, template=q0.name,
        shape=q0.shape, cardinality=q0.cardinality)],
        config=TrafficConfig(), templates=[q0])
    with pytest.raises(KeyboardInterrupt):
        replay(FakeQueue(), sched, speed=1000.0)


def test_replay_churn_mix_stays_verified_with_coalescing(templates):
    g = generate_watdiv_like(scale=0.4, seed=13)     # writes mutate it
    sched = build_schedule(templates[0], TrafficConfig(
        duration_s=0.3, qps=250, write_fraction=0.25, write_style="churn",
        arrival="burst", seed=13), churn_predicate="country")
    with AdmissionQueue(endpoint(g), window_s=0.004, max_batch=32,
                        coalesce_writes=True) as q:
        rep = replay(q, sched, speed=2.0)
    assert rep.errors == 0
    assert rep.writes.count == sched.n_updates > 0
    assert rep.verification_ok and rep.verified == sched.n_queries
    assert rep.admission["updates_served"] == sched.n_updates
    assert rep.admission["write_commits"] <= sched.n_updates
