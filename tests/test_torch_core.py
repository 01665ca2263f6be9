"""The port's ``repro_torch.core`` against the reference's ``repro.core``
on the same inputs: pattern keys and the pattern index, induced edge ids,
the knapsack's choices, ``SystemParams.synthetic`` and the cost estimates
(all exact), and the schedulers (B&B with the marginal bound, the four
baselines, CRA) on seeded random instances: assignments exact,
objectives within rtol 1e-12. ``bound="rqad"`` is held to the reference in
``tests/test_torch_qad.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import baselines as r_base  # noqa: E402
from repro.core import bnb as r_bnb  # noqa: E402
from repro.core import cost as r_cost  # noqa: E402
from repro.core import cra as r_cra  # noqa: E402
from repro.core import induced as r_ind  # noqa: E402
from repro.core import pattern as r_pat  # noqa: E402
from repro.core import placement as r_place  # noqa: E402
from repro.core import scheduler as r_sched  # noqa: E402
from repro.rdf.generator import generate_watdiv_like  # noqa: E402
from repro.rdf.generator import workload_sparql  # noqa: E402
from repro.rdf.sharding import ShardedTripleStore as RSharded  # noqa: E402
from repro.sparql.algebra import compile_query as r_compile  # noqa: E402
from repro.sparql.query import parse_query as r_parse  # noqa: E402

from repro_torch.convert import (from_reference,  # noqa: E402
                                 system_params_from_reference)
from repro_torch.core import baselines as t_base  # noqa: E402
from repro_torch.core import bnb as t_bnb  # noqa: E402
from repro_torch.core import cost as t_cost  # noqa: E402
from repro_torch.core import cra as t_cra  # noqa: E402
from repro_torch.core import induced as t_ind  # noqa: E402
from repro_torch.core import pattern as t_pat  # noqa: E402
from repro_torch.core import placement as t_place  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.sparql.algebra import compile_query as t_compile  # noqa: E402
from repro_torch.sparql.query import parse_query as t_parse  # noqa: E402

TEMPLATES = ["star2", "star3", "chain2", "chain3", "snowflake", "complex",
             "anchored_star", "anchored_chain"]
ALGEBRA = [
    "SELECT ?x ?g WHERE { ?x <likes> ?p . OPTIONAL { ?p <hasGenre> ?g } }",
    "SELECT ?x ?y WHERE { { ?x <follows> ?y } UNION { ?x <likes> ?y } } "
    "LIMIT 50",
    "SELECT DISTINCT ?c WHERE { ?u <country> ?c } ORDER BY ?c",
    "ASK { ?x <subgenreOf> ?y }",
    "SELECT ?x ?pp ?y WHERE { ?x ?pp ?y . ?y ?pp ?z }",
    "SELECT ?x ?y WHERE { ?x <follows> ?y . ?y <follows> ?x }",
]
POLICIES = ["cloud_only", "random", "edge_first", "greedy", "bnb"]


@pytest.fixture(scope="module")
def graphs():
    g = generate_watdiv_like(scale=1.0, seed=42)
    sharded = RSharded.from_store(g.store, 4)
    mono, d = from_reference(g.store.to_arrays(), g.dictionary.to_arrays())
    tsharded, _ = from_reference(sharded.to_arrays(),
                                 g.dictionary.to_arrays())
    return {"g": g, "ref": {"mono": g.store, "sharded": sharded},
            "port": {"mono": mono, "sharded": tsharded}, "dict": d}


def _plans(g, d, texts):
    ref = [r_compile(r_parse(t, g.dictionary), g.dictionary) for t in texts]
    port = [t_compile(t_parse(t, d), d) for t in texts]
    return ref, port


def _keys(pats):
    return None if pats is None else [(p.key, p.indexable) for p in pats]


def _texts(g, template):
    return workload_sparql(g, 4, seed=7, templates=[template])


@pytest.mark.parametrize("template", TEMPLATES + ["algebra"])
def test_pattern_keys_match_reference(graphs, template):
    g, d = graphs["g"], graphs["dict"]
    texts = ALGEBRA if template == "algebra" else _texts(g, template)
    ref, port = _plans(g, d, texts)
    for a, b in zip(ref, port):
        assert _keys(t_pat.observed_patterns(b)) == \
            _keys(r_pat.observed_patterns(a))
        assert _keys(t_pat.feasibility_patterns(b)) == \
            _keys(r_pat.feasibility_patterns(a))
        for la, lb in zip(a.bgp_leaves(), b.bgp_leaves()):
            if la.query.patterns:
                pa, pb = r_pat.pattern_of(la.query), t_pat.pattern_of(lb.query)
                assert (pb.edges, pb.n_vertices, pb.key, pb.indexable) == \
                    (pa.edges, pa.n_vertices, pa.key, pa.indexable)


def test_pattern_index_lookups_match_reference(graphs):
    g, d = graphs["g"], graphs["dict"]
    texts = sum((_texts(g, t) for t in TEMPLATES), []) + ALGEBRA
    ref, port = _plans(g, d, texts)
    r_idx, t_idx = r_pat.PatternIndex(), t_pat.PatternIndex()
    for i, (a, b) in enumerate(zip(ref, port)):
        for pa, pb in zip(r_pat.observed_patterns(a),
                          t_pat.observed_patterns(b)):
            if i % 3 and pa.indexable:
                r_idx.add(pa, i % 4)
                t_idx.add(pb, i % 4)
    assert len(t_idx) == len(r_idx)
    for a, b in zip(ref, port):
        for pa, pb in zip(r_pat.observed_patterns(a),
                          t_pat.observed_patterns(b)):
            assert sorted(t_idx.lookup(pb)) == sorted(r_idx.lookup(pa))


def _patterns(g, d, templates=TEMPLATES[:5] + TEMPLATES[6:]):
    texts = sum((_texts(g, t)[:2] for t in templates), [])
    ref, port = _plans(g, d, texts)
    rp = [p for a in ref for p in r_pat.observed_patterns(a)]
    tp = [p for b in port for p in t_pat.observed_patterns(b)]
    return rp, tp


@pytest.mark.parametrize("kind", ["mono", "sharded"])
def test_induced_edge_ids_match_reference(graphs, kind):
    g, d = graphs["g"], graphs["dict"]
    rs, ts = graphs["ref"][kind], graphs["port"][kind]
    rp, tp = _patterns(g, d)
    r_ind_, t_ind_ = r_ind.InducedIndex(), t_ind.InducedIndex()
    for a, b in zip(rp, tp):
        want = r_ind_.edge_ids(rs, a)
        got = t_ind_.edge_ids(ts, b)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(t_ind_.union_edge_ids(ts, tp),
                          r_ind_.union_edge_ids(rs, rp))
    assert (t_ind_.hits, t_ind_.misses) == (r_ind_.hits, r_ind_.misses)
    # the memo: a second lookup runs no matcher
    t_ind_.edge_ids(ts, tp[0])
    assert t_ind_.misses == r_ind_.misses
    assert t_ind.reship_bytes(ts, tp[:3]) == r_ind.reship_bytes(rs, rp[:3])


@pytest.mark.parametrize("budget_share", [0.05, 0.2, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["mono", "sharded"])
def test_greedy_knapsack_matches_reference(graphs, kind, budget_share):
    g, d = graphs["g"], graphs["dict"]
    rs, ts = graphs["ref"][kind], graphs["port"][kind]
    rp, tp = _patterns(g, d)
    rng = np.random.default_rng(5)
    freq = rng.integers(1, 9, len(rp)).astype(float)
    r_prof, t_prof = [], []
    for f, a, b in zip(freq, rp, tp):
        eids = r_ind.induced_edge_ids(rs, [a])
        split = None
        if kind == "sharded":
            from repro.edge.server import EdgeServer
            split = EdgeServer._shard_split(rs, eids)
        nbytes = 24 * len(eids)
        r_prof.append(r_place.PatternProfile(a, f, nbytes, split))
        t_prof.append(t_place.PatternProfile(b, f, nbytes, split))
    total = sum(p.size_bytes for p in r_prof)
    budget = int(budget_share * total)
    shard_budgets = (np.full(4, budget // 3) if kind == "sharded" else None)
    assert t_place.greedy_knapsack(t_prof, budget, shard_budgets) == \
        r_place.greedy_knapsack(r_prof, budget, shard_budgets)


def test_dynamic_placement_matches_reference(graphs):
    g, d = graphs["g"], graphs["dict"]
    rp, tp = _patterns(g, d)
    ref = r_place.DynamicPlacement(budget_bytes=20_000)
    port = t_place.DynamicPlacement(budget_bytes=20_000)
    rng = np.random.default_rng(2)
    for step in range(6):
        for i in rng.integers(0, len(rp), 5):
            ref.observe(rp[i])
            port.observe(tp[i])
            ref.set_size(rp[i], int(1000 * (i + 1)))
            port.set_size(tp[i], int(1000 * (i + 1)))
        assert port.plan() == ref.plan()
        r_add, r_ev = ref.rebalance()
        t_add, t_ev = port.rebalance()
        assert [p.key for p in t_add] == [p.key for p in r_add]
        assert [p.key for p in t_ev] == [p.key for p in r_ev]
        ref.decay_round()
        port.decay_round()
        assert port.used_bytes() == ref.used_bytes()


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shape", [(20, 4), (7, 3), (50, 6)])
def test_synthetic_params_match_reference(seed, shape):
    n, k = shape
    ref = r_cost.SystemParams.synthetic(n, k, seed=seed)
    port = t_cost.SystemParams.synthetic(n, k, seed=seed)
    carried = system_params_from_reference(ref)
    for p in (port, carried):
        for name in ("F", "r_edge", "r_cloud", "assoc", "r_backhaul"):
            assert np.array_equal(getattr(p, name), getattr(ref, name))
        assert p.F_cloud == ref.F_cloud and p.N == ref.N and p.K == ref.K
        assert np.array_equal(p.backhaul, ref.backhaul)
    finite = r_cost.SystemParams.synthetic(n, k, seed=seed, cloud_ghz=2.0)
    assert system_params_from_reference(finite).F_cloud == finite.F_cloud


@pytest.mark.parametrize("kind", ["mono", "sharded"])
def test_cost_estimates_match_reference(graphs, kind):
    g, d = graphs["g"], graphs["dict"]
    rs, ts = graphs["ref"][kind], graphs["port"][kind]
    texts = sum((_texts(g, t) for t in TEMPLATES), []) + ALGEBRA
    ref, port = _plans(g, d, texts)
    for a, b in zip(ref, port):
        assert t_cost.estimate_query_cost(ts, b) == \
            r_cost.estimate_query_cost(rs, a)
    for rows, secs in ((0, 0.0), (1234, 0.0), (1234, 0.002), (10 ** 7, 1.5)):
        assert t_cost.measured_cycles(rows, secs) == \
            r_cost.measured_cycles(rows, secs)
    res = r_ind.match_bgp(rs, ref[0].bgp_leaves()[0].query)
    assert t_cost.result_bits(res, ["?x"]) == r_cost.result_bits(res, ["?x"])


def _instance(mod, N, K, seed, partial_every=0):
    """A seeded random instance (the reference's scheduler-test recipe),
    optionally with partial options on every ``partial_every``-th row."""
    rng = np.random.default_rng(seed)
    params = mod.SystemParams.synthetic(N, K, seed=seed)
    params.F_cloud = 0.05e9 if partial_every else np.inf
    c = rng.uniform(1e7, 5e8, N)
    w = rng.uniform(1e5, 5e7, N)
    e = (rng.random((N, K)) < 0.7).astype(float) * params.assoc
    partial = None
    if partial_every:
        partial = [None] * N
        for n in range(0, N, partial_every):
            e[n] = 0.0          # as the system plans them: no whole edge
            m = int(rng.integers(1, K + 1))
            edges = np.sort(rng.choice(K, size=m, replace=False))
            partial[n] = mod.PartialOption(
                edges=edges, cycles=rng.uniform(1e5, 1e6, m),
                ship_bits=rng.uniform(1e5, 2e7, m),
                assemble_cycles=float(rng.uniform(1e6, 5e7)))
    return mod.QueryTasks(c=c, w=w, e=e, partial=partial), params


BINARY = [(20, 4, 0, 0), (12, 3, 1, 0), (16, 5, 2, 0)]
THREE_WAY = [(16, 4, 3, 3), (10, 2, 4, 2)]   # partial options on some rows


@pytest.mark.parametrize("policy,case",
                         [(p, c) for p in POLICIES for c in BINARY]
                         + [("bnb", c) for c in THREE_WAY])
def test_schedules_match_reference(policy, case):
    N, K, seed, partial_every = case
    r_tasks, r_params = _instance(r_cost, N, K, seed, partial_every)
    t_tasks, t_params = _instance(t_cost, N, K, seed, partial_every)
    want = r_sched.schedule(r_tasks, r_params, policy=policy)
    got = t_sched.schedule(t_tasks, t_params, policy=policy)
    assert np.array_equal(got.D, want.D)
    assert np.allclose(got.f, want.f, rtol=1e-12, atol=0)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    if policy == "bnb":
        assert np.array_equal(got.partial, want.partial)
        for key in ("nodes_explored", "nodes_pruned", "optimal"):
            assert got.info[key] == want.info[key]
        if partial_every:
            assert got.partial.any()


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_bnb_variants_and_brute_force_match_reference(seed):
    r_tasks, r_params = _instance(r_cost, 6, 3, seed, partial_every=2)
    t_tasks, t_params = _instance(t_cost, 6, 3, seed, partial_every=2)
    for kw in ({}, {"strategy": "best_first"}, {"order": "index"},
               {"warm_start": "cloud"}, {"max_nodes": 3}):
        want = r_bnb.branch_and_bound(r_tasks, r_params, **kw)
        got = t_bnb.branch_and_bound(t_tasks, t_params, **kw)
        assert np.array_equal(got.D, want.D), kw
        assert np.array_equal(got.partial, want.partial), kw
        assert got.objective == pytest.approx(want.objective, rel=1e-12)
        assert (got.nodes_explored, got.optimal) == \
            (want.nodes_explored, want.optimal)
    want = r_bnb.brute_force(r_tasks, r_params)
    got = t_bnb.brute_force(t_tasks, t_params)
    assert np.array_equal(got.D, want.D)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)


@pytest.mark.parametrize("seed", [0, 3])
def test_cra_and_costs_match_reference(seed):
    r_tasks, r_params = _instance(r_cost, 15, 4, seed)
    t_tasks, t_params = _instance(t_cost, 15, 4, seed)
    for name in ("cloud_only", "edge_first", "greedy_assign"):
        D = getattr(r_base, name)(r_tasks, r_params)
        assert np.array_equal(getattr(t_base, name)(t_tasks, t_params), D)
        De = D * r_tasks.e * r_params.assoc
        f = r_cra.allocate_closed_form(De, r_tasks.c, r_params.F)
        assert np.array_equal(
            t_cra.allocate_closed_form(De, t_tasks.c, t_params.F), f)
        assert t_cra.o_total_calc(De, t_tasks.c, t_params.F) == \
            pytest.approx(r_cra.o_total_calc(De, r_tasks.c, r_params.F),
                          rel=1e-12)
        assert t_cost.total_cost(D, f, t_tasks, t_params) == pytest.approx(
            r_cost.total_cost(D, f, r_tasks, r_params), rel=1e-12)
        assert t_cost.assignment_cost(D, t_tasks, t_params) == \
            pytest.approx(r_cost.assignment_cost(D, r_tasks, r_params),
                          rel=1e-12)
    assert np.array_equal(t_base.random_assign(t_tasks, t_params),
                          r_base.random_assign(r_tasks, r_params))
