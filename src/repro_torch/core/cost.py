"""System model (paper §3.2): communication, computation, query costs.

Notation (Table 1): N end users, K edge servers; query task Q_n = (c_n, w_n)
with c_n CPU cycles and w_n result bits; downlink rates r^{n,k} (edge->user,
OFDMA model Eq. 4) and r^{n,c} (cloud->user); edge compute capacity F_k.

Costs:  edge  O_e^{n,k} = c_n / f_{n,k} + w_n / r^{n,k}
        cloud O_c^{n}   = w_n / r^{n,c} + c_n / F_cloud
        partial O_p^{n} = Σ_e (c_e/f_e + b_e/r_bh^e) + a_n/F_cloud
                          + w_n / r^{n,c}

The paper's Eq. 5 treats cloud compute as free (F_cloud = inf, the
default). The generalized model adds two optional knobs: ``F_cloud``
(finite = congested / metered cloud CPU) and per-edge backhaul rates
``r_backhaul`` (edge -> assembler uplink), which together price the
*partial-evaluation* plan: each contributing edge e computes its
resident-leaf fragment (c_e cycles, joining edge e's CRA pool), ships a
dictionary-free binding table of b_e bits over the backhaul, and the
cloud assembles (a_n cycles) and delivers the final w_n bits over the
user's cloud link.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..rdf.graph import RDFStore
from ..sparql.matcher import estimate_pattern_cardinality
from ..sparql.query import QueryGraph


def ofdma_rate(bandwidth_hz: np.ndarray | float,
               tx_power: np.ndarray | float,
               channel_gain: np.ndarray | float,
               noise_power: float = 1e-9) -> np.ndarray:
    """Eq. (4): r = B log2(1 + tp * h / sigma^2)."""
    return np.asarray(bandwidth_hz) * np.log2(
        1.0 + np.asarray(tx_power) * np.asarray(channel_gain) / noise_power)


@dataclass
class SystemParams:
    """Static system-side parameters.

    F:        [K] edge compute capacity, cycles/s
    r_edge:   [N, K] downlink rate ES_k -> EU_n, bits/s
    r_cloud:  [N] downlink rate cloud -> EU_n, bits/s
    assoc:    [N, K] bool, EU_n physically associated with ES_k

    Generalized-Eq.-5 extensions (both default to the paper's model):

    r_backhaul: [K] uplink rate ES_k -> cloud assembler, bits/s, or None
                (None -> DEFAULT_BACKHAUL_BPS for every edge)
    F_cloud:    cloud compute capacity in cycles/s; np.inf == the paper's
                free-cloud-compute assumption (legacy behaviour)
    """

    F: np.ndarray
    r_edge: np.ndarray
    r_cloud: np.ndarray
    assoc: np.ndarray
    r_backhaul: np.ndarray | None = None
    F_cloud: float = np.inf

    @property
    def N(self) -> int:
        return len(self.r_cloud)

    @property
    def K(self) -> int:
        return len(self.F)

    @property
    def backhaul(self) -> np.ndarray:
        """[K] effective edge->assembler uplink rates, bits/s."""
        if self.r_backhaul is None:
            return np.full(self.K, DEFAULT_BACKHAUL_BPS)
        return np.asarray(self.r_backhaul, dtype=np.float64)

    @classmethod
    def synthetic(cls, n_users: int, n_edges: int, seed: int = 0,
                  edge_mbps: float = 75.0, cloud_mbps: float = 5.0,
                  f_ghz: float = 0.2, multi_assoc_frac: float = 0.8,
                  backhaul_mbps: float = 150.0,
                  cloud_ghz: float | None = None,
                  ) -> "SystemParams":
        """Paper §5.1 defaults: edge link ~70-80 Mbps, cloud ~5 Mbps,
        0.2 GHz edge CPUs; ~20% of users see one ES, the rest several.
        ``cloud_ghz=None`` keeps the paper's free cloud compute;
        ``backhaul_mbps`` prices partial binding-table egress."""
        rng = np.random.default_rng(seed)
        F = np.full(n_edges, f_ghz * 1e9)
        # association: every user gets >=1 ES; multi-assoc users get 2-3
        assoc = np.zeros((n_users, n_edges), dtype=bool)
        for n in range(n_users):
            k0 = int(rng.integers(n_edges))
            assoc[n, k0] = True
            if rng.random() < multi_assoc_frac and n_edges > 1:
                extra = int(rng.integers(1, min(3, n_edges)))
                others = rng.choice([k for k in range(n_edges) if k != k0],
                                    size=min(extra, n_edges - 1),
                                    replace=False)
                assoc[n, others] = True
        # rates: jitter around nominal (OFDMA model collapses to this for
        # fixed bandwidth/power/gain; Eq. 4 provided for physical configs)
        r_edge = (edge_mbps * 1e6) * rng.uniform(0.9, 1.1, (n_users, n_edges))
        r_edge = np.where(assoc, r_edge, 0.0)
        r_cloud = (cloud_mbps * 1e6) * rng.uniform(0.9, 1.1, n_users)
        r_bh = (backhaul_mbps * 1e6) * rng.uniform(0.9, 1.1, n_edges)
        return cls(F=F, r_edge=r_edge, r_cloud=r_cloud, assoc=assoc,
                   r_backhaul=r_bh,
                   F_cloud=np.inf if cloud_ghz is None else cloud_ghz * 1e9)


@dataclass
class PartialOption:
    """A candidate partial-evaluation plan for one query (Eq. 5 gen.).

    edges:           [m] int edge server ids contributing fragments
    cycles:          [m] estimated fragment cycles per contributing edge
                     (joins that edge's CRA pool when the option is taken)
    ship_bits:       [m] estimated binding-table egress bits per edge
    assemble_cycles: cloud-side work: residual (non-resident) fragments +
                     the compatibility joins over the shipped tables
    plan:            opaque executable plan (sparql.partial_eval.PartialPlan)
    """

    edges: np.ndarray
    cycles: np.ndarray
    ship_bits: np.ndarray
    assemble_cycles: float
    plan: object | None = None


@dataclass
class QueryTasks:
    """Per-query parameters + executability matrix E (Eq. 2).

    ``partial``: optional [N] list of :class:`PartialOption` or None per
    query — the three-way plan space {full-edge, cloud, partial}. When the
    whole list is None (default) scheduling is the paper's binary model.
    """

    c: np.ndarray          # [N] cycles
    w: np.ndarray          # [N] bits
    e: np.ndarray          # [N, K] {0,1}
    partial: list | None = None

    @property
    def N(self) -> int:
        return len(self.c)

    def partial_option(self, n: int) -> PartialOption | None:
        return self.partial[n] if self.partial is not None else None


# ---------------------------------------------------------------------------
# cost evaluation (Eq. 5 / Eq. 10, generalized to multi-server plans)
# ---------------------------------------------------------------------------

DEFAULT_BACKHAUL_BPS = 150e6   # edge -> cloud assembler uplink default


def cloud_unit_cost(tasks: QueryTasks, params: SystemParams) -> np.ndarray:
    """[N] per-query cloud-path cost: delivery + (optional) cloud compute.

    With the paper's ``F_cloud = inf`` this is exactly ``w / r_cloud``."""
    return tasks.w / params.r_cloud + tasks.c / params.F_cloud


def partial_fixed_cost(opt: PartialOption, w_n: float,
                       params: SystemParams, row: int) -> float:
    """Congestion-independent terms of a partial plan for user-row ``row``:
    backhaul egress + cloud assembly + final delivery over the cloud link.
    The per-edge compute term is congestion-dependent (CRA pool) and is
    accounted where the assignment is known (see :func:`decisions_cost`)."""
    bh = params.backhaul[np.asarray(opt.edges, dtype=np.int64)]
    return float((np.asarray(opt.ship_bits, dtype=np.float64) / bh).sum()
                 + opt.assemble_cycles / params.F_cloud
                 + w_n / params.r_cloud[row])


def partial_free_cost(opt: PartialOption, w_n: float,
                      params: SystemParams, row: int) -> float:
    """Congestion-FREE total partial cost (each fragment alone on its edge:
    c_e / F_e). Lower-bounds the realized partial cost; used for modeled
    latency (and for the reference's R-QAD slack correction)."""
    F = params.F[np.asarray(opt.edges, dtype=np.int64)]
    return float((np.asarray(opt.cycles, dtype=np.float64) / F).sum()
                 + partial_fixed_cost(opt, w_n, params, row))


def total_cost(D: np.ndarray, f: np.ndarray, tasks: QueryTasks,
               params: SystemParams) -> float:
    """Eq. (5) evaluated for explicit (D, F). D, f: [N, K]."""
    De = D * tasks.e
    on_edge = De.sum(axis=1)  # 0 or 1 per user
    edge_comp = np.where(De > 0, tasks.c[:, None] / np.maximum(f, 1e-30), 0.0)
    with np.errstate(divide="ignore"):
        edge_tx = np.where(De > 0,
                           tasks.w[:, None] / np.maximum(params.r_edge, 1e-30),
                           0.0)
    cloud = (1.0 - on_edge) * cloud_unit_cost(tasks, params)
    return float((De * (edge_comp + edge_tx)).sum() + cloud.sum())


def assignment_cost(D: np.ndarray, tasks: QueryTasks,
                    params: SystemParams) -> float:
    """Eq. (14): exact cost of an integral assignment with optimal CRA."""
    from .cra import allocate_closed_form, o_total_calc
    De = (D * tasks.e).astype(np.float64)
    o_calc = o_total_calc(De, tasks.c, params.F)
    with np.errstate(divide="ignore"):
        edge_tx = np.where(De > 0,
                           tasks.w[:, None] / np.maximum(params.r_edge, 1e-30),
                           0.0).sum()
    cloud = ((1.0 - De.sum(axis=1)) * cloud_unit_cost(tasks, params)).sum()
    return float(o_calc + edge_tx + cloud)


def decisions_cost(decisions: np.ndarray, tasks: QueryTasks,
                   params: SystemParams) -> float:
    """Exact generalized-Eq.-5 cost of a per-query decision vector.

    ``decisions``: [N] ints — edge id in [0, K), -1 for cloud, or K for the
    query's partial option (requires ``tasks.partial[n]``). Edge-assigned
    queries AND partial fragments share each edge's CRA pool (Eq. 13):
    the pool's sqrt-cycles sum S_k prices compute as Σ_k S_k²/F_k.
    """
    K = params.K
    S = np.zeros(K)
    tx = 0.0
    sq = np.sqrt(np.maximum(tasks.c, 0.0))
    cloud = cloud_unit_cost(tasks, params)
    for n, ch in enumerate(np.asarray(decisions, dtype=np.int64)):
        if ch == K:
            opt = tasks.partial_option(int(n))
            if opt is None:
                raise ValueError(f"row {n}: partial decision without option")
            eids = np.asarray(opt.edges, dtype=np.int64)
            S[eids] += np.sqrt(np.maximum(
                np.asarray(opt.cycles, dtype=np.float64), 0.0))
            tx += partial_fixed_cost(opt, float(tasks.w[n]), params, int(n))
        elif ch >= 0:
            S[ch] += sq[n]
            tx += float(tasks.w[n] / params.r_edge[n, ch])
        else:
            tx += float(cloud[n])
    return float((S ** 2 / params.F).sum() + tx)


# ---------------------------------------------------------------------------
# query cost estimation (paper adopts selectivity estimators [29, 41])
# ---------------------------------------------------------------------------

CYCLES_PER_ROW = 220.0       # calibration constant: join work per binding row
CYCLES_BASE = 5e4            # fixed per-query overhead (parse, plan)
BITS_PER_CELL = 64.0
BITS_PER_BYTE = 8
# realized-latency calibration: measured engine wall (prescan + join phases)
# -> cost-model cycles. The reference machine the row-count calibration
# above was fit on runs ~1e9 model-cycles of matcher work per wall second,
# so a measured second of engine time prices the same as ~4.5M result rows.
CYCLES_PER_ENGINE_SECOND = 1.0e9


def measured_cycles(n_rows: int, engine_seconds: float = 0.0) -> float:
    """Realized c_n: cost-model cycles from MEASURED execution evidence.

    When per-phase engine wall is available (``ExecutionRecord.
    engine_seconds`` / ``PartialExecution.per_server_seconds`` — the
    prescan+join seconds the engine actually spent on this work), cycles
    derive from it directly, floored only at the fixed per-query overhead.
    Final row counts alone misprice compute in both directions: they
    undercount intermediate join work (a selective query over a huge graph
    can burn seconds and return 3 rows) and overcharge work that never
    re-ran (a partial plan's cloud ASSEMBLY joins two shipped binding
    tables, yet the final row count prices it like a from-scratch
    evaluation). The row-count calibration remains the fallback for
    records with no phase measurement (``engine_seconds == 0``).
    """
    if engine_seconds > 0.0:
        return float(max(CYCLES_BASE,
                         engine_seconds * CYCLES_PER_ENGINE_SECOND))
    return float(CYCLES_BASE + CYCLES_PER_ROW * max(n_rows, 1))


def result_bits(res, projection: list[str]) -> float:
    """w_n in *bits* from a :class:`~repro_torch.sparql.matcher.MatchResult`.

    The single source of the bytes->bits unit conversion for result-size
    accounting — every ``ExecutionRecord.result_bits`` and measured ``w_n``
    goes through here (Eq. 5 divides w_n by link rates in bits/s).
    """
    return float(res.result_bytes(projection) * BITS_PER_BYTE)


def estimate_query_cost(store: RDFStore, q,
                        ) -> tuple[float, float]:
    """(c_n cycles, w_n bits) via join-order cardinality simulation.

    Follows Stocker et al. [WWW'08]-style selectivity composition: walk the
    greedy join order, multiplying in per-pattern selectivities; c_n sums the
    estimated intermediate sizes (work), w_n is the final estimate (result).

    ``q`` is a plain :class:`QueryGraph` or a compiled algebra plan
    (:class:`repro_torch.sparql.algebra.Node`): a plan costs the sum of its BGP
    leaves' work c_n (every leaf executes) and estimates w_n structurally
    — UNION **sums** its branches (concatenation grows the result), while
    join/filter/modifier operators take the largest input (they only
    combine or drop rows of their inputs).
    """
    leaves = getattr(q, "bgp_leaves", None)
    if leaves is not None:
        from ..sparql.algebra import BGPNode, UnionNode
        work = 0.0

        def est_w(node) -> float:
            nonlocal work
            if isinstance(node, BGPNode):
                if not node.query.patterns:
                    return float(BITS_PER_CELL)
                c_i, w_i = estimate_query_cost(store, node.query)
                work += c_i - CYCLES_BASE
                return w_i
            kids = [est_w(c) for c in node.children()]
            if not kids:
                return float(BITS_PER_CELL)
            return float(sum(kids) if isinstance(node, UnionNode)
                         else max(kids))
        w = est_w(q)
        return float(CYCLES_BASE + work), max(w, float(BITS_PER_CELL))
    from ..sparql.matcher import _order_patterns  # same plan as execution
    order = _order_patterns(store, q)
    bound: set[str] = set()
    rows = 1.0
    work = 0.0
    for i in order:
        tp = q.patterns[i]
        card = max(estimate_pattern_cardinality(store, tp), 1e-3)
        # classic independent-join estimate: each shared variable divides by
        # the distinct-value count of the position it occupies in tp
        denom = 1.0
        if isinstance(tp.p, int):
            ds = max(1.0, float(store.pred_distinct_s[tp.p]))
            do = max(1.0, float(store.pred_distinct_o[tp.p]))
        else:
            ds = do = max(1.0, float(store.num_entities) ** 0.5)
        if isinstance(tp.s, str) and tp.s in bound:
            denom *= ds
        if isinstance(tp.o, str) and tp.o in bound:
            denom *= do
        if isinstance(tp.p, str) and tp.p in bound:
            denom *= max(1.0, float(store.num_predicates))
        rows = rows * card / denom
        rows = max(rows, 0.0)
        work += rows
        bound.update(tp.variables())
    n_proj = max(1, len(q.projection) if q.projection else len(q.variables))
    c = CYCLES_BASE + CYCLES_PER_ROW * work
    w = max(BITS_PER_CELL, rows * n_proj * BITS_PER_CELL)
    return float(c), float(w)


def measured_query_cost(store: RDFStore, q: QueryGraph,
                        engine=None) -> tuple[float, float, int]:
    """(c_n cycles-equivalent, w_n bits, n_matches) by actually executing.

    ``engine``: optional :class:`repro_torch.sparql.engine.QueryEngine` — routes
    execution through its backend and result cache, so repeated measurement
    of a hot query (re-costing between scheduling rounds) is a cache hit.
    ``q`` may be a plain :class:`QueryGraph` or a compiled algebra plan
    (the latter requires an engine).
    """
    if engine is not None:
        from ..sparql.algebra import execute_any_batch
        res = execute_any_batch(store, engine, [q])[0]
    else:
        from ..sparql.algebra import is_algebra_plan
        if is_algebra_plan(q):
            raise ValueError("measuring an algebra plan needs an engine")
        from ..sparql.matcher import match_bgp
        res = match_bgp(store, q)
    n_rows = res.num_matches
    c = CYCLES_BASE + CYCLES_PER_ROW * max(n_rows, 1)
    # unit check: 64-bit binding cells == 8 bytes/cell; w_n must be bits
    assert BITS_PER_CELL == BITS_PER_BYTE * np.dtype(np.int64).itemsize
    w = result_bits(res, q.projection)
    return float(c), w, n_rows


def measured_query_cost_batch(store: RDFStore, queries: list[QueryGraph],
                              engine) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Vectorized measured costs ([N] c, [N] w, [N] n_matches) for a batch.

    One ``engine.execute_batch`` call: identical candidate scans across the
    batch run once and alpha-equivalent queries share cached results, which
    is what makes measured (rather than estimated) costs affordable as a
    scheduler input at serving scale. Mixed BGP/algebra batches are
    supported — every algebra plan's BGP leaves join the same batch.
    """
    from ..sparql.algebra import execute_any_batch
    results = execute_any_batch(store, engine, queries)
    n = np.array([r.num_matches for r in results], dtype=np.int64)
    c = CYCLES_BASE + CYCLES_PER_ROW * np.maximum(n, 1).astype(np.float64)
    w = np.array([result_bits(r, q.projection)
                  for q, r in zip(queries, results)], dtype=np.float64)
    return c, w, n
