"""End-to-end edge-cloud system simulator (paper Fig. 1 / §5 environment).

Wires together: the RDF cloud store, K edge servers with pattern-induced
subgraphs, N end users with link rates, the executability matrix E built via
the pattern hash index, and the MINLP scheduler. One ``run_round`` performs
the full paper pipeline:

  queries -> patterns -> E-matrix (isomorphism lookup) -> schedule (B&B or
  baseline) -> execute at assigned servers -> response-time accounting.

Response time per query follows the paper's cost model (Eq. 5) with the
CRA-optimal resource split; wall-clock matcher times are also recorded so
a run can report both modeled and measured numbers.

**Where it runs.** The system's one :class:`QueryEngine` serves the cloud
and every edge. Unlike the reference package, whose default backend is
``"numpy"``, the default here is ``backend="torch"`` on ``cuda``: the
cloud's store and every edge's pattern-induced subgraph are staged on the
card by the one shared :class:`~repro_torch.sparql.engine.TorchBackend`,
and the query kernels run against each of them. ``device="cpu"`` runs the
kernels' plain torch versions; ``backend="numpy"`` the host matcher.
Without CUDA the default raises. Every server batch ends in the backend's
one ``.cpu()`` fetch, so the batch wall clock that feeds Eq. 5 covers the
device work it launched.

``run_round_batched`` executes each server's assignment as one engine batch;
``overlap=True`` resolves per backend as the reference does
(:func:`resolve_overlap_mode`). Overlap runs the per-server batches through
a thread pool so edge and cloud execution no longer serialize (the shared
engine's caches are lock-guarded; per-server wall clocks are measured
inside each thread and feed the Eq. 5 accounting unchanged). Unlike the
reference, the port has no fork pool: ``"process"`` overlap runs as thread
overlap for every engine, so no process ever forks a CUDA context. The
reference keeps the fork pool for its GIL-bound numpy deployments.

**Placement epochs (the rebalance handshake).** Placement is a first-class,
continuously running part of the system: ``rebalance_async`` starts a
:class:`repro_torch.edge.rebalance.RebalanceManager` pass whose expensive compute
phase (matching new patterns through the shared memoized
:class:`repro_torch.core.induced.InducedIndex`, planning residency under total +
per-shard budgets, diffing edge stores into
:class:`repro_torch.rdf.deltas.TripleDelta`s) overlaps query rounds. Every round
holds ``_placement_lock`` from scheduling through execution and the
rebalance commits under the same lock, bumping ``placement_epoch`` — so the
feasibility matrix ``e_nk``, the pattern indexes, and the edge stores
always belong to ONE epoch and ``schedule(policy="bnb")`` can never route a
query to an edge mid-eviction. ``rebalance_all`` is the synchronous form;
both ship deltas by default (``use_deltas=False`` re-ships full induced
subgraphs, kept for A/B).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.cost import (CYCLES_BASE, CYCLES_PER_ROW, BITS_PER_CELL,
                         PartialOption, QueryTasks, SystemParams,
                         estimate_query_cost, partial_free_cost)
from ..core.induced import InducedIndex
from ..core.pattern import (VAR_PRED_LABEL, Pattern, feasibility_patterns,
                            observed_patterns)
from ..core.placement import PatternProfile, greedy_knapsack
from ..core.scheduler import ScheduleResult, schedule
from ..rdf.graph import RDFStore
from ..sparql.algebra import compile_query
from ..sparql.engine import QueryEngine, TorchBackend
from ..sparql.partial_eval import execute_partial_batch, plan_partial
from ..sparql.query import QueryGraph, parse_query
from .rebalance import RebalanceHandle, RebalanceManager, RebalanceReport
from .server import CloudServer, EdgeServer, ExecutionRecord

# ``QueryOutcome.assigned_to`` / batched-round sentinel: the query ran as a
# PARTIAL plan — resident-leaf fragments at several edges, assembly at the
# cloud (see repro_torch.sparql.partial_eval). -1 remains whole-query cloud.
PARTIAL = -2


def resolve_overlap_mode(overlap: bool | str, backend_name: str) -> str:
    """Resolve a ``run_round_batched(overlap=...)`` argument to a mode.

    The reference's rule: explicit ``"thread"`` / ``"process"`` strings
    are returned as given, ``overlap=True`` picks **process** for numpy and
    **thread** for any other backend, ``False`` -> ``""`` (sequential).
    :meth:`EdgeCloudSystem.run_round_batched` then runs ``"process"`` as
    thread overlap, since the port has no fork pool.
    """
    if not overlap:
        return ""
    if isinstance(overlap, str):
        return overlap
    return "process" if backend_name == "numpy" else "thread"


@dataclass
class QueryOutcome:
    user: int
    assigned_to: int              # -1 cloud, -2 partial, else edge server id
    modeled_latency: float        # paper cost model w/ ESTIMATED (c, w)
    realized_latency: float       # paper cost model w/ MEASURED result size
    measured_exec_seconds: float  # actual matcher wall time
    n_matches: int
    executable_edges: list[int]
    # multi-server (partial-evaluation) assignments only:
    partial_servers: tuple = ()   # edges that contributed fragments
    shipped_bits: float = 0.0     # binding-table egress over the backhaul


@dataclass
class RoundReport:
    policy: str
    outcomes: list[QueryOutcome]
    objective: float              # scheduler objective (modeled total cost)
    schedule_seconds: float
    assignment_counts: dict[int, int]  # -1 cloud, k per edge
    overlapped: bool = False      # batches dispatched through a worker pool
    overlap_mode: str = ""        # "" or "thread"
    execute_wall_seconds: float = 0.0  # wall clock of the execute phase
    # per-server batch wall clock (-1 cloud, k per edge); in an overlapped
    # round these overlap each other, so their sum exceeds the phase wall
    server_wall_seconds: dict[int, float] = field(default_factory=dict)
    # per-query match results aligned with ``outcomes`` — populated only by
    # ``run_round_batched(collect_results=True)`` (the serving front end
    # needs the bindings, not just the accounting records)
    results: list | None = None
    # partial-evaluation accounting (batched rounds only): queries that ran
    # as multi-edge partial plans, their total dictionary-free binding-table
    # egress, and plans that fell back to the cloud on a stale placement
    partial_queries: int = 0
    partial_bytes_shipped: int = 0
    partial_fallbacks: int = 0
    # the scheduler's own report (bnb: nodes explored and pruned, solve
    # seconds, and whether the solution came back certified optimal)
    schedule_info: dict = field(default_factory=dict)

    @property
    def total_modeled_latency(self) -> float:
        return sum(o.modeled_latency for o in self.outcomes)

    @property
    def total_realized_latency(self) -> float:
        return sum(o.realized_latency for o in self.outcomes)

    @property
    def assignment_ratio(self) -> dict[int, float]:
        n = max(1, len(self.outcomes))
        return {k: v / n for k, v in sorted(self.assignment_counts.items())}


@dataclass
class IngestReport:
    """Outcome of one live-ingest write (cloud ``apply_delta`` path)."""

    kind: str = ""                 # insert_data | delete_data | delete_where
    n_add: int = 0                 # triples added to the cloud
    n_evict: int = 0               # triples removed from the cloud
    new_terms: int = 0             # dictionary terms minted (version bumps)
    dropped_rows: int = 0          # no-op delete rows (unknown terms)
    touched_predicates: list[int] | None = None   # None == all predicates
    patterns_carried: int = 0      # induced-memo entries carried forward
    patterns_invalidated: int = 0  # entries dropped (must re-match)
    edges_updated: int = 0         # edge stores that received a delta
    shipped_bytes: int = 0         # cloud->edge delta wire bytes
    cloud_version_before: object = None
    cloud_version: object = None
    placement_epoch: int = 0
    apply_seconds: float = 0.0

    @property
    def is_noop(self) -> bool:
        return not (self.n_add or self.n_evict)


def _pattern_key_labels(key: tuple) -> set[int]:
    """Edge labels of a canonical pattern key (``(n_vertices, code)`` —
    every DFS-code entry carries its label last)."""
    return {entry[-1] for entry in key[1]}


class EdgeCloudSystem:
    """K edge servers + cloud + N users, with pattern-based data placement.

    ``store`` may be a monolithic :class:`~repro_torch.rdf.graph.TripleStore`
    or a :class:`~repro_torch.rdf.sharding.ShardedTripleStore`; edge
    deployments inherit the cloud store's kind through ``subgraph``.
    ``engine`` (or ``backend`` and ``device``) selects the one engine that
    serves every server: ``TorchBackend`` on ``cuda`` by default.
    """

    def __init__(self, store: RDFStore, dictionary, params: SystemParams,
                 storage_budgets: np.ndarray | int,
                 backend: str = "torch",
                 engine: QueryEngine | None = None,
                 shard_budgets=None,
                 enable_partial: bool = True,
                 device: str | torch.device | None = None) -> None:
        # three-way scheduling {edge, cloud, partial}: batched rounds may
        # split a cloud-bound query's resident leaves across several edges
        # (repro_torch.sparql.partial_eval); False restores the binary paper model
        self.enable_partial = bool(enable_partial)
        # one engine serves cloud + all edges: its result cache keys embed
        # the store version, so entries from different stores never collide
        # (the torch backend on ``device``, cuda unless the caller names
        # another)
        if engine is None:
            engine = QueryEngine(backend=(TorchBackend(device=device)
                                          if backend == "torch" else backend))
        self.engine = engine
        self.cloud = CloudServer(store, engine=self.engine)
        self.dictionary = dictionary
        self.params = params
        budgets = (np.full(params.K, storage_budgets)
                   if np.isscalar(storage_budgets) else storage_budgets)
        # per-shard byte budgets (sharded cloud only): scalar = same budget
        # for every shard, or a [num_shards] vector; applied at every edge
        if shard_budgets is not None and np.isscalar(shard_budgets):
            shard_budgets = np.full(getattr(store, "num_shards", 1),
                                    int(shard_budgets))
        # shared memoized induced-edge-id index: patterns measured once per
        # cloud version across all edges (and across rebalances)
        self.induced = InducedIndex()
        self.edges = [EdgeServer(k, int(budgets[k]), params.F[k],
                                 engine=self.engine,
                                 shard_budgets=shard_budgets,
                                 induced=self.induced)
                      for k in range(params.K)]
        self.construction_seconds = 0.0
        # epoch/barrier handshake with the rebalance data-plane: rounds hold
        # the lock from scheduling through execution; rebalance commits under
        # it and bumps the epoch, so a round never observes a half-applied
        # placement (see repro_torch.edge.rebalance)
        self._placement_lock = threading.RLock()
        self.placement_epoch = 0
        self.rebalancer = RebalanceManager(self)
        self.last_rebalance: RebalanceReport | None = None

    def clear_engine_caches(self) -> None:
        """Cold-start the shared engine (its result cache and staging)."""
        self.engine.clear_cache()

    # -- offline preparation (paper: construction overhead, Table 11) -------
    def prepare(self, history_queries: list[list[str]]) -> None:
        """Deploy pattern-induced subgraphs from per-user query history.

        ``history_queries[n]`` = past SPARQL strings of user n. Each edge
        server considers patterns seen by its associated users, selects under
        its budget (greedy knapsack), and materializes G[P].
        """
        t0 = time.perf_counter()
        per_user_patterns: list[list[Pattern]] = []
        for qs in history_queries:
            pats = []
            for text in qs:
                # full-grammar history: every BGP leaf of an algebra query
                # (OPTIONAL sides included) is a placement candidate
                plan = compile_query(parse_query(text, self.dictionary),
                                     self.dictionary)
                pats += [p for p in observed_patterns(plan) if p.indexable]
            per_user_patterns.append(pats)

        with self._placement_lock:
            for es in self.edges:
                users = np.flatnonzero(self.params.assoc[:, es.server_id])
                freq: dict[tuple, float] = {}
                pat_by_key: dict[tuple, Pattern] = {}
                for n in users:
                    if n < len(per_user_patterns):
                        for p in per_user_patterns[n]:
                            freq[p.key] = freq.get(p.key, 0.0) + 1.0
                            pat_by_key.setdefault(p.key, p)
                profiles = []
                keys = list(freq)
                for k in keys:
                    size = es.measure_pattern(self.cloud.store,
                                              pat_by_key[k])
                    profiles.append(PatternProfile(
                        pat_by_key[k], freq[k], size,
                        es.placement.shard_sizes.get(k)))
                chosen = greedy_knapsack(profiles, es.budget,
                                         es.placement.shard_budgets)
                resident = [pat_by_key[keys[i]] for i in chosen]
                es.deploy(self.cloud.store, resident)
                for p in resident:
                    es.placement.observe(p, freq[p.key])
            self.placement_epoch += 1
        self.construction_seconds = time.perf_counter() - t0

    # -- the online path ------------------------------------------------------
    def _plan_partial_option(self, user: int, q, w_n: float,
                             ) -> PartialOption | None:
        """Estimate the generalized-Eq.-5 partial option for one query.

        Plans the fragment split (:func:`repro_torch.sparql.partial_eval.
        plan_partial`) over the user's associated edges, then prices it:
        per-edge fragment cycles/result bits are estimated against that
        edge's (much smaller) G[P] store; residual + OPTIONAL fragments and
        the compatibility joins are cloud-side assembly cycles. Returns
        None when no edge can contribute. Caller holds the placement lock.
        """
        servers = [es for es in self.edges
                   if self.params.assoc[user, es.server_id]
                   and es.store is not None]
        if not servers:
            return None
        plan = plan_partial(q, servers)
        if plan is None:
            return None
        by_id = {es.server_id: es for es in servers}
        cycles: dict[int, float] = {}
        bits: dict[int, float] = {}
        assemble = CYCLES_BASE
        for frag in plan.fragments:
            store = (self.cloud.store if frag.server_id < 0
                     else by_id[frag.server_id].store)
            c_f, w_f = estimate_query_cost(store, frag.query)
            if frag.server_id < 0:
                assemble += c_f          # residual runs at the assembler
            else:
                cycles[frag.server_id] = cycles.get(frag.server_id, 0) + c_f
                bits[frag.server_id] = bits.get(frag.server_id, 0) + w_f
        # the compatibility joins + final operators: work proportional to
        # the estimated result rows (same calibration as measured costs)
        n_proj = max(1, len(q.projection) if getattr(q, "projection", None)
                     else len(getattr(q, "variables", [])) or 1)
        assemble += CYCLES_PER_ROW * (w_n / (BITS_PER_CELL * n_proj))
        eids = np.array(sorted(cycles), dtype=np.int64)
        return PartialOption(
            edges=eids,
            cycles=np.array([cycles[k] for k in eids], dtype=np.float64),
            ship_bits=np.array([bits[k] for k in eids], dtype=np.float64),
            assemble_cycles=float(assemble), plan=plan)

    def build_tasks(self, queries: list[tuple[int, QueryGraph]],
                    cost_source: str = "estimate",
                    include_partial: bool = False) -> QueryTasks:
        """(c, w, e) for a batch of (user, query) pairs (Eq. 2 via index).

        ``queries`` may mix plain :class:`QueryGraph`\\ s and compiled
        algebra plans. Feasibility is per-BGP-leaf
        (:func:`~repro_torch.core.pattern.feasibility_patterns`): an algebra
        query is edge-executable iff EVERY required leaf's pattern is
        resident at that edge (OPTIONAL right sides excluded), so the B&B
        scheduler routes algebra queries exactly like BGPs.

        Taken under the placement lock so the feasibility matrix ``e_nk``
        snapshots ONE placement epoch — it can never mix pre- and
        post-rebalance residency across rows.

        ``include_partial=True`` (and ``enable_partial``) additionally
        plans a :class:`PartialOption` for every query NO single edge can
        fully serve — the three-way {edge, cloud, partial} plan space the
        B&B scheduler prices via the generalized Eq. 5.
        """
        N = len(queries)
        c = np.zeros(N)
        w = np.zeros(N)
        e = np.zeros((N, self.params.K))
        partial: list | None = None
        with self._placement_lock:
            for i, (user, q) in enumerate(queries):
                c[i], w[i] = estimate_query_cost(self.cloud.store, q)
                pats = feasibility_patterns(q)
                if pats is None:
                    continue        # nothing certifies edge execution
                for es in self.edges:
                    if self.params.assoc[user, es.server_id] and \
                            all(es.can_execute(p) for p in pats):
                        e[i, es.server_id] = 1.0
            if include_partial and self.enable_partial:
                partial = [None] * N
                for i, (user, q) in enumerate(queries):
                    if e[i].sum() == 0:   # full-edge already dominates
                        partial[i] = self._plan_partial_option(
                            user, q, float(w[i]))
                if not any(p is not None for p in partial):
                    partial = None
        return QueryTasks(c=c, w=w, e=e, partial=partial)

    def _schedule_round(self, queries: list[tuple[int, QueryGraph]],
                        policy: str, sched_kw: dict,
                        include_partial: bool = False,
                        ) -> tuple[QueryTasks, SystemParams,
                                   ScheduleResult, float]:
        tasks = self.build_tasks(queries, include_partial=include_partial)
        # user->link rows: task i belongs to user queries[i][0]; backhaul
        # rates are per-EDGE uplinks, so they pass through un-sliced
        users = [u for (u, _) in queries]
        params_batch = SystemParams(
            F=self.params.F,
            r_edge=self.params.r_edge[users],
            r_cloud=self.params.r_cloud[users],
            assoc=self.params.assoc[users],
            r_backhaul=self.params.r_backhaul,
            F_cloud=self.params.F_cloud,
        )
        if policy == "bnb":
            # anytime budget: at paper scale (K=4, N=20) optimality is
            # proven in ms; at fleet scale the incumbent is returned
            sched_kw.setdefault("max_seconds", 2.0)
        t0 = time.perf_counter()
        sr: ScheduleResult = schedule(tasks, params_batch, policy=policy,
                                      **sched_kw)
        return tasks, params_batch, sr, time.perf_counter() - t0

    def _observe_pattern(self, user: int, q) -> None:
        # algebra plans observe every BGP leaf (OPTIONAL sides included) so
        # dynamic placement can learn the full shape of the workload
        for p in observed_patterns(q):
            if p.indexable:
                for es in self.edges:
                    if self.params.assoc[user, es.server_id]:
                        es.placement.observe(p)

    @staticmethod
    def _realized_latency(rec, i: int, k: int, sr: ScheduleResult,
                          params_batch: SystemParams) -> float:
        # realized response time: same cost model, measured w and measured
        # cycles — per-phase engine wall (prescan+join) when available,
        # floored at the row-derived figure (repro_torch.core.cost.
        # measured_cycles); the paper reports measured response times,
        # estimates only drive the scheduler
        from ..core.cost import measured_cycles
        c_real = measured_cycles(rec.n_matches,
                                 getattr(rec, "engine_seconds", 0.0))
        if k >= 0:
            f = max(sr.f[i, k], 1e-30)
            return c_real / f + rec.result_bits / params_batch.r_edge[i, k]
        # generalized cloud path: delivery + (finite-F_cloud) compute;
        # with the paper's free cloud (F_cloud = inf) the term vanishes
        return (rec.result_bits / params_batch.r_cloud[i]
                + c_real / params_batch.F_cloud)

    def _realized_partial_latency(self, pe, rec, i: int,
                                  params_batch: SystemParams) -> float:
        # generalized Eq. 5 with MEASURED per-edge rows/wall and egress
        # bits: fragment compute per contributing edge, binding-table
        # shipping over each edge's backhaul, assembly at the cloud
        # (per-server engine wall feeds measured_cycles the same way the
        # single-server path does), final delivery over the user's cloud
        # link
        from ..core.cost import measured_cycles
        bh = params_batch.backhaul
        # engine-phase seconds (prescan+join) when the executor recorded
        # them; raw walls otherwise — symmetric with the single-server
        # path's ExecutionRecord.engine_seconds
        secs = (getattr(pe, "per_server_engine_seconds", None)
                or pe.per_server_seconds)
        t = 0.0
        for sid, rows in pe.per_server_rows.items():
            if sid >= 0:
                t += measured_cycles(rows, secs.get(sid, 0.0)
                                     ) / self.params.F[sid]
        for sid, bits in pe.per_server_bits.items():
            t += bits / bh[sid]
        t += measured_cycles(rec.n_matches, secs.get(-1, 0.0)
                             ) / params_batch.F_cloud
        return float(t + rec.result_bits / params_batch.r_cloud[i])

    def explain_assignment(self, q, user: int = 0) -> str:
        """Dry-run the scheduler for one query and render the chosen plan
        kind — ``edge ESk`` / ``cloud`` / ``partial`` — plus, for partial,
        the per-server leaf split (used by ``SparqlEndpoint.explain``)."""
        with self._placement_lock:
            tasks, params_batch, sr, _ = self._schedule_round(
                [(user, q)], "bnb", {}, include_partial=True)
        opt = tasks.partial_option(0)
        if sr.partial is not None and sr.partial[0] and opt is not None:
            lines = ["assignment: partial "
                     f"(edges {np.asarray(opt.edges).tolist()} -> cloud "
                     "assembler)"]
            lines += ["  " + s for s in opt.plan.describe()]
            return "\n".join(lines)
        De = sr.D[0] * tasks.e[0]
        k = int(De.argmax()) if De.sum() > 0 else -1
        if k >= 0:
            return (f"assignment: edge ES{k} "
                    "(every required leaf resident)")
        why = (" (partial option available but estimated dearer)"
               if opt is not None else "")
        return "assignment: cloud" + why

    def run_round(self, queries: list[tuple[int, QueryGraph]],
                  policy: str = "bnb", execute: bool = True,
                  observe: bool = True, **sched_kw) -> RoundReport:
        # the round holds the placement lock from scheduling through
        # execution: a concurrent rebalance computes in parallel but its
        # commit (store mutation + index republish) waits for the barrier
        with self._placement_lock:
            return self._run_round_locked(queries, policy, execute,
                                          observe, sched_kw)

    def _run_round_locked(self, queries, policy, execute, observe,
                          sched_kw) -> RoundReport:
        tasks, params_batch, sr, sched_dt = self._schedule_round(
            queries, policy, sched_kw)

        outcomes: list[QueryOutcome] = []
        counts: dict[int, int] = {}
        for i, (user, q) in enumerate(queries):
            De = sr.D[i] * tasks.e[i]
            k = int(De.argmax()) if De.sum() > 0 else -1
            counts[k] = counts.get(k, 0) + 1
            if k >= 0:
                f = sr.f[i, k]
                modeled = (tasks.c[i] / max(f, 1e-30)
                           + tasks.w[i] / params_batch.r_edge[i, k])
            else:
                modeled = (tasks.w[i] / params_batch.r_cloud[i]
                           + tasks.c[i] / params_batch.F_cloud)
            n_matches, wall = 0, 0.0
            realized = modeled
            if execute:
                if k >= 0:
                    res, rec = self.edges[k].execute(q)
                else:
                    res, rec = self.cloud.execute(q)
                n_matches, wall = rec.n_matches, rec.wall_seconds
                realized = self._realized_latency(rec, i, k, sr,
                                                  params_batch)
            if observe:
                self._observe_pattern(user, q)
            outcomes.append(QueryOutcome(
                user=user, assigned_to=k, modeled_latency=float(modeled),
                realized_latency=float(realized),
                measured_exec_seconds=wall, n_matches=n_matches,
                executable_edges=np.flatnonzero(tasks.e[i]).tolist()))
        return RoundReport(policy=policy, outcomes=outcomes,
                           objective=sr.objective,
                           schedule_seconds=sched_dt,
                           assignment_counts=counts,
                           schedule_info=dict(sr.info))

    def run_round_batched(self, queries: list[tuple[int, QueryGraph]],
                          policy: str = "bnb", execute: bool = True,
                          observe: bool = True,
                          overlap: bool | str = False,
                          max_workers: int | None = None,
                          collect_results: bool = False,
                          **sched_kw) -> RoundReport:
        """One scheduling round where each server executes its assignment as
        ONE batch through the shared :class:`QueryEngine` (scan dedup +
        result cache) instead of a per-query Python loop.

        Scheduling, cost accounting, and placement observation are identical
        to :meth:`run_round`; only the execution strategy differs, so the two
        produce the same solution multisets per query (asserted in
        ``tests/test_torch_edge_system.py``). Per-query ``measured_exec_seconds`` is the
        batch wall time apportioned evenly over the batch.

        Any truthy ``overlap`` dispatches each server's batch through a
        thread pool so edge and cloud batches no longer serialize — the
        engine's caches are lock-guarded and the NumPy/torch hot paths
        release the GIL where they can. ``"process"`` (which
        :func:`resolve_overlap_mode` picks for numpy engines, as in the
        reference) runs as thread overlap: the port has no fork pool. Each
        server's wall clock is measured inside its own worker
        (``RoundReport.server_wall_seconds``) and feeds the Eq. 5 accounting
        exactly as in a sequential round, so overlapped and sequential
        rounds report identical outcomes; only the round's
        ``execute_wall_seconds`` shrinks.

        ``collect_results=True`` additionally returns each query's match
        result (``RoundReport.results``, aligned with ``outcomes``) — the
        serving front end reads the bindings, not just the accounting
        records.

        Like :meth:`run_round`, the whole round runs under the placement
        lock (the rebalance epoch barrier).
        """
        with self._placement_lock:
            return self._run_round_batched_locked(
                queries, policy, execute, observe, overlap, max_workers,
                collect_results, sched_kw)

    def _run_round_batched_locked(self, queries, policy, execute, observe,
                                  overlap, max_workers, collect_results,
                                  sched_kw) -> RoundReport:
        tasks, params_batch, sr, sched_dt = self._schedule_round(
            queries, policy, sched_kw, include_partial=True)

        # assignment per query (edge k, cloud -1, or PARTIAL), then group
        # the single-server rows into one batch per server
        assigned: list[int] = []
        for i in range(len(queries)):
            opt = tasks.partial_option(i)
            if (sr.partial is not None and sr.partial[i] and opt is not None
                    and opt.plan is not None):
                assigned.append(PARTIAL)
                continue
            De = sr.D[i] * tasks.e[i]
            k = int(De.argmax()) if De.sum() > 0 else -1
            assigned.append(k)

        # no fork pool in the port: "process" runs on threads, so a CUDA
        # context is never forked
        mode = resolve_overlap_mode(overlap, self.engine.backend.name)
        if mode == "process":
            mode = "thread"

        records: list = [None] * len(queries)
        results: list | None = ([None] * len(queries) if collect_results
                                else None)
        server_wall: dict[int, float] = {}
        exec_wall = 0.0
        partial_idx = [i for i, k in enumerate(assigned) if k == PARTIAL]
        partial_exec: dict[int, object] = {}
        if execute:
            by_server: dict[int, list[int]] = {}
            for i, k in enumerate(assigned):
                if k != PARTIAL:
                    by_server.setdefault(k, []).append(i)

            def run_server(k: int, idxs: list[int]):
                batch = [queries[i][1] for i in idxs]
                server = self.cloud if k < 0 else self.edges[k]
                t0 = time.perf_counter()
                out = server.execute_batch(batch)
                dt = time.perf_counter() - t0
                if collect_results:
                    for i, (res, _) in zip(idxs, out):
                        results[i] = res
                return k, [rec for _, rec in out], dt

            if len(by_server) <= 1:
                mode = ""            # nothing to overlap: report truthfully
            t_exec = time.perf_counter()
            if mode:
                from ..core.parallel import thread_map
                done = thread_map(lambda kv: run_server(*kv),
                                  by_server.items(), max_workers)
            else:
                done = [run_server(k, idxs)
                        for k, idxs in by_server.items()]
            if partial_idx:
                # partial plans run in the coordinating process (fragment
                # batches are per-edge engine batches inside): their store
                # versions are re-verified there, so a rebalance that
                # slipped between scheduling and execution degrades to a
                # whole-query cloud fallback instead of a stale assembly
                pex = execute_partial_batch(
                    [tasks.partial_option(i).plan for i in partial_idx],
                    self.cloud.store, self.engine,
                    {es.server_id: es for es in self.edges})
                for i, pe in zip(partial_idx, pex):
                    partial_exec[i] = pe
            exec_wall = time.perf_counter() - t_exec
            for k, recs, dt in done:
                server_wall[k] = dt
                for i, rec in zip(by_server[k], recs):
                    records[i] = rec
            for i, pe in partial_exec.items():
                if pe.fallback:
                    assigned[i] = -1   # ran whole at the cloud; say so
                wall = sum(pe.per_server_seconds.values())
                records[i] = ExecutionRecord.of(
                    pe.result, list(queries[i][1].projection), wall)
                if collect_results:
                    results[i] = pe.result
                for sid, dts in pe.per_server_seconds.items():
                    server_wall[sid] = server_wall.get(sid, 0.0) + dts

        # counts reflect what actually RAN (stale partial plans fell back
        # to the cloud above and were reassigned)
        counts: dict[int, int] = {}
        for k in assigned:
            counts[k] = counts.get(k, 0) + 1

        outcomes: list[QueryOutcome] = []
        for i, (user, q) in enumerate(queries):
            k = assigned[i]
            pe = partial_exec.get(i)
            p_servers: tuple = ()
            p_bits = 0.0
            rec = records[i]
            if k == PARTIAL:
                modeled = partial_free_cost(tasks.partial_option(i),
                                            float(tasks.w[i]), params_batch,
                                            i)
                if pe is not None:
                    p_servers, p_bits = pe.servers, pe.shipped_bits
            elif k >= 0:
                modeled = (tasks.c[i] / max(sr.f[i, k], 1e-30)
                           + tasks.w[i] / params_batch.r_edge[i, k])
            else:
                modeled = (tasks.w[i] / params_batch.r_cloud[i]
                           + tasks.c[i] / params_batch.F_cloud)
            if rec is not None:
                if k == PARTIAL:
                    realized = self._realized_partial_latency(
                        pe, rec, i, params_batch)
                else:
                    realized = self._realized_latency(rec, i, k, sr,
                                                      params_batch)
                n_matches, wall = rec.n_matches, rec.wall_seconds
            else:
                realized, n_matches, wall = modeled, 0, 0.0
            if observe:
                self._observe_pattern(user, q)
            outcomes.append(QueryOutcome(
                user=user, assigned_to=k, modeled_latency=float(modeled),
                realized_latency=float(realized),
                measured_exec_seconds=wall, n_matches=n_matches,
                executable_edges=np.flatnonzero(tasks.e[i]).tolist(),
                partial_servers=p_servers, shipped_bits=float(p_bits)))
        shipped_total = sum(pe.shipped_bits for pe in partial_exec.values()
                            if not pe.fallback)
        return RoundReport(policy=policy, outcomes=outcomes,
                           objective=sr.objective,
                           schedule_seconds=sched_dt,
                           assignment_counts=counts,
                           overlapped=bool(mode and execute),
                           overlap_mode=mode if execute else "",
                           execute_wall_seconds=exec_wall,
                           server_wall_seconds=server_wall,
                           results=results,
                           partial_queries=sum(1 for k in assigned
                                               if k == PARTIAL),
                           partial_bytes_shipped=int(shipped_total // 8),
                           partial_fallbacks=sum(
                               1 for pe in partial_exec.values()
                               if pe.fallback),
                           schedule_info=dict(sr.info))

    # -- live ingest (the write path) ----------------------------------------
    def apply_update(self, update) -> IngestReport:
        """THE ingest path: execute one SPARQL UPDATE against the live
        system.

        ``update`` is an update text, a parsed
        :class:`~repro_torch.sparql.query.ParsedUpdate`, or a compiled
        :class:`~repro_torch.sparql.update.CompiledUpdate`. Under the placement
        lock (so no query round ever observes a half-applied write):

        1. compile through the shared dictionary (new INSERT DATA terms
           bump ``Dictionary.version`` — plan memos keyed on it invalidate);
        2. turn it into a version-guarded cloud :class:`TripleDelta`
           (``DELETE WHERE`` evaluates its template here, against the
           locked store) and apply it — :meth:`ShardedTripleStore.
           apply_delta` routes rows to owning shards id-stably, mutating
           only touched shards;
        3. carry the :class:`InducedIndex` memo forward for patterns whose
           edge labels are disjoint from the delta's predicates (their
           matched-triple *content* provably cannot change — every matched
           triple carries one of the pattern's bound labels), remapping
           their edge ids into the new global id space; patterns touching
           a written predicate (or with a variable-predicate edge) are
           invalidated and re-match lazily;
        4. propagate version-consistently to every edge holding data: each
           edge's residency is re-derived against the new cloud (memo hits
           for carried patterns) and shipped as a content delta through the
           existing pipeline, then its index republishes at the new cloud
           version — feasibility certificates never go stale.
        """
        from ..sparql.query import ParsedUpdate, parse_update
        from ..sparql.update import (CompiledUpdate, compile_update,
                                     ground_delta, where_evict_rows)
        if isinstance(update, str):
            update = parse_update(update, self.dictionary)
        if isinstance(update, ParsedUpdate):
            update = compile_update(update, self.dictionary)
        if not isinstance(update, CompiledUpdate):
            raise TypeError(f"not an update: {type(update).__name__}")
        from ..rdf.deltas import TripleDelta
        with self._placement_lock:
            cloud = self.cloud.store
            if update.where is not None:
                delta = TripleDelta(base_version=cloud.version,
                                    evict=where_evict_rows(update, cloud))
            else:
                delta = ground_delta(update, cloud)
            rep = self._apply_cloud_delta(delta,
                                          update.touched_predicates())
            rep.kind = update.kind
            rep.new_terms = update.new_terms
            rep.dropped_rows = update.dropped_rows
            return rep

    def apply_delta(self, add=None, evict=None) -> IngestReport:
        """Raw-rows ingest: apply ``[N, 3]`` add/evict triple rows to the
        cloud through the same locked path as :meth:`apply_update` (bulk
        loaders and tests write here; SPARQL UPDATE compiles onto it)."""
        from ..rdf.deltas import as_rows
        from ..sparql.update import CompiledUpdate, ground_delta
        cu = CompiledUpdate(
            kind="raw",
            add=as_rows(add if add is not None
                        else np.zeros((0, 3), dtype=np.int64)),
            evict=as_rows(evict if evict is not None
                          else np.zeros((0, 3), dtype=np.int64)))
        with self._placement_lock:
            delta = ground_delta(cu, self.cloud.store)
            rep = self._apply_cloud_delta(delta, cu.touched_predicates())
            rep.kind = "raw"
            return rep

    def _apply_cloud_delta(self, delta,
                           touched: set[int] | None) -> IngestReport:
        """Commit one cloud delta + memo carry-forward + edge propagation.
        Caller holds the placement lock."""
        from ..rdf.deltas import delta_between, rows_at
        t0 = time.perf_counter()
        cloud = self.cloud.store
        v_before = cloud.version
        rep = IngestReport(n_add=delta.n_add, n_evict=delta.n_evict,
                           touched_predicates=(None if touched is None
                                               else sorted(touched)),
                           cloud_version_before=v_before,
                           cloud_version=v_before,
                           placement_epoch=self.placement_epoch)
        if delta.is_noop:
            rep.apply_seconds = time.perf_counter() - t0
            return rep

        old_rows = cloud.triples()               # pre-write content snapshot
        old_entries = self.induced.entries_for(v_before)
        cloud.apply_delta(delta)                 # id-stable shard routing
        rep.cloud_version = cloud.version

        # induced-memo carry-forward: a pattern is untouched iff every edge
        # label is bound AND outside the written predicate set — then its
        # matched-triple content is unchanged and only the global ids moved
        # (stores re-sort on mutation). One bytewise argsort of the new
        # content remaps all survivors.
        survivors: dict[tuple, np.ndarray] = {}
        if old_entries:
            sorted_flat = order = None
            void = np.dtype((np.void, old_rows.dtype.itemsize * 3))
            for key, eids in old_entries.items():
                labels = _pattern_key_labels(key)
                if (touched is None or VAR_PRED_LABEL in labels
                        or labels & touched):
                    rep.patterns_invalidated += 1
                    continue
                if not len(eids):
                    survivors[key] = eids
                    continue
                if sorted_flat is None:
                    new_flat = np.ascontiguousarray(
                        cloud.triples()).view(void).ravel()
                    order = np.argsort(new_flat)
                    sorted_flat = new_flat[order]
                keys = np.ascontiguousarray(
                    old_rows[eids]).view(void).ravel()
                pos = np.searchsorted(sorted_flat, keys)
                # untouched-pattern invariant: every matched row survived
                assert np.array_equal(sorted_flat[pos], keys), \
                    "carry-forward remap lost rows of an untouched pattern"
                survivors[key] = np.sort(order[pos])
        rep.patterns_carried = len(survivors)
        self.induced.install(cloud.version, survivors)

        # version-consistent propagation: every edge with resident data
        # re-derives its residency against the NEW cloud (memo hits for
        # carried patterns, fresh matches for invalidated ones) and takes
        # the content diff through the existing delta pipeline
        for es in self.edges:
            if es.store is None:
                continue
            resident = dict(es._resident)
            target = self.induced.union_edge_ids(cloud,
                                                 list(resident.values()))
            edge_delta = delta_between(es.store, rows_at(cloud, target))
            if not edge_delta.is_noop:
                es.store.apply_delta(edge_delta)
                rep.edges_updated += 1
                rep.shipped_bytes += edge_delta.shipped_bytes
            es._publish(resident, target, cloud.version)
        self.placement_epoch += 1
        rep.placement_epoch = self.placement_epoch
        rep.apply_seconds = time.perf_counter() - t0
        return rep

    def rebalance_pipeline(self, epochs: int = 2,
                           use_deltas: bool = True) -> list[RebalanceReport]:
        """Run ``epochs`` pipelined rebalance passes (compute N+1 overlaps
        commit N; writes admitted between epochs) — see
        :meth:`repro_torch.edge.rebalance.RebalanceManager.run_pipeline`."""
        return self.rebalancer.run_pipeline(epochs=epochs,
                                            use_deltas=use_deltas)

    def rebalance_all(self, use_deltas: bool = True,
                      ) -> dict[int, tuple[int, int]]:
        """Synchronous dynamic placement update across edge servers.

        Runs the full :class:`repro_torch.edge.rebalance.RebalanceManager`
        pipeline inline (incremental induced-id memo, delta shipping,
        epoch-barrier commit) and returns ``{server_id: (n_added,
        n_evicted)}``; the full :class:`~repro_torch.edge.rebalance.
        RebalanceReport` (bytes shipped, per-edge modes, timings) is kept
        on ``self.last_rebalance``. ``use_deltas=False`` re-ships full
        induced subgraphs (the pre-delta data-plane, kept for A/B).
        """
        return self.rebalancer.run(use_deltas=use_deltas).changes

    def rebalance_async(self, use_deltas: bool = True) -> RebalanceHandle:
        """Kick off a rebalance overlapping query rounds (paper §3.2's
        "asynchronous background task"). The expensive compute phase runs
        on a daemon thread; only the commit waits for the round barrier.
        ``handle.join()`` returns the :class:`RebalanceReport`."""
        return self.rebalancer.start(use_deltas=use_deltas)
