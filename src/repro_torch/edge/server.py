"""Edge and cloud servers.

An edge server hosts pattern-induced subgraphs for a resident pattern set
(selected under its storage budget — total bytes plus optional per-shard
budgets on sharded deployments) plus the hash-code pattern index used for
O(1) executability checks. The cloud hosts the full graph.

Both execute queries with the same vectorized matcher — the paper's
completeness guarantee (matches over G[P] == matches over G for queries
isomorphic to a resident pattern) is what makes edge execution correct, and
is checked against the cloud by ``tests/test_torch_edge_system.py``.

Residency is tracked in **cloud-global edge ids** (``resident_eids``), the
id-stable coordinate system across placement changes: per-pattern induced
edge ids come from a shared, memoized
:class:`repro_torch.core.induced.InducedIndex` (keyed ``(cloud version, pattern
key)``, so unchanged patterns cost zero matcher calls), and a residency
change is committed either as a :class:`repro_torch.rdf.deltas.TripleDelta`
applied to the edge store *in place* (shipping only the diff) or as a full
``subgraph`` rebuild. :meth:`EdgeServer.commit_residency` updates the store
and republishes the pattern index together — callers serialize commits
against query rounds (the epoch barrier in
:class:`repro_torch.edge.system.EdgeCloudSystem`), so the scheduler's
feasibility matrix can never observe a half-applied placement.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..core.cost import result_bits
from ..core.induced import InducedIndex
from ..core.pattern import Pattern, PatternIndex
from ..core.placement import DynamicPlacement
from ..rdf.deltas import (ADD_WIRE_BYTES, TripleDelta, delta_between,
                          rows_at)
from ..rdf.graph import RDFStore, triples_size_bytes
from ..sparql.algebra import execute_any_batch
from ..sparql.engine import QueryEngine
from ..sparql.matcher import MatchResult


@dataclass
class ExecutionRecord:
    n_matches: int
    wall_seconds: float
    result_bits: float
    # per-phase engine wall (prescan + join seconds) attributable to this
    # query — the realized-latency cost model derives measured cloud cycles
    # from it instead of final row counts alone (see
    # :func:`repro_torch.core.cost.measured_cycles`); 0.0 when unavailable
    engine_seconds: float = 0.0

    @classmethod
    def of(cls, res: MatchResult, projection: list[str],
           wall_seconds: float,
           engine_seconds: float = 0.0) -> "ExecutionRecord":
        """Build from a match result; ``result_bits`` goes through the
        single-sourced :func:`repro_torch.core.cost.result_bits` conversion."""
        return cls(n_matches=res.num_matches, wall_seconds=wall_seconds,
                   result_bits=result_bits(res, projection),
                   engine_seconds=engine_seconds)


def _execute_batch(store: RDFStore, engine: QueryEngine,
                   queries: list,
                   ) -> list[tuple[MatchResult, ExecutionRecord]]:
    """Run one server's batch through the engine; wall time is apportioned
    evenly across the batch (scans/cache are shared, so per-query isolation
    is not measurable — Eq. 5 accounting only needs the total).

    ``queries`` may mix plain :class:`QueryGraph`\\ s and compiled algebra
    plans (:mod:`repro_torch.sparql.algebra`): all BGP leaves share ONE engine
    batch, and an algebra result is a
    :class:`~repro_torch.sparql.algebra.SolutionTable` (same cost-accounting
    surface as :class:`MatchResult`)."""
    s = engine.stats
    e0 = s.prescan_seconds + s.join_seconds
    t0 = time.perf_counter()
    results = execute_any_batch(store, engine, queries)
    wall = time.perf_counter() - t0
    # per-phase engine seconds this batch spent scanning + joining. The
    # stats object is shared across overlapped server batches, so the delta
    # is clamped to this batch's own wall before apportioning — a
    # concurrent thread's phase time can inflate the counter but never
    # charge more than the time that actually elapsed here.
    # the 1ns floor marks "measured (served from cache, essentially
    # free)" as distinct from "not measured" for measured_cycles
    eng = max(min(s.prescan_seconds + s.join_seconds - e0, wall), 1e-9)
    per_q = wall / max(1, len(queries))
    per_e = eng / max(1, len(queries))
    return [(res, ExecutionRecord.of(res, list(q.projection), per_q, per_e))
            for q, res in zip(queries, results)]


class CloudServer:
    """Holds the complete RDF graph G — monolithic or sharded
    (any :class:`RDFStore`)."""

    def __init__(self, store: RDFStore,
                 engine: QueryEngine | None = None) -> None:
        self.store = store
        self.engine = engine or QueryEngine()

    def execute(self, q) -> tuple[MatchResult, ExecutionRecord]:
        return _execute_batch(self.store, self.engine, [q])[0]

    def execute_batch(self, queries: list,
                      ) -> list[tuple[MatchResult, ExecutionRecord]]:
        return _execute_batch(self.store, self.engine, queries)


class EdgeServer:
    """Stores pattern-induced subgraphs G[P] + the pattern index."""

    def __init__(self, server_id: int, storage_budget_bytes: int,
                 compute_cycles_per_s: float,
                 engine: QueryEngine | None = None,
                 shard_budgets=None,
                 induced: InducedIndex | None = None) -> None:
        self.server_id = server_id
        self.budget = int(storage_budget_bytes)
        self.F = float(compute_cycles_per_s)
        self.engine = engine or QueryEngine()
        self.placement = DynamicPlacement(budget_bytes=self.budget,
                                          shard_budgets=shard_budgets)
        self.induced = induced if induced is not None else InducedIndex()
        self.index = PatternIndex()
        self.store: RDFStore | None = None
        self._resident: dict[tuple, Pattern] = {}
        # cloud-global edge ids backing ``store``, plus the cloud version
        # they were derived against: edge ids are only id-stable while the
        # cloud holds that version (the cloud itself may move through
        # apply_delta — live ingest), so both are needed to decide whether
        # residency is current and whether the cheap id-space diff is sound
        self.resident_eids: np.ndarray = np.zeros(0, dtype=np.int64)
        self.resident_cloud_version = None

    # -- deployment ---------------------------------------------------------
    def measure_pattern(self, cloud_store: RDFStore, p: Pattern) -> int:
        """Compute |G[{p}]| bytes (memoized via the shared induced index);
        records total and per-shard sizes with the placement policy."""
        eids = self.induced.edge_ids(cloud_store, p)
        nbytes = triples_size_bytes(len(eids))
        self.placement.set_size(p, nbytes,
                                self._shard_split(cloud_store, eids))
        return nbytes

    @staticmethod
    def _shard_split(cloud_store: RDFStore,
                     eids: np.ndarray) -> dict[int, int] | None:
        """Per-shard byte footprint of an induced edge set (sharded cloud
        only). Edge stores inherit the cloud's shard count and predicate
        hash through ``subgraph``/deltas, so the cloud-side split IS the
        edge-side placement footprint."""
        shards = getattr(cloud_store, "shards", None)
        if shards is None or not len(eids):
            return None
        from ..rdf.sharding import shard_of_pred
        owner = shard_of_pred(cloud_store.p[eids],
                              cloud_store.num_shards).astype(np.int64)
        counts = np.bincount(owner, minlength=cloud_store.num_shards)
        return {k: triples_size_bytes(int(c))
                for k, c in enumerate(counts) if c}

    def deploy(self, cloud_store: RDFStore,
               patterns: list[Pattern]) -> None:
        """Materialize G[P] for the given resident set (full rebuild).

        Built through the :class:`RDFStore` protocol: ``subgraph`` preserves
        the cloud store's kind, so a sharded cloud yields sharded
        pattern-induced edge stores (possibly with empty shards)."""
        resident = {p.key: p for p in patterns if p.indexable}
        eids = self.induced.union_edge_ids(cloud_store,
                                           list(resident.values()))
        self._publish(resident, eids, cloud_store.version,
                      store=cloud_store.subgraph(eids))

    def _publish(self, resident: dict[tuple, Pattern], eids: np.ndarray,
                 cloud_version, store: RDFStore | None = None) -> None:
        """Republish residency state: store (if given), pattern index, and
        placement bookkeeping — together, so executability lookups and the
        data they promise can never disagree."""
        self._resident = resident
        if store is not None:
            self.store = store
        self.resident_eids = eids
        self.resident_cloud_version = cloud_version
        self.index = PatternIndex()
        for p in resident.values():
            self.index.add(p, self.server_id)
        self.placement.resident = set(resident)

    def commit_residency(self, cloud_store: RDFStore,
                         chosen: set[tuple], target_eids: np.ndarray,
                         delta: TripleDelta | None = None) -> str:
        """Commit a planned residency (see :mod:`repro_torch.edge.rebalance`).

        Applies ``delta`` to the live store in place when it still matches
        the store's version; otherwise falls back to a full ``subgraph``
        rebuild (first deployment, or the store moved since the delta was
        computed). Returns ``"delta"``, ``"full"``, or ``"noop"``.
        """
        resident = {k: self.placement.patterns[k] for k in chosen}
        if (delta is not None and self.store is not None
                and delta.base_version == self.store.version):
            if not delta.is_noop:
                self.store.apply_delta(delta)
            self._publish(resident, target_eids, cloud_store.version)
            return "delta" if not delta.is_noop else "noop"
        self._publish(resident, target_eids, cloud_store.version,
                      store=cloud_store.subgraph(target_eids))
        return "full"

    def plan_rebalance(self, cloud_store: RDFStore, use_delta: bool = True,
                       ) -> tuple[set, set, set, np.ndarray,
                                  TripleDelta | None, bool]:
        """Measure + plan a residency update WITHOUT committing it.

        Returns ``(chosen, added, evicted, target_eids, delta,
        needs_commit)``; the expensive parts (matching new patterns,
        diffing content) happen here, off the commit path, against a cloud
        store that is immutable while this runs (one rebalance at a time).

        ``needs_commit`` is true when the resident pattern set changed OR
        the data behind an unchanged pattern set moved: the cloud store
        itself may advance through ``apply_delta`` (live ingest), which
        both shifts the cloud id space and changes induced edge sets — so
        staleness is judged against ``resident_cloud_version`` and the
        freshly computed ``target_eids``, never against pattern add/evict
        counts alone. The cheap id-space diff is sound only while the
        cloud still holds the version residency was derived against;
        after a cloud move the content-based :func:`~repro_torch.rdf.deltas.
        delta_between` diff is used instead (ids are not comparable
        across cloud versions, triple content always is).
        """
        for k, p in list(self.placement.patterns.items()):
            if k not in self.placement.sizes:
                self.measure_pattern(cloud_store, p)
        chosen, added, evicted = self.placement.plan()
        target_eids = self.induced.union_edge_ids(
            cloud_store, [self.placement.patterns[k] for k in chosen])
        ids_stable = cloud_store.version == self.resident_cloud_version
        needs_commit = bool(
            added or evicted or self.store is None or not ids_stable
            or not np.array_equal(target_eids, self.resident_eids))
        delta = None
        if use_delta and self.store is not None and needs_commit:
            if ids_stable:
                # id-stable diff: residency ids and target ids live in the
                # SAME cloud version's id space, and the cloud store is
                # deduplicated, so id set-difference IS row set-difference
                # — far cheaper than row-wise set algebra
                delta = TripleDelta(
                    base_version=self.store.version,
                    add=rows_at(cloud_store,
                                np.setdiff1d(target_eids,
                                             self.resident_eids)),
                    evict=rows_at(cloud_store,
                                  np.setdiff1d(self.resident_eids,
                                               target_eids)))
            else:
                delta = delta_between(self.store,
                                      rows_at(cloud_store, target_eids))
            if delta.shipped_bytes >= len(target_eids) * ADD_WIRE_BYTES:
                # near-total churn: the diff costs more on the wire than
                # re-shipping the (smaller) target outright — let the
                # commit fall back to a full rebuild
                delta = None
        return chosen, added, evicted, target_eids, delta, needs_commit

    def rebalance(self, cloud_store: RDFStore,
                  use_delta: bool = True) -> tuple[int, int]:
        """Synchronous single-server dynamic update (paper §3.2).

        Plan + commit in one step; returns (n_added, n_evicted) pattern
        counts. The system-level path (:meth:`repro_torch.edge.system.
        EdgeCloudSystem.rebalance_all` / ``rebalance_async``) goes through
        :class:`repro_torch.edge.rebalance.RebalanceManager` instead, which
        separates this into an overlap-safe compute phase and an epoch-
        barrier commit.
        """
        chosen, added, evicted, eids, delta, needs_commit = \
            self.plan_rebalance(cloud_store, use_delta)
        if needs_commit:
            self.commit_residency(cloud_store, chosen, eids, delta)
        return len(added), len(evicted)

    # -- query path ----------------------------------------------------------
    def can_execute(self, q_pattern: Pattern) -> bool:
        return bool(self.index.lookup(q_pattern))

    def execute(self, q) -> tuple[MatchResult, ExecutionRecord]:
        assert self.store is not None, "edge server has no deployed data"
        return _execute_batch(self.store, self.engine, [q])[0]

    def execute_batch(self, queries: list,
                      ) -> list[tuple[MatchResult, ExecutionRecord]]:
        assert self.store is not None, "edge server has no deployed data"
        return _execute_batch(self.store, self.engine, queries)

    def used_bytes(self) -> int:
        return self.store.size_bytes() if self.store is not None else 0
