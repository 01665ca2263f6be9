"""Model serving with the paper's offload scheduler as admission layer.

The MINLP scheduler is workload-agnostic: it places any task with (cycles,
result-bytes, executability mask). Here it routes *inference requests*
across a pool of "edge" replicas (each serving a subset of request classes —
the analogue of pattern residency) and a "cloud" fallback pool, then the
replicas execute their assigned requests in one batch each.

This is the paper's technique as a first-class serving feature — the same
``core.scheduler`` object schedules SPARQL queries in ``repro_torch.edge``
and requests here. Replicas run whatever runner they hold: a SPARQL
runner (:func:`make_sparql_runner`) executes its batch through a query
engine, the torch engine on the card by default.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..core.cost import (DEFAULT_BACKHAUL_BPS, PartialOption, QueryTasks,
                         SystemParams)
from ..core.scheduler import schedule

PARTIAL = -2   # ServedBatch.assignments sentinel: multi-replica partial plan


@dataclass
class Replica:
    """An edge replica: which request classes it serves + its capacity."""

    replica_id: int
    classes: set[int]
    cycles_per_s: float
    link_bps: float                      # replica -> client rate
    runner: Callable | None = None       # batch of requests -> responses


@dataclass
class ServedBatch:
    assignments: np.ndarray              # [N] replica idx, -1 cloud, -2 partial
    objective: float
    schedule_seconds: float
    responses: list = field(default_factory=list)
    # partial-plan accounting: requests served by a multi-replica split
    # (sub-payloads at several replicas, assembled afterwards) and their
    # total estimated inter-replica egress
    partial_queries: int = 0
    partial_bytes_shipped: int = 0


class OffloadServingPool:
    """Schedule + execute one admission batch of requests.

    Replica class sets are the serving analogue of edge pattern residency;
    :meth:`republish` swaps one replica's classes (and optionally its
    runner) atomically under the pool lock and bumps ``epoch`` — the same
    commit-at-a-barrier contract :class:`repro_torch.edge.rebalance.
    RebalanceManager` gives the SPARQL system, so an admission batch
    snapshots ONE epoch's feasibility and never routes a request class to
    a replica mid-swap.
    """

    def __init__(self, replicas: list[Replica], cloud_runner: Callable,
                 cloud_link_bps: float = 5e6,
                 cloud_cycles_per_s: float = np.inf,
                 backhaul_bps: float = DEFAULT_BACKHAUL_BPS) -> None:
        self.replicas = replicas
        self.cloud_runner = cloud_runner
        self.cloud_link_bps = cloud_link_bps
        # generalized-Eq.-5 knobs: a finite cloud capacity prices cloud
        # compute (and partial assembly); ``backhaul_bps`` prices the
        # replica -> assembler egress of partial plans
        self.cloud_cycles_per_s = float(cloud_cycles_per_s)
        self.backhaul_bps = float(backhaul_bps)
        self._lock = threading.Lock()
        self.epoch = 0

    def republish(self, replica_id: int, classes,
                  runner: Callable | None = None) -> int:
        """Atomically update a replica's served classes (+runner); returns
        the new epoch. Concurrent ``admit`` calls see either the old or the
        new class set, never a partial one."""
        with self._lock:
            for rep in self.replicas:
                if rep.replica_id == replica_id:
                    rep.classes = set(classes)
                    if runner is not None:
                        rep.runner = runner
                    break
            else:
                raise KeyError(f"no replica {replica_id!r}")
            self.epoch += 1
            return self.epoch

    def admit(self, requests: list[dict], policy: str = "bnb",
              execute: bool = True, overlap: bool = False,
              max_workers: int | None = None, **sched_kw) -> ServedBatch:
        """requests: dicts with {class_id, cycles, result_bits, payload}.

        ``overlap=True`` runs the per-replica (and cloud-pool) batches
        through a thread pool instead of serializing them — the serving
        analogue of ``EdgeCloudSystem.run_round_batched(overlap=True)``.
        Runners must be thread-safe (``make_sparql_runner`` engines are:
        their caches are lock-guarded).

        A request may carry a ``"partial"`` spec — the serving analogue of
        cloud-edge partial evaluation — giving the scheduler a third,
        multi-replica option priced by the generalized Eq. 5::

            {"replicas": [replica_id, ...],      # contributing replicas
             "cycles": [...], "ship_bits": [...],  # per-replica estimates
             "assemble_cycles": float,           # assembler-side work
             "payloads": {replica_id: payload},  # per-replica sub-payload
             "assemble": callable | None}        # sub-results -> response

        When chosen, its row in ``assignments`` is ``PARTIAL`` (-2): each
        contributing replica runs its sub-payload, and ``assemble`` (or
        plain collection) combines the sub-results. If any contributing
        replica has no runner the whole request transparently falls back
        to the cloud pool with ``payload``.
        """
        N, K = len(requests), len(self.replicas)
        c = np.array([r["cycles"] for r in requests], dtype=np.float64)
        w = np.array([r["result_bits"] for r in requests], dtype=np.float64)
        # snapshot ONE epoch's class sets (and runners), so e_nk rows and
        # dispatch can't straddle a concurrent republish
        with self._lock:
            classes = [set(rep.classes) for rep in self.replicas]
            runners = [rep.runner for rep in self.replicas]
        idx_of = {rep.replica_id: j for j, rep in enumerate(self.replicas)}
        e = np.zeros((N, K))
        for i, r in enumerate(requests):
            for j in range(K):
                if r["class_id"] in classes[j]:
                    e[i, j] = 1.0
        partial: list | None = [None] * N
        for i, r in enumerate(requests):
            spec = r.get("partial")
            if spec is None or e[i].sum() > 0:   # full-replica dominates
                continue
            reps = np.array([idx_of[rid] for rid in spec["replicas"]],
                            dtype=np.int64)
            partial[i] = PartialOption(
                edges=reps,
                cycles=np.asarray(spec["cycles"], dtype=np.float64),
                ship_bits=np.asarray(spec["ship_bits"], dtype=np.float64),
                assemble_cycles=float(spec.get("assemble_cycles", 0.0)),
                plan=spec)
        if not any(p is not None for p in partial):
            partial = None
        params = SystemParams(
            F=np.array([rep.cycles_per_s for rep in self.replicas]),
            r_edge=np.tile(np.array([rep.link_bps
                                     for rep in self.replicas]), (N, 1)),
            r_cloud=np.full(N, self.cloud_link_bps),
            assoc=np.ones((N, K), dtype=bool),
            r_backhaul=np.full(K, self.backhaul_bps),
            F_cloud=self.cloud_cycles_per_s,
        )
        tasks = QueryTasks(c=c, w=w, e=e, partial=partial)
        t0 = time.perf_counter()
        sr = schedule(tasks, params, policy=policy, **sched_kw)
        dt = time.perf_counter() - t0
        assign = np.full(N, -1, dtype=np.int64)
        De = sr.D * e
        for i in range(N):
            if (sr.partial is not None and sr.partial[i]
                    and tasks.partial_option(i) is not None):
                assign[i] = PARTIAL
            elif De[i].sum() > 0:
                assign[i] = int(De[i].argmax())

        responses: list = [None] * N
        shipped_bits = 0.0
        if execute:
            # a replica with no runner cannot execute anything: route its
            # requests to the cloud *and say so* — assignments must report
            # the placement that actually ran, or the Eq. 5 objective and
            # the executed placement disagree (execute=False keeps the raw
            # scheduler output for simulation studies)
            for j in range(K):
                if runners[j] is None:
                    assign[assign == j] = -1
            part_rows = []
            for i in np.flatnonzero(assign == PARTIAL):
                spec = requests[i]["partial"]
                reps = [idx_of[rid] for rid in spec["replicas"]]
                if any(runners[j] is None for j in reps):
                    assign[i] = -1       # runnerless contributor: whole
                    continue             # request falls back to the cloud
                part_rows.append(int(i))
            groups = []
            for j in list(range(K)) + [-1]:
                idx = np.flatnonzero(assign == j)
                if len(idx):
                    groups.append((j, idx))

            def run_group(j: int, idx: np.ndarray):
                runner = self.cloud_runner if j < 0 else runners[j]
                return idx, runner([requests[i]["payload"] for i in idx])

            if overlap:
                from ..core.parallel import thread_map
                done = thread_map(lambda g: run_group(*g), groups,
                                  max_workers)
            else:
                done = [run_group(j, idx) for j, idx in groups]
            for idx, outs in done:
                for i, o in zip(idx, outs):
                    responses[i] = o
            for i in part_rows:
                spec = requests[i]["partial"]
                subs = [runners[idx_of[rid]]([spec["payloads"][rid]])[0]
                        for rid in spec["replicas"]]
                asm = spec.get("assemble")
                responses[i] = asm(subs) if asm is not None else subs
                shipped_bits += float(np.asarray(
                    spec["ship_bits"], dtype=np.float64).sum())
        return ServedBatch(assignments=assign, objective=sr.objective,
                           schedule_seconds=dt, responses=responses,
                           partial_queries=int((assign == PARTIAL).sum()),
                           partial_bytes_shipped=int(shipped_bits // 8))


def make_sparql_runner(store, engine) -> Callable:
    """Replica runner serving SPARQL payloads through a query engine.

    ``store`` is any :class:`repro_torch.rdf.graph.RDFStore` — a monolithic
    :class:`~repro_torch.rdf.graph.TripleStore` or a
    :class:`~repro_torch.rdf.sharding.ShardedTripleStore` (whose bound-predicate
    scans prune to one shard). ``payload`` items are
    :class:`repro_torch.sparql.query.QueryGraph`\\ s and/or compiled algebra
    plans (:mod:`repro_torch.sparql.algebra` — FILTER/OPTIONAL/UNION/modifiers);
    the whole per-replica assignment executes as ONE engine batch (every
    algebra plan's BGP leaves included), so scan dedup, the scan LRU, and
    the result cache apply across the admission batch — the SPARQL
    instantiation of this pool's batch-execution contract. Plain payloads
    yield :class:`~repro_torch.sparql.matcher.MatchResult`\\ s, algebra payloads
    :class:`~repro_torch.sparql.algebra.SolutionTable`\\ s.
    """
    from ..sparql.algebra import execute_any_batch

    def runner(payloads: list) -> list:
        return execute_any_batch(store, engine, list(payloads))
    return runner
