"""Asynchronous, delta-based placement rebalancing (the paper's "dynamic
update ... as an asynchronous background task", §3.2, made real).

The seed reproduction's ``rebalance_all`` was a synchronous stop-the-world
step: between rounds it re-derived every resident pattern's induced
subgraph and re-shipped entire edge stores. :class:`RebalanceManager`
replaces that with a two-phase pipeline in the spirit of partial-evaluation
distributed SPARQL systems (Peng et al., VLDB'16) — placement maintenance
stays disjoint from the query path:

**Compute phase (overlaps query rounds, takes no system lock).** For every
edge server: measure any observed-but-unmeasured patterns through the
shared :class:`repro_torch.core.induced.InducedIndex` (memoized per ``(cloud
version, pattern key)`` — unchanged patterns cost zero matcher calls), plan
the target residency with :meth:`repro_torch.core.placement.DynamicPlacement.
plan` (total + per-shard budgets, hysteresis) WITHOUT mutating it, and diff
the live edge store against the target into a
:class:`repro_torch.rdf.deltas.TripleDelta`. All of this reads only the immutable
cloud store and the edge stores the manager itself owns mutation of (one
rebalance runs at a time, enforced by an internal lock), so concurrent
query rounds proceed untouched.

**Commit phase (the epoch barrier).** Under the system's placement lock —
the same lock every query round holds from scheduling through execution —
each edge applies its delta in place (or falls back to a full ``subgraph``
rebuild if its store version moved) and republishes its pattern index,
then frequencies decay and ``EdgeCloudSystem.placement_epoch`` advances
once. A round therefore observes either the pre-commit placement or the
post-commit placement, never a half-applied one: the scheduler's
feasibility matrix ``e_nk`` (built from the pattern indexes inside the same
lock) can never route a query to an edge mid-eviction. Commit cost is
array-append/delete on edge-sized stores — the expensive matching already
happened in the compute phase.

``RebalanceManager.start()`` runs compute+commit on a daemon thread and
returns a :class:`RebalanceHandle`; ``run()`` is the synchronous form
(still delta-shipping). ``use_deltas=False`` keeps the full re-ship
data-plane for A/B comparison (bytes shipped and wall-clock).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..rdf.deltas import ADD_WIRE_BYTES


@dataclass
class EdgeRebalance:
    """Per-edge outcome of one rebalance."""

    server_id: int
    n_added: int                  # patterns added to residency
    n_evicted: int                # patterns evicted
    mode: str                     # "delta" | "full" | "noop"
    triples_added: int = 0
    triples_evicted: int = 0
    shipped_bytes: int = 0        # modeled wire bytes actually moved
    full_bytes: int = 0           # counterfactual: full re-ship of target


@dataclass
class RebalanceReport:
    """System-wide outcome of one rebalance epoch."""

    changes: dict[int, tuple[int, int]] = field(default_factory=dict)
    per_edge: list[EdgeRebalance] = field(default_factory=list)
    epoch: int = 0                # placement epoch after commit
    compute_seconds: float = 0.0  # lock-free phase (overlaps rounds)
    commit_seconds: float = 0.0   # under the placement lock (the barrier)
    matcher_calls: int = 0        # induced-id computations actually run
    induced_hits: int = 0         # memoized induced-id lookups

    @property
    def shipped_bytes(self) -> int:
        return sum(e.shipped_bytes for e in self.per_edge)

    @property
    def full_bytes(self) -> int:
        return sum(e.full_bytes for e in self.per_edge)

    @property
    def changed(self) -> bool:
        return any(a or e for a, e in self.changes.values())


class RebalanceHandle:
    """Join handle for a background rebalance (re-raises worker errors)."""

    def __init__(self, thread: threading.Thread) -> None:
        self._thread = thread
        self.report: RebalanceReport | None = None
        self.error: BaseException | None = None

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self, timeout: float | None = None) -> RebalanceReport:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("rebalance still running")
        if self.error is not None:
            raise self.error
        assert self.report is not None
        return self.report


class RebalanceManager:
    """Two-phase (compute || rounds, then epoch-barrier commit) placement
    rebalancer for one :class:`repro_torch.edge.system.EdgeCloudSystem`."""

    def __init__(self, system, use_deltas: bool = True) -> None:
        self.system = system
        self.use_deltas = bool(use_deltas)
        # one rebalance at a time: the compute phase diffs edge stores the
        # commit phase mutates, so overlapping rebalances would race
        self._busy = threading.Lock()
        # test/instrumentation seam: called after compute, before the
        # commit barrier is taken (lets tests pin a round mid-overlap)
        self.pre_commit_hook = None

    # -- phases --------------------------------------------------------------
    def _compute(self, use_deltas: bool) -> list[tuple]:
        """Plan every edge (independent state: own placement/store, shared
        lock-guarded InducedIndex) through the shared thread pool — the
        matcher's NumPy hot paths release the GIL on large arrays, so
        multi-edge plans overlap like server batches do in a round."""
        from ..core.parallel import thread_map
        cloud = self.system.cloud.store
        return thread_map(
            lambda es: (es, *es.plan_rebalance(cloud, use_delta=use_deltas)),
            self.system.edges)

    def _commit(self, plans: list[tuple],
                plan_cloud_version) -> RebalanceReport | None:
        """Apply planned residencies under the epoch barrier.

        Returns ``None`` (caller recomputes) if the cloud store's version
        moved since the plans were computed: every planned ``target_eids``
        / delta is expressed in the plan-time cloud's id space, so
        committing it against a newer cloud would resync edges to stale —
        or, through the full-rebuild fallback, plain wrong — content.
        """
        report = RebalanceReport()
        sys_ = self.system
        with sys_._placement_lock:
            if sys_.cloud.store.version != plan_cloud_version:
                return None
            for es, chosen, added, evicted, eids, delta, needs in plans:
                if needs:
                    mode = es.commit_residency(sys_.cloud.store, chosen,
                                               eids, delta)
                else:
                    mode = "noop"
                # counterfactual full re-ship: every target row crosses the
                # wire (indexes are rebuilt edge-side, so raw rows only)
                full = len(eids) * ADD_WIRE_BYTES if needs else 0
                if mode == "delta" and delta is not None:
                    shipped = delta.shipped_bytes
                    t_add, t_ev = delta.n_add, delta.n_evict
                elif mode == "full" and needs:
                    shipped, t_add, t_ev = full, len(eids), 0
                else:
                    shipped = t_add = t_ev = 0
                report.per_edge.append(EdgeRebalance(
                    server_id=es.server_id, n_added=len(added),
                    n_evicted=len(evicted), mode=mode,
                    triples_added=t_add, triples_evicted=t_ev,
                    shipped_bytes=shipped, full_bytes=full))
                report.changes[es.server_id] = (len(added), len(evicted))
                es.placement.decay_round()
            sys_.placement_epoch += 1
            report.epoch = sys_.placement_epoch
        return report

    def _warm_induced(self) -> None:
        """Next-epoch prefetch: pull every observed pattern's induced edge
        ids into the shared memo against the CURRENT cloud version. Touches
        only the (lock-guarded) InducedIndex and the cloud store — never
        the edge stores a concurrent commit mutates — so it runs while the
        previous epoch commits; the next compute phase then hits the memo
        instead of the matcher. Best-effort: a cloud write mid-prefetch
        just supersedes the warmed version."""
        cloud = self.system.cloud.store
        try:
            for es in self.system.edges:
                for p in list(es.placement.patterns.values()):
                    self.system.induced.edge_ids(cloud, p)
        except Exception:
            pass        # prefetch only; the compute phase recomputes

    def _compute_commit(self, use: bool, max_attempts: int = 3,
                        overlap_next: bool = False) -> RebalanceReport:
        """One epoch: lock-free compute -> (optional next-epoch prefetch
        thread) -> epoch-barrier commit. Caller holds ``_busy``.

        The cloud may advance through live ingest while the lock-free
        compute phase runs; plans are id-space-bound to the version they
        were computed against, so a moved cloud triggers a recompute. If
        sustained write traffic outruns ``max_attempts`` lock-free tries,
        the final attempt computes AND commits atomically inside the
        placement lock (reentrant, so ``_commit`` re-enters it): writes
        queue for the duration of one compute instead of placement
        maintenance wedging forever.
        """
        ind = self.system.induced
        h0, m0 = ind.hits, ind.misses
        compute_dt = commit_dt = 0.0
        report = None
        warm = None
        for _ in range(max_attempts):
            version = self.system.cloud.store.version
            t0 = time.perf_counter()
            plans = self._compute(use)
            compute_dt += time.perf_counter() - t0
            if self.pre_commit_hook is not None:
                self.pre_commit_hook()
            if overlap_next and warm is None:
                # pipeline: epoch N+1's expensive matching overlaps epoch
                # N's commit (the commit never mutates the cloud store the
                # prefetch reads)
                warm = threading.Thread(target=self._warm_induced,
                                        name="rebalance-warm", daemon=True)
                warm.start()
            t1 = time.perf_counter()
            report = self._commit(plans, version)
            commit_dt = time.perf_counter() - t1
            if report is not None:
                break
        if report is None:
            with self.system._placement_lock:
                version = self.system.cloud.store.version
                t0 = time.perf_counter()
                plans = self._compute(use)
                compute_dt += time.perf_counter() - t0
                t1 = time.perf_counter()
                report = self._commit(plans, version)
                commit_dt = time.perf_counter() - t1
            assert report is not None   # version cannot move under the lock
        report.compute_seconds = compute_dt
        report.commit_seconds = commit_dt
        report.matcher_calls = ind.misses - m0
        report.induced_hits = ind.hits - h0
        self.system.last_rebalance = report
        return report

    # -- entry points --------------------------------------------------------
    def run(self, use_deltas: bool | None = None) -> RebalanceReport:
        """Compute + commit, synchronously (but still delta-shipping)."""
        use = self.use_deltas if use_deltas is None else bool(use_deltas)
        with self._busy:
            return self._compute_commit(use)

    def run_pipeline(self, epochs: int = 2,
                     use_deltas: bool | None = None) -> list[RebalanceReport]:
        """Multi-epoch pipelined rebalance for continuous-ingest regimes.

        Runs ``epochs`` back-to-back placement epochs; within each, the
        next epoch's induced-id prefetch overlaps the current commit
        (``_compute_commit(overlap_next=True)``), and BETWEEN epochs no
        lock is held — write traffic (``EdgeCloudSystem.apply_update``)
        and query rounds are admitted freely. Sustained writes can never
        starve an epoch: the per-epoch locked fallback bounds how long the
        cloud can keep moving under a compute phase. Returns the per-epoch
        reports (``system.last_rebalance`` keeps the final one).
        """
        use = self.use_deltas if use_deltas is None else bool(use_deltas)
        reports: list[RebalanceReport] = []
        with self._busy:
            for _ in range(max(1, int(epochs))):
                reports.append(self._compute_commit(use, overlap_next=True))
        return reports

    def start(self, use_deltas: bool | None = None) -> RebalanceHandle:
        """Run the rebalance on a background daemon thread, overlapping
        query rounds; only the commit serializes (epoch barrier)."""
        handle: RebalanceHandle

        def work():
            try:
                handle.report = self.run(use_deltas)
            except BaseException as exc:   # re-raised at join()
                handle.error = exc

        t = threading.Thread(target=work, name="rebalance", daemon=True)
        handle = RebalanceHandle(t)
        t.start()
        return handle
