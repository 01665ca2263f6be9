"""Micro-batch admission queue — the concurrency front end of the endpoint.

The engine's whole advantage is batching: `SparqlEndpoint.query_many`
dedups repeated texts, prescans every BGP leaf of the batch together, and
lets alpha-equivalent sub-BGPs share result-cache entries. A network front
end that forwards each arriving request one at a time throws all of that
away. :class:`AdmissionQueue` restores it for concurrent traffic:

- ``submit(text)`` parses eagerly (syntax errors are rejected before they
  occupy a queue slot), enqueues a :class:`Ticket`, and wakes the
  dispatcher. The caller blocks on ``ticket.result()``.
- The dispatcher opens a **micro-batch window** at the first arrival: it
  sleeps until ``first_arrival + window_s`` (or until ``max_batch``
  tickets queued), then drains up to ``max_batch`` tickets, drops the ones
  whose deadline already passed (they fail with :class:`DeadlineExceeded`
  — a query that can't make its deadline must not occupy engine time),
  and executes the survivors as ONE engine batch.
- The queue is bounded: when ``max_queue`` tickets are waiting, ``submit``
  raises :class:`AdmissionFullError` carrying a suggested retry delay —
  the HTTP layer maps it to ``503 + Retry-After``. Backpressure beats an
  unbounded queue whose tail latency grows without limit.

``window_s=0.0, max_batch=1`` degenerates to sequential per-request
dispatch — the baseline mode of the reference package's
``benchmarks/bench_serving.py``.

Execution modes (``mode=``):

- ``"endpoint"`` (default): ``endpoint.query_many`` — one engine batch.
- ``"round"``: ``endpoint.run_round(..., collect_results=True)`` — the
  batch is B&B-scheduled across the attached system's edge servers.
- ``"pool"``: ``endpoint.admit_many`` through the attached
  :class:`~repro_torch.runtime.serving.OffloadServingPool`.

Per-batch provenance lands in :class:`BatchStats` (queue depth at close,
window fill, coalesced size, endpoint-memo and engine-cache hit deltas);
:class:`AdmissionStats` aggregates across the queue's lifetime — both feed
``bench_serving`` and the HTTP ``/stats`` route.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class AdmissionError(Exception):
    """Base class for admission-layer failures."""


class AdmissionFullError(AdmissionError):
    """Queue at capacity — back off and retry (HTTP 503)."""

    def __init__(self, retry_after_s: float) -> None:
        super().__init__(f"admission queue full; retry after "
                         f"{retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s


class DeadlineExceeded(AdmissionError):
    """Ticket deadline passed before its batch dispatched (HTTP 504)."""


class AdmissionClosed(AdmissionError):
    """Queue closed while the ticket was pending."""


class Ticket:
    """One admitted request (query or update): a thread-safe future the
    submitter blocks on. Query tickets resolve to a solution table; update
    tickets resolve to the endpoint's ack dict."""

    __slots__ = ("text", "user", "enqueued_at", "deadline",
                 "_event", "_value", "_error", "batch_seq", "is_update")

    def __init__(self, text: str, user: int,
                 enqueued_at: float, deadline: float | None,
                 is_update: bool = False) -> None:
        self.text = text
        self.user = user
        self.enqueued_at = enqueued_at
        self.deadline = deadline            # monotonic seconds, or None
        self.is_update = is_update
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None
        self.batch_seq: int | None = None   # which batch served it

    def _resolve(self, value) -> None:
        self._value = value
        self._event.set()

    def _reject(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Block until served; raises the stored error on failure."""
        if not self._event.wait(timeout):
            raise TimeoutError("ticket not served within timeout")
        if self._error is not None:
            raise self._error
        return self._value


@dataclass
class BatchStats:
    """Provenance of one dispatched micro-batch."""

    seq: int                      # batch sequence number
    size: int                     # tickets executed
    unique_texts: int             # distinct query texts in the batch
    expired: int                  # tickets dropped at dispatch (deadline)
    queue_depth: int              # tickets still waiting after the drain
    window_fill: float            # size / max_batch
    wait_seconds: float           # mean enqueue -> dispatch wait
    exec_seconds: float           # engine batch wall clock
    memo_hits: int                # endpoint full-result memo hits (delta)
    engine_cache_hits: int        # engine result-cache hits (delta)
    scans_deduped: int            # engine scan dedups (delta)
    write_commits: int = 0        # store commits this window's writes took
    # scheduler provenance (mode="round"/"pool" only): per-assignment
    # counts (-1 cloud, -2 partial, k per edge/replica) and the modeled
    # scheduling objective of the window's read batch
    assignment_counts: dict | None = None
    objective: float | None = None


@dataclass
class AdmissionStats:
    """Lifetime aggregates across all batches."""

    submitted: int = 0
    completed: int = 0
    rejected: int = 0             # queue-full refusals
    expired: int = 0              # deadline drops
    failed: int = 0               # engine errors
    batches: int = 0
    max_coalesced: int = 0        # largest batch dispatched
    updates_served: int = 0       # update tickets acked
    write_commits: int = 0        # store commits those updates took
    # lifetime scheduler-decision totals (round/pool modes): assignment
    # sentinel (-1 cloud, -2 partial, k per edge) -> queries routed there
    assignment_counts: dict = field(default_factory=dict)
    recent: list = field(default_factory=list)   # last BatchStats

    @property
    def mean_batch_size(self) -> float:
        served = self.completed + self.failed
        return served / self.batches if self.batches else 0.0

    @property
    def writes_coalesced(self) -> int:
        """Commits amortized away by window-level write coalescing."""
        return self.updates_served - self.write_commits

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted, "completed": self.completed,
            "rejected": self.rejected, "expired": self.expired,
            "failed": self.failed, "batches": self.batches,
            "max_coalesced": self.max_coalesced,
            "mean_batch_size": round(self.mean_batch_size, 3),
            "updates_served": self.updates_served,
            "write_commits": self.write_commits,
            "writes_coalesced": self.writes_coalesced,
            "assignment_counts": {str(k): v for k, v in
                                  sorted(self.assignment_counts.items())},
        }


_RECENT_BATCHES = 64              # BatchStats ring kept for /stats


class AdmissionQueue:
    """Bounded micro-batch admission in front of a `SparqlEndpoint`.

    Parameters
    ----------
    endpoint : SparqlEndpoint
    window_s : float
        Micro-batch window: the dispatcher waits this long after the FIRST
        arrival before draining, so concurrently arriving queries coalesce.
        ``0.0`` dispatches immediately (with ``max_batch=1``: sequential).
    max_batch : int
        Hard cap per dispatched batch; a full window closes early.
    max_queue : int
        Bound on waiting tickets; beyond it ``submit`` raises
        :class:`AdmissionFullError` (HTTP 503 + Retry-After).
    default_timeout_s : float | None
        Per-query deadline applied when the submitter gives none; ``None``
        disables deadlines by default.
    mode : str
        ``"endpoint"`` | ``"round"`` | ``"pool"`` (see module docstring).
    mode_kw : dict | None
        Extra keyword arguments forwarded to the mode's dispatch call
        (``run_round`` / ``admit_many``) — e.g. ``{"policy": "greedy"}``
        to cap scheduling cost on large coalesced batches (B&B placement
        is exponential in batch size). Ignored by ``mode="endpoint"``.
    retry_after_s : float
        Suggested client back-off carried by :class:`AdmissionFullError`.
    coalesce_writes : bool
        Merge each window's ground updates (``INSERT DATA`` / ``DELETE
        DATA``) into ONE store commit via ``endpoint.update_many`` —
        arrival-order semantics and per-ticket failure isolation are
        preserved, but remap/edge-propagation cost is paid once per window
        instead of once per write. ``DELETE WHERE`` still commits
        individually at its arrival position.
    """

    def __init__(self, endpoint, *, window_s: float = 0.002,
                 max_batch: int = 64, max_queue: int = 1024,
                 default_timeout_s: float | None = None,
                 mode: str = "endpoint",
                 mode_kw: dict | None = None,
                 retry_after_s: float = 0.05,
                 coalesce_writes: bool = False) -> None:
        if mode not in ("endpoint", "round", "pool"):
            raise ValueError(f"unknown admission mode {mode!r}")
        if mode == "round" and endpoint.system is None:
            raise ValueError("mode='round' needs an endpoint with a "
                             "system attached")
        if mode == "pool" and endpoint.pool is None:
            raise ValueError("mode='pool' needs an endpoint with a "
                             "pool attached")
        self.endpoint = endpoint
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.default_timeout_s = default_timeout_s
        self.mode = mode
        self.mode_kw = dict(mode_kw or {})
        self.retry_after_s = float(retry_after_s)
        self.coalesce_writes = bool(coalesce_writes)
        self.stats = AdmissionStats()
        self._queue: list[Ticket] = []
        self._cond = threading.Condition()
        self._closed = False
        self._seq = 0
        self._batch_log: list | None = None
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="admission-dispatcher",
            daemon=True)
        self._dispatcher.start()

    # -- client side ---------------------------------------------------------
    def submit(self, text: str, *, user: int = 0,
               timeout_s: float | None = None) -> Ticket:
        """Admit one query; returns a :class:`Ticket` to block on.

        Parses eagerly: a syntactically invalid query raises
        :class:`~repro_torch.sparql.query.ParseError` HERE, before the query
        occupies a queue slot (and the compiled plan is memoized, so the
        dispatcher's later parse is free).

        SPARQL UPDATE texts (``INSERT DATA`` / ``DELETE DATA`` / ``DELETE
        WHERE``) are admitted through the same queue: their ticket resolves
        to the write ack, and the write serializes against the micro-batch
        window it shares — every query in the window reads the pre-window
        store, the write commits after (see :meth:`_execute_batch`).
        """
        from ..sparql.query import is_update_text, parse_update
        is_upd = is_update_text(text)
        if is_upd:
            # eager syntax check only — compilation may mint dictionary
            # terms, which must happen at COMMIT time under the system's
            # placement lock, not at admission
            parse_update(text, self.endpoint.dictionary)
        else:
            self.endpoint.parse(text)       # raises ParseError on bad text
        now = time.monotonic()
        timeout = timeout_s if timeout_s is not None else \
            self.default_timeout_s
        deadline = (now + timeout) if timeout is not None else None
        ticket = Ticket(text, user, now, deadline, is_update=is_upd)
        with self._cond:
            if self._closed:
                raise AdmissionClosed("admission queue is closed")
            if len(self._queue) >= self.max_queue:
                self.stats.rejected += 1
                raise AdmissionFullError(self.retry_after_s)
            self._queue.append(ticket)
            self.stats.submitted += 1
            self._cond.notify_all()
        return ticket

    def query(self, text: str, *, user: int = 0,
              timeout_s: float | None = None):
        """Submit + block: the synchronous convenience wrapper."""
        return self.submit(text, user=user, timeout_s=timeout_s).result()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def start_batch_log(self) -> list:
        """Capture every subsequent :class:`BatchStats` into the returned
        list until :meth:`stop_batch_log`. Unlike ``stats.recent`` (a
        ring trimmed to the last 64 batches) the log grows without bound,
        so a measurement window spanning many dispatch windows — e.g.
        ``workload.replay`` — sees its full batch trajectory. Starting a
        new log replaces any previous one."""
        log: list = []
        self._batch_log = log
        return log

    def stop_batch_log(self) -> None:
        """Stop capturing batches; the list from :meth:`start_batch_log`
        keeps whatever was captured."""
        self._batch_log = None

    def close(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop admitting. ``drain=True`` serves already-queued tickets
        first; ``drain=False`` rejects them with :class:`AdmissionClosed`.
        """
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if not drain:
                for t in self._queue:
                    t._reject(AdmissionClosed("queue closed"))
                self._queue.clear()
            self._cond.notify_all()
        self._dispatcher.join(timeout)

    def __enter__(self) -> "AdmissionQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher side -----------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            batch = self._collect_batch()
            if batch is None:
                return
            if batch:
                self._execute_batch(batch)

    def _collect_batch(self) -> list[Ticket] | None:
        """Block for the first arrival, hold the window open, drain.

        Returns ``None`` when the queue is closed and fully drained (the
        dispatcher exits), ``[]`` when every drained ticket had expired.
        """
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                self._cond.wait()
            # window opens at the FIRST waiting arrival; closing early on
            # a full window keeps worst-case wait at window_s even under
            # burst arrival
            window_end = self._queue[0].enqueued_at + self.window_s
            while (len(self._queue) < self.max_batch
                   and not self._closed):
                remaining = window_end - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                if not self._queue:       # spurious wake after a drain
                    return []
            batch = self._queue[:self.max_batch]
            del self._queue[:len(batch)]
            self._depth_after_drain = len(self._queue)
        # deadline enforcement AT dispatch: expired tickets never reach
        # the engine (and never pollute a batch's wall clock)
        now = time.monotonic()
        live, expired = [], []
        for t in batch:
            if t.deadline is not None and now > t.deadline:
                expired.append(t)
            else:
                live.append(t)
        for t in expired:
            t._reject(DeadlineExceeded(
                f"deadline passed {now - t.deadline:.4f}s before dispatch"))
        self.stats.expired += len(expired)
        self._expired_last = len(expired)
        return live

    def _execute_batch(self, batch: list[Ticket]) -> None:
        """Serve one micro-batch: queries first (ONE engine batch against
        the pre-window store), then updates in arrival order.

        This is the write-serialization contract: an update admitted into
        a window commits only AFTER every query of that window has read —
        so reads in the window observe one consistent store version, and
        the write's version bump (store, and dictionary for new terms)
        invalidates exactly the memos it should for the NEXT window. A
        failing update rejects only its own ticket (with
        ``coalesce_writes``, a failing *commit* rejects its whole
        coalesced group — see ``SparqlEndpoint.update_many``).

        In ``mode="round"`` / ``mode="pool"`` the scheduler's per-window
        decisions (full-edge / cloud / partial counts, modeled objective)
        are captured into :class:`BatchStats` and aggregated into
        :class:`AdmissionStats.assignment_counts`.
        """
        ep = self.endpoint
        reads = [t for t in batch if not t.is_update]
        updates = [t for t in batch if t.is_update]
        texts = [t.text for t in batch]
        seq = self._seq
        self._seq += 1
        memo0 = ep.memo_hits
        hits0 = ep.stats.cache_hits
        dedup0 = ep.stats.scans_deduped
        commits0 = ep.write_commits
        assignment_counts: dict | None = None
        objective: float | None = None
        t0 = time.monotonic()
        if reads:
            rtexts = [t.text for t in reads]
            try:
                if self.mode == "round":
                    report = ep.run_round(
                        [(t.user, t.text) for t in reads],
                        collect_results=True, **self.mode_kw)
                    tables = report.results
                    assignment_counts = dict(report.assignment_counts)
                    objective = float(report.objective)
                elif self.mode == "pool":
                    served = ep.admit_many(rtexts, **self.mode_kw)
                    tables = served.responses
                    ks, ns = _np_unique(served.assignments)
                    assignment_counts = dict(zip(ks, ns))
                    objective = float(served.objective)
                else:
                    tables = ep.query_many(rtexts)
            except Exception as err:           # engine-level failure:
                for t in reads:                # fail the window's reads
                    t._reject(err)
                self.stats.failed += len(reads)
                reads = []
            else:
                for ticket, table in zip(reads, tables):
                    ticket.batch_seq = seq
                    ticket._resolve(table)
        served_updates = 0
        if updates and self.coalesce_writes:
            try:
                outs = ep.update_many([t.text for t in updates])
            except Exception as err:
                # an exception escaping the coalesced commit must not
                # strand the window's tickets unresolved (clients poll
                # ticket.done() forever) — reject them all, mirroring
                # the read path
                for t in updates:
                    t._reject(err)
                self.stats.failed += len(updates)
            else:
                for t, out in zip(updates, outs):
                    if isinstance(out, BaseException):
                        t._reject(out)
                        self.stats.failed += 1
                    else:
                        t.batch_seq = seq
                        t._resolve(out)
                        served_updates += 1
        else:
            for t in updates:
                try:
                    ack = ep.update(t.text)
                except Exception as err:
                    t._reject(err)
                    self.stats.failed += 1
                else:
                    t.batch_seq = seq
                    t._resolve(ack)
                    served_updates += 1
        dt = time.monotonic() - t0
        n_ok = len(reads) + served_updates
        self.stats.completed += n_ok
        self.stats.batches += 1
        self.stats.max_coalesced = max(self.stats.max_coalesced,
                                       len(batch))
        self.stats.updates_served += served_updates
        self.stats.write_commits += ep.write_commits - commits0
        if assignment_counts:
            for k, n in assignment_counts.items():
                self.stats.assignment_counts[int(k)] = \
                    self.stats.assignment_counts.get(int(k), 0) + int(n)
        bs = BatchStats(
            seq=seq, size=len(batch), unique_texts=len(set(texts)),
            expired=getattr(self, "_expired_last", 0),
            queue_depth=getattr(self, "_depth_after_drain", 0),
            window_fill=len(batch) / self.max_batch,
            wait_seconds=(t0 - sum(t.enqueued_at for t in batch)
                          / len(batch)),
            exec_seconds=dt,
            memo_hits=ep.memo_hits - memo0,
            engine_cache_hits=ep.stats.cache_hits - hits0,
            scans_deduped=ep.stats.scans_deduped - dedup0,
            write_commits=ep.write_commits - commits0,
            assignment_counts=assignment_counts,
            objective=objective)
        self.stats.recent.append(bs)
        del self.stats.recent[:-_RECENT_BATCHES]
        log = self._batch_log
        if log is not None:
            log.append(bs)


def _np_unique(assignments):
    import numpy as np
    ks, ns = np.unique(np.asarray(assignments, dtype=np.int64),
                       return_counts=True)
    return [int(k) for k in ks], [int(n) for n in ns]
