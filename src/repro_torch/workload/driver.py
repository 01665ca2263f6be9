"""Schedule replay through the admission front end, with verification.

:func:`replay` is the harness's measurement loop: it paces a
:class:`~repro_torch.workload.traffic.Schedule` open-loop into an
:class:`~repro_torch.runtime.admission.AdmissionQueue` (latencies are measured
from the *scheduled* arrival, so queueing delay under overload is part of
the number — the coordinated-omission-free convention of
``benchmarks/bench_serving.py``), polls tickets for completion, and folds
the outcome into a :class:`ReplayReport`:

- per-shape (and cold/warm) latency percentiles over completed queries;
- **cardinality verification**: each answered query's row count checked
  against the cardinality recorded at sample time (skipped automatically
  when the schedule's write style can perturb results — see
  :attr:`Schedule.verifiable`);
- the admission layer's cache-hit *trajectory* (per-batch endpoint-memo /
  engine-cache hit deltas in dispatch order — the warmup curve);
- scheduler decisions (full-edge / cloud / partial assignment counts)
  when the queue runs in ``round`` / ``pool`` mode, plus write-coalescing
  provenance when it batches updates.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ClassReport:
    """Latency + verification aggregates for one event class."""

    count: int = 0
    errors: int = 0
    verified: int = 0
    mismatched: int = 0
    latencies: list = field(default_factory=list)

    def percentiles(self) -> dict:
        if not self.latencies:
            return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "mean": 0.0}
        lat = np.asarray(self.latencies)
        return {"p50": float(np.percentile(lat, 50)),
                "p90": float(np.percentile(lat, 90)),
                "p99": float(np.percentile(lat, 99)),
                "mean": float(lat.mean())}

    def as_dict(self) -> dict:
        return {"count": self.count, "errors": self.errors,
                "verified": self.verified, "mismatched": self.mismatched,
                **{k: round(v, 6) for k, v in self.percentiles().items()}}


@dataclass
class ReplayReport:
    """Everything one replay run measured (see module doc)."""

    wall_s: float
    n_events: int
    completed: int
    errors: int
    per_shape: dict
    per_temperature: dict            # "cold" / "warm" ClassReports
    writes: ClassReport
    verified: int
    mismatched: int
    mismatches: list                 # (template, expected, got) samples
    cache_trajectory: list           # per-batch dicts, dispatch order
    assignment_counts: dict
    admission: dict                  # AdmissionStats.as_dict() snapshot

    @property
    def verification_ok(self) -> bool:
        return self.mismatched == 0

    def as_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 4),
            "n_events": self.n_events, "completed": self.completed,
            "errors": self.errors,
            "verified": self.verified, "mismatched": self.mismatched,
            "per_shape": {k: v.as_dict()
                          for k, v in sorted(self.per_shape.items())},
            "per_temperature": {k: v.as_dict() for k, v in
                                sorted(self.per_temperature.items())},
            "writes": self.writes.as_dict(),
            "cache_trajectory": self.cache_trajectory,
            "assignment_counts": {str(k): v for k, v in
                                  sorted(self.assignment_counts.items())},
            "admission": self.admission,
        }


def _observed_rows(table) -> int:
    """Observed solution count for a served query's result table."""
    return int(getattr(table, "num_matches", len(table)))


def replay(queue, schedule, *, speed: float = 1.0,
           verify: bool | None = None,
           max_mismatch_samples: int = 10) -> ReplayReport:
    """Replay ``schedule`` through ``queue`` (see module doc).

    ``speed`` compresses the schedule clock (``2.0`` replays a 1 s
    schedule in 0.5 s of wall time). ``verify=None`` auto-enables
    cardinality checking exactly when :attr:`Schedule.verifiable` holds;
    pass ``True``/``False`` to force. Submission errors (parse failures,
    queue-full rejections, deadline drops) count as ``errors`` per class
    — they never abort the replay.
    """
    if verify is None:
        verify = schedule.verifiable
    events = sorted(schedule.events, key=lambda e: e.at_s)
    # trajectory capture: an unbounded batch log when the queue offers
    # one (stats.recent is a ring trimmed to the last 64 batches, far
    # fewer than a long replay's dispatch windows); otherwise fall back
    # to seq-filtering the ring, which at least never misattributes
    # pre-replay batches
    batch_log = (queue.start_batch_log()
                 if hasattr(queue, "start_batch_log") else None)
    seq0 = max((bs.seq for bs in queue.stats.recent), default=-1)
    per_shape: dict[str, ClassReport] = {}
    per_temp = {"cold": ClassReport(), "warm": ClassReport()}
    writes = ClassReport()
    mismatches: list = []
    pending: list = []               # (event, due, ticket)

    def settle(now: float, item) -> None:
        event, due, ticket = item
        if event.kind == "update":
            report = writes
        else:
            report = per_shape.setdefault(event.shape, ClassReport())
        try:
            value = ticket.result(timeout=0)
        except Exception:
            # ticket rejection payloads are Exceptions; let
            # KeyboardInterrupt/SystemExit propagate so long replays
            # stay interruptible
            report.errors += 1
            if event.kind == "query":
                per_temp["cold" if event.cold else "warm"].errors += 1
            return
        report.count += 1
        report.latencies.append(now - due)
        if event.kind == "query":
            temp = per_temp["cold" if event.cold else "warm"]
            temp.count += 1
            temp.latencies.append(now - due)
            if verify and event.cardinality is not None:
                got = _observed_rows(value)
                if got == event.cardinality:
                    report.verified += 1
                    temp.verified += 1
                else:
                    report.mismatched += 1
                    temp.mismatched += 1
                    if len(mismatches) < max_mismatch_samples:
                        mismatches.append((event.template,
                                           event.cardinality, got))

    def drain_done(now: float) -> None:
        done = [it for it in pending if it[2].done()]
        for it in done:
            pending.remove(it)
            settle(now, it)

    start = time.monotonic()
    try:
        for event in events:
            due = start + event.at_s / speed
            while True:
                now = time.monotonic()
                if now >= due:
                    break
                drain_done(now)
                time.sleep(max(0.0, min(0.001,
                                        due - time.monotonic())))
            try:
                ticket = queue.submit(event.text)
            except Exception:
                # admission-level refusal (full queue / parse error):
                # count against the event's class, keep replaying
                report = (writes if event.kind == "update"
                          else per_shape.setdefault(event.shape,
                                                    ClassReport()))
                report.errors += 1
                if event.kind == "query":
                    per_temp["cold" if event.cold
                             else "warm"].errors += 1
                continue
            pending.append((event, due, ticket))
        while pending:
            drain_done(time.monotonic())
            if pending:
                time.sleep(0.0005)
    finally:
        if batch_log is not None:
            queue.stop_batch_log()
    wall = time.monotonic() - start

    batches = (batch_log if batch_log is not None
               else [bs for bs in queue.stats.recent if bs.seq > seq0])
    trajectory = [
        {"seq": bs.seq, "size": bs.size,
         "memo_hits": bs.memo_hits,
         "engine_cache_hits": bs.engine_cache_hits,
         "scans_deduped": bs.scans_deduped,
         "write_commits": bs.write_commits}
        for bs in batches]
    shape_totals = list(per_shape.values()) + [writes]
    return ReplayReport(
        wall_s=wall,
        n_events=len(events),
        completed=sum(r.count for r in shape_totals),
        errors=sum(r.errors for r in shape_totals),
        per_shape=per_shape,
        per_temperature=per_temp,
        writes=writes,
        verified=sum(r.verified for r in per_shape.values()),
        mismatched=sum(r.mismatched for r in per_shape.values()),
        mismatches=mismatches,
        cache_trajectory=trajectory,
        assignment_counts=dict(queue.stats.assignment_counts),
        admission=queue.stats.as_dict())
