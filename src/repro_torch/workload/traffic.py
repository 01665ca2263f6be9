"""Deterministic traffic modeling: templates → an open-loop schedule.

The serving experiments of §5 need *shaped* traffic, not uniform replay:
cache layers only show up under skewed popularity, the admission window
only matters under bursts, and the coalescing write path only matters
under read/write mixes. :func:`build_schedule` synthesizes all of that
from a seed — two calls with the same inputs produce byte-identical
schedules, so A/B benchmark arms replay the *same* traffic:

- **Popularity**: Zipf(``zipf_s``) over a hot template pool. A
  ``cold_fraction`` of requests instead draw the next template from a
  once-only cold reserve (carved off the template list), modeling
  compulsory cache misses; an exhausted reserve falls back to the hot
  pool.
- **Arrivals**: open-loop ``poisson`` (exponential inter-arrivals at
  ``qps``) or ``burst`` — an inhomogeneous Poisson process where a
  ``burst_fraction`` of wall time runs at ``burst_factor × qps`` in
  periodic burst windows and the off-window rate compensates so the
  overall mean stays ``qps`` (with the defaults the off-window rate is
  exactly 0: all traffic lands in the bursts).
- **Writes**: a ``write_fraction`` of events are SPARQL UPDATEs
  synthesized against the same store. Style ``"churn"`` inserts (and
  later deletes) triples on a dedicated *churn predicate* with fresh
  entity terms — it never touches sampled predicates, so recorded
  cardinalities stay exact under the write load. Style ``"touch"``
  deletes a sampled existing triple and re-inserts it on a later write
  event — real invalidation pressure, at the cost of transiently
  perturbed counts (the driver skips verification mid-flight for it).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .sampler import SampledQuery

ARRIVALS = ("poisson", "burst")
WRITE_STYLES = ("churn", "touch")


@dataclass(frozen=True)
class TrafficConfig:
    """Shape of the synthesized traffic (see module doc)."""

    duration_s: float = 1.0
    qps: float = 200.0
    arrival: str = "poisson"
    burst_factor: float = 4.0        # burst-window rate multiplier
    burst_fraction: float = 0.25     # fraction of wall time in burst
    burst_period_s: float = 0.25     # one burst per period
    zipf_s: float = 1.1              # popularity skew exponent
    cold_fraction: float = 0.0       # requests served from the cold pool
    write_fraction: float = 0.0      # events that are UPDATEs
    write_style: str = "churn"
    seed: int = 0

    def __post_init__(self) -> None:
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival {self.arrival!r}; "
                             f"expected one of {ARRIVALS}")
        if self.write_style not in WRITE_STYLES:
            raise ValueError(f"unknown write_style {self.write_style!r}; "
                             f"expected one of {WRITE_STYLES}")
        for name in ("duration_s", "qps", "burst_factor",
                     "burst_period_s"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        for name in ("cold_fraction", "write_fraction", "burst_fraction"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]")


@dataclass(frozen=True)
class ScheduledEvent:
    """One arrival: a query replay or a synthesized update."""

    at_s: float                      # offset from replay start
    kind: str                        # "query" | "update"
    text: str
    template: str | None = None      # SampledQuery.name (queries only)
    shape: str | None = None
    cardinality: int | None = None   # recorded ground truth (queries only)
    cold: bool = False               # drawn from the cold reserve


@dataclass
class Schedule:
    """A fully materialized, seed-deterministic arrival sequence."""

    events: list
    config: TrafficConfig
    templates: list                  # the SampledQuery list scheduled over
    churn_predicate: str | None = None

    @property
    def n_queries(self) -> int:
        return sum(1 for e in self.events if e.kind == "query")

    @property
    def n_updates(self) -> int:
        return sum(1 for e in self.events if e.kind == "update")

    @property
    def has_writes(self) -> bool:
        return self.n_updates > 0

    @property
    def verifiable(self) -> bool:
        """Whether recorded cardinalities stay exact during replay: true
        for read-only schedules and for churn-style writes (which touch
        only the reserved predicate + fresh entities)."""
        return (not self.has_writes
                or self.config.write_style == "churn")

    def template_counts(self) -> dict:
        out: dict[str, int] = {}
        for e in self.events:
            if e.kind == "query":
                out[e.template] = out.get(e.template, 0) + 1
        return out


def _arrival_times(cfg: TrafficConfig, rng: np.random.Generator) -> list:
    """Open-loop arrival offsets in [0, duration_s), sorted.

    ``burst`` is a piecewise-constant inhomogeneous Poisson process,
    simulated by *thinning*: sample a homogeneous process at the peak
    rate and accept each candidate with probability ``rate(t) / peak``.
    (Stepping one exponential at the rate of the current instant is NOT
    equivalent — a draw taken at a low off-window rate can overshoot
    every later burst window entirely.)
    """
    if cfg.arrival == "burst":
        burst_rate = cfg.qps * cfg.burst_factor
        window = cfg.burst_fraction * cfg.burst_period_s
        if cfg.burst_fraction >= 1.0:
            off_rate = 0.0           # degenerate: always in-burst anyway
        else:
            # chosen so burst_fraction·burst + (1-burst_fraction)·off
            # averages back to qps; clamps at 0 when the bursts alone
            # already carry the full mean load
            off_rate = cfg.qps * max(
                0.0, (1.0 - cfg.burst_factor * cfg.burst_fraction)
                / (1.0 - cfg.burst_fraction))
        peak = max(burst_rate, off_rate)
    else:
        peak = cfg.qps
    times: list[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= cfg.duration_s:
            return times
        if cfg.arrival == "burst":
            rate = (burst_rate if t % cfg.burst_period_s < window
                    else off_rate)
            if rng.random() * peak >= rate:
                continue
        times.append(t)


class _ChurnWriter:
    """Synthesizes churn-style updates: fresh entities on a reserved
    predicate. Inserts until a small pool accumulates, then alternates
    insert/delete so the store does not grow without bound."""

    def __init__(self, predicate: str, rng: np.random.Generator,
                 tag: str) -> None:
        self.predicate = predicate
        self.rng = rng
        self.tag = tag
        self.live: list[tuple[str, str]] = []
        self.minted = 0

    def next_update(self) -> str:
        delete = self.live and (len(self.live) >= 8
                                or self.rng.random() < 0.4)
        if delete:
            s, o = self.live.pop(int(self.rng.integers(len(self.live))))
            return (f"DELETE DATA {{ <{s}> <{self.predicate}> <{o}> }}")
        s = f"wl:{self.tag}:e{self.minted}"
        o = f"wl:{self.tag}:e{self.minted + 1}"
        self.minted += 2
        self.live.append((s, o))
        return f"INSERT DATA {{ <{s}> <{self.predicate}> <{o}> }}"


class _TouchWriter:
    """Synthesizes touch-style updates: delete an existing triple, then
    re-insert it on a later write event (net zero at drain)."""

    def __init__(self, store, dictionary,
                 rng: np.random.Generator) -> None:
        self.store = store
        self.d = dictionary
        self.rng = rng
        self.pending: list[str] = []     # re-insert texts owed

    def next_update(self) -> str:
        if self.pending and self.rng.random() < 0.5:
            return self.pending.pop(0)
        if self.store.num_triples == 0:
            return "INSERT DATA { }"
        t = int(self.rng.integers(self.store.num_triples))
        s = self.d.entity(int(self.store.s[t]))
        p = self.d.predicate(int(self.store.p[t]))
        o = self.d.entity(int(self.store.o[t]))
        row = f"<{s}> <{p}> <{o}>"
        self.pending.append(f"INSERT DATA {{ {row} }}")
        return f"DELETE DATA {{ {row} }}"

    def drain(self) -> list:
        """Re-insert texts still owed (append these after replay to
        restore the store)."""
        out, self.pending = self.pending, []
        return out


def build_schedule(templates: list, config: TrafficConfig, *,
                   store=None, dictionary=None,
                   churn_predicate: str | None = None) -> Schedule:
    """Materialize a deterministic schedule over sampled templates.

    ``templates`` is a non-empty list of :class:`SampledQuery`.
    ``write_fraction > 0`` with style ``"churn"`` requires
    ``churn_predicate`` (a predicate term string the sampler *excluded*);
    style ``"touch"`` requires ``store`` and ``dictionary`` to sample
    existing triples from.
    """
    if not templates:
        raise ValueError("build_schedule needs at least one template")
    cfg = config
    rng = np.random.default_rng(cfg.seed)
    writer = None
    if cfg.write_fraction > 0:
        if cfg.write_style == "churn":
            if churn_predicate is None:
                raise ValueError("churn writes need churn_predicate=")
            writer = _ChurnWriter(churn_predicate, rng,
                                  tag=f"s{cfg.seed}")
        else:
            if store is None or dictionary is None:
                raise ValueError("touch writes need store= and "
                                 "dictionary=")
            writer = _TouchWriter(store, dictionary, rng)

    # hot/cold split: the cold reserve is the TAIL of the template list
    # (shuffled copy so the caller's ordering carries no popularity bias)
    order = list(templates)
    rng.shuffle(order)
    n_cold = (min(len(order) - 1, max(1, int(round(
        cfg.cold_fraction * len(order))))) if cfg.cold_fraction > 0
        and len(order) > 1 else 0)
    hot = order[:len(order) - n_cold]
    cold = order[len(order) - n_cold:]
    weights = 1.0 / np.arange(1, len(hot) + 1) ** cfg.zipf_s
    weights /= weights.sum()

    events: list[ScheduledEvent] = []
    cold_next = 0
    for t in _arrival_times(cfg, rng):
        if writer is not None and rng.random() < cfg.write_fraction:
            events.append(ScheduledEvent(at_s=t, kind="update",
                                         text=writer.next_update()))
            continue
        is_cold = (cold_next < len(cold)
                   and rng.random() < cfg.cold_fraction)
        if is_cold:
            q: SampledQuery = cold[cold_next]
            cold_next += 1
        else:
            q = hot[int(rng.choice(len(hot), p=weights))]
        events.append(ScheduledEvent(
            at_s=t, kind="query", text=q.text, template=q.name,
            shape=q.shape, cardinality=q.cardinality, cold=is_cold))
    if isinstance(writer, _TouchWriter):
        # settle owed re-inserts just after the window so replay restores
        # the store to its pre-schedule content
        eps = 1e-4
        for i, text in enumerate(writer.drain()):
            events.append(ScheduledEvent(
                at_s=cfg.duration_s + eps * (i + 1), kind="update",
                text=text))
    return Schedule(events=events, config=cfg,
                    templates=list(templates),
                    churn_predicate=(churn_predicate
                                     if cfg.write_style == "churn"
                                     and cfg.write_fraction > 0 else None))
