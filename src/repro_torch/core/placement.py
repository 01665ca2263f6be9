"""Pattern selection + dynamic placement for edge servers (paper §3.2).

Storage-aware selection: choosing which pattern-induced subgraphs an edge
server hosts is a knapsack (benefit = access frequency, cost = subgraph
bytes); the paper uses a lightweight greedy heuristic — benefit/cost ratio
with a frequency tiebreak.

**Per-shard budgets.** On a sharded deployment the binding constraint is
often a single shard's device buffer, not the server total: a pattern whose
induced triples all hash to one shard can blow that shard's capacity while
the server as a whole has room. :func:`greedy_knapsack` therefore accepts
an optional per-shard budget vector next to the total; a
:class:`PatternProfile` carries its per-shard byte split
(``shard_bytes``), and a candidate is admitted only if it fits the total
AND every shard it touches. Per-shard footprints are additive
approximations (overlapping patterns share triples), matching the existing
total-bytes accounting.

Dynamic update: the system tracks per-pattern access frequencies; patterns
hot in the cloud but absent at an edge are added, cold ones evicted.
:meth:`DynamicPlacement.plan` computes the new residency WITHOUT mutating
state — the asynchronous rebalance pipeline
(:class:`repro_torch.edge.rebalance.RebalanceManager`) plans and computes deltas
off the query path, then commits residency atomically at an epoch barrier.
``rebalance()`` (plan + commit in one step) remains for synchronous
callers. ``hysteresis`` damps add/evict flapping: a currently-resident
pattern's frequency is scored with a ``(1 + hysteresis)`` bonus, so a
challenger must beat the incumbent by a margin before triggering an
eviction/re-ship cycle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .pattern import Pattern


@dataclass
class PatternProfile:
    pattern: Pattern
    frequency: float          # accesses (decayed)
    size_bytes: int           # |G[{p}]| storage cost
    shard_bytes: dict[int, int] | None = None  # per-shard byte split


def greedy_knapsack(profiles: list[PatternProfile], budget_bytes: int,
                    shard_budgets=None) -> list[int]:
    """Indices of selected patterns under the budget (benefit/cost greedy).

    ``shard_budgets`` (optional) is indexable by shard id (array or dict);
    when given, a profile with ``shard_bytes`` is admitted only if every
    shard it touches stays within its budget. Profiles without a per-shard
    split are checked against the total only.
    """
    order = sorted(
        range(len(profiles)),
        key=lambda i: (-(profiles[i].frequency
                         / max(1, profiles[i].size_bytes)),
                       -profiles[i].frequency, i))
    chosen: list[int] = []
    used = 0
    used_shard: dict[int, int] = {}
    for i in order:
        sz = profiles[i].size_bytes
        if used + sz > budget_bytes:
            continue
        sb = profiles[i].shard_bytes
        if shard_budgets is not None and sb:
            if any(used_shard.get(k, 0) + b > shard_budgets[k]
                   for k, b in sb.items()):
                continue
            for k, b in sb.items():
                used_shard[k] = used_shard.get(k, 0) + b
        chosen.append(i)
        used += sz
    return sorted(chosen)


@dataclass
class DynamicPlacement:
    """Frequency-tracking placement policy for one edge server."""

    budget_bytes: int
    decay: float = 0.9                  # per-round exponential decay
    hysteresis: float = 0.0             # resident-pattern score bonus
    shard_budgets: np.ndarray | None = None   # per-shard byte budgets
    freq: dict[tuple, float] = field(default_factory=dict)
    sizes: dict[tuple, int] = field(default_factory=dict)
    shard_sizes: dict[tuple, dict[int, int]] = field(default_factory=dict)
    patterns: dict[tuple, Pattern] = field(default_factory=dict)
    resident: set[tuple] = field(default_factory=set)

    def observe(self, p: Pattern, count: float = 1.0) -> None:
        """Record accesses for a pattern (edge- or cloud-served)."""
        if not p.indexable:
            return
        k = p.key
        self.freq[k] = self.freq.get(k, 0.0) + count
        self.patterns.setdefault(k, p)

    def set_size(self, p: Pattern, size_bytes: int,
                 shard_bytes: dict[int, int] | None = None) -> None:
        self.sizes[p.key] = int(size_bytes)
        if shard_bytes is not None:
            self.shard_sizes[p.key] = {int(k): int(v)
                                       for k, v in shard_bytes.items()}

    def decay_round(self) -> None:
        for k in list(self.freq):
            self.freq[k] *= self.decay

    def plan(self) -> tuple[set[tuple], set[tuple], set[tuple]]:
        """Compute the target residency WITHOUT mutating state.

        Returns ``(chosen, added, evicted)`` key sets. Patterns without a
        measured size are skipped (size is measured by the server when it
        first materializes G[{p}]). Currently-resident patterns score with
        the ``hysteresis`` bonus (see module docstring).
        """
        # snapshot first: plan() may run on the rebalance thread while a
        # concurrent round observes new patterns (freq inserts are benign —
        # they surface next epoch — but iteration must not race them)
        snap = list(self.freq.items())
        known = [k for k, _ in snap if k in self.sizes]
        freq = dict(snap)
        boost = 1.0 + max(0.0, self.hysteresis)
        profiles = [PatternProfile(
            self.patterns[k],
            freq[k] * (boost if k in self.resident else 1.0),
            self.sizes[k], self.shard_sizes.get(k)) for k in known]
        chosen = set(known[i] for i in greedy_knapsack(
            profiles, self.budget_bytes, self.shard_budgets))
        return chosen, chosen - self.resident, self.resident - chosen

    def rebalance(self) -> tuple[list[Pattern], list[Pattern]]:
        """Plan + commit residency; returns (added, evicted) patterns."""
        chosen, add, ev = self.plan()
        self.resident = chosen
        return ([self.patterns[k] for k in add],
                [self.patterns[k] for k in ev])

    def used_bytes(self) -> int:
        return sum(self.sizes.get(k, 0) for k in self.resident)

    def used_shard_bytes(self) -> dict[int, int]:
        """Additive per-shard usage of the current residency."""
        out: dict[int, int] = {}
        for k in self.resident:
            for sid, b in self.shard_sizes.get(k, {}).items():
                out[sid] = out.get(sid, 0) + b
        return out
