"""Dictionary-encoded RDF storage: the :class:`RDFStore` protocol and the
single-buffer :class:`TripleStore` implementation.

Every consumer of RDF data in this repo — the BGP matcher, the batched query
engine and its backends, pattern-induced subgraph construction, placement
accounting — programs against :class:`RDFStore`, the accessor surface listed
on the protocol below. Two implementations exist:

- :class:`TripleStore` (here): one monolithic buffer. Storage layout is three
  parallel int arrays (s, p, o) plus derived indexes:

  * CSR grouping of triple ids by predicate (``pred_tids`` — candidate scans
    for bound-predicate triple patterns, the common case);
  * per-predicate triples sorted by subject and by object (``pred_index``),
    enabling ``searchsorted`` merge joins during BGP matching.

- :class:`repro_torch.rdf.sharding.ShardedTripleStore`: S hash-partitioned-by-
  predicate ``TripleStore`` shards behind the same protocol. Triple ids stay
  *global* (shard-concatenation order), so joins and subgraph extraction are
  unchanged, while candidate scans prune to the single shard owning a bound
  predicate (and fan out across shards only for wildcard predicates).

Everything is a dense NumPy array so the matcher is pure data-parallel array
code (the TPU adaptation of gStore's pointer-based matching; see DESIGN.md §3).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np

# Monotone store-version tokens. Stores mutate ONLY through ``apply_delta``
# (the placement data-plane, repro_torch.rdf.deltas), which takes a fresh token —
# so a version uniquely identifies store *contents* and stays a sound
# cache-invalidation key: any result memoized against version v can never be
# served for a store holding different triples.
_STORE_VERSIONS = itertools.count()


def triples_size_bytes(n_triples: int) -> int:
    """Modeled storage cost of ``n_triples`` triples.

    Matches an on-disk layout of 3x int64 per triple plus ~25% index overhead
    (gStore's VS-tree etc. are heavier; this is conservative). Shared by
    ``RDFStore.size_bytes`` implementations and the placement knapsack so
    byte accounting agrees regardless of store kind.
    """
    return int(n_triples * 3 * 8 * 1.25)


@dataclass
class PredIndex:
    """Per-predicate sorted views used by the join matcher."""

    tids: np.ndarray        # triple ids with this predicate
    s_order: np.ndarray     # tids permuted so that s is ascending
    s_sorted: np.ndarray    # subjects in ascending order (len == len(tids))
    o_order: np.ndarray     # tids permuted so that o is ascending
    o_sorted: np.ndarray    # objects in ascending order


@runtime_checkable
class RDFStore(Protocol):
    """Accessor surface the matcher / engine / placement stack consumes.

    Triple ids are *global*: ``s[t], p[t], o[t]`` is triple ``t`` for any id
    returned by ``pred_tids`` / ``pred_index`` / a candidate scan, whatever
    the physical layout behind it. ``version`` is a hashable token unique to
    the store's contents (stores are immutable after construction), used as
    a cache-invalidation key by :class:`repro_torch.sparql.engine.QueryEngine` —
    for a sharded store it is a composite over the shard versions.
    """

    s: np.ndarray
    p: np.ndarray
    o: np.ndarray
    num_entities: int
    num_predicates: int
    pred_count: np.ndarray
    pred_distinct_s: np.ndarray
    pred_distinct_o: np.ndarray

    @property
    def num_triples(self) -> int: ...

    @property
    def version(self): ...

    def pred_tids(self, pid: int) -> np.ndarray: ...

    def pred_index(self, pid: int) -> PredIndex: ...

    def triples(self) -> np.ndarray: ...

    def size_bytes(self) -> int: ...

    def subgraph(self, edge_ids: np.ndarray) -> "RDFStore": ...

    def apply_delta(self, delta): ...


class TripleStore:
    """An RDF graph G = (V, E, L, f) as parallel arrays + indexes."""

    def __init__(self, s: np.ndarray, p: np.ndarray, o: np.ndarray,
                 num_entities: int, num_predicates: int) -> None:
        s = np.ascontiguousarray(s, dtype=np.int64)
        p = np.ascontiguousarray(p, dtype=np.int64)
        o = np.ascontiguousarray(o, dtype=np.int64)
        if not (s.shape == p.shape == o.shape) or s.ndim != 1:
            raise ValueError("s, p, o must be 1-D arrays of equal length")
        # Deduplicate (RDF graphs are edge *multisets* in the paper's Def. 1,
        # but duplicate identical triples carry no information for BGP
        # matching; gStore also dedupes at load).
        trip = np.stack([s, p, o], axis=1)
        trip = np.unique(trip, axis=0) if len(trip) else trip.reshape(0, 3)
        self.s, self.p, self.o = trip[:, 0], trip[:, 1], trip[:, 2]
        self.num_entities = int(num_entities)
        self.num_predicates = int(num_predicates)
        self.version = next(_STORE_VERSIONS)
        self._pred_index: dict[int, PredIndex] = {}
        self._build_indexes()

    # -- construction --------------------------------------------------------
    def _build_indexes(self) -> None:
        T = len(self.s)
        order = np.argsort(self.p, kind="stable")
        sorted_p = self.p[order]
        # CSR boundaries over predicates
        self._pred_starts = np.searchsorted(
            sorted_p, np.arange(self.num_predicates + 1))
        self._pred_tids = order
        # per-predicate stats (for the cardinality estimator) — vectorized
        self.pred_count = np.diff(self._pred_starts)
        self.pred_distinct_s = np.zeros(self.num_predicates, dtype=np.int64)
        self.pred_distinct_o = np.zeros(self.num_predicates, dtype=np.int64)
        if T:
            ps = np.unique(np.stack([self.p, self.s], axis=1), axis=0)
            np.add.at(self.pred_distinct_s, ps[:, 0], 1)
            po = np.unique(np.stack([self.p, self.o], axis=1), axis=0)
            np.add.at(self.pred_distinct_o, po[:, 0], 1)
        self._T = T

    def pred_tids(self, pid: int) -> np.ndarray:
        lo, hi = self._pred_starts[pid], self._pred_starts[pid + 1]
        return self._pred_tids[lo:hi]

    def pred_index(self, pid: int) -> PredIndex:
        """Lazily-built sorted views for predicate ``pid``."""
        idx = self._pred_index.get(pid)
        if idx is None:
            tids = self.pred_tids(pid)
            so = np.argsort(self.s[tids], kind="stable")
            oo = np.argsort(self.o[tids], kind="stable")
            idx = PredIndex(
                tids=tids,
                s_order=tids[so], s_sorted=self.s[tids][so],
                o_order=tids[oo], o_sorted=self.o[tids][oo],
            )
            self._pred_index[pid] = idx
        return idx

    def owning_part(self, pid: int) -> tuple["TripleStore", int]:
        """(flat store, global-id offset) holding predicate ``pid``.

        The monolithic store owns everything at offset 0; the sharded
        store returns the predicate's owning shard. This is how
        device-resident consumers (:mod:`repro_torch.sparql.device_join`) address
        a predicate's shard-LOCAL ``pred_index`` views plus the lift needed
        to go back to global triple ids.
        """
        return self, 0

    # -- basic accessors -----------------------------------------------------
    @property
    def num_triples(self) -> int:
        return self._T

    def triples(self) -> np.ndarray:
        """[T, 3] int64 array of (s, p, o)."""
        return np.stack([self.s, self.p, self.o], axis=1)

    def size_bytes(self) -> int:
        """Storage cost of this (sub)graph — used by the placement knapsack."""
        return triples_size_bytes(self._T)

    # -- incremental maintenance ----------------------------------------------
    def apply_delta(self, delta):
        """Apply a :class:`repro_torch.rdf.deltas.TripleDelta` in place.

        Content semantics are idempotent per side: adding a present row or
        evicting an absent one is a no-op (the store is a deduplicated
        set). Indexes are rebuilt, ``pred_index`` views dropped, and a
        fresh version token is taken, so every version-keyed consumer
        (engine result/scan/plan caches, staged device arrays) sees this
        as a new store. Returns the new version.
        """
        from .deltas import DeltaVersionError, setdiff_rows
        if delta.base_version != self.version:
            raise DeltaVersionError(
                f"delta targets version {delta.base_version!r}, store is at "
                f"{self.version!r}")
        rows = self.triples()
        if len(delta.evict):
            rows = setdiff_rows(rows, delta.evict)
        if len(delta.add):
            rows = np.concatenate([rows, delta.add])
        rows = (np.unique(rows, axis=0) if len(rows)
                else rows.reshape(0, 3))
        self.s, self.p, self.o = rows[:, 0], rows[:, 1], rows[:, 2]
        self.version = next(_STORE_VERSIONS)
        self._pred_index.clear()
        self._build_indexes()
        return self.version

    # -- subgraph extraction ---------------------------------------------------
    def subgraph(self, edge_ids: np.ndarray) -> "TripleStore":
        """Subgraph induced by a set of triple (edge) ids.

        Entity/predicate ids are preserved (global dictionary; paper §2.2).
        """
        edge_ids = np.unique(np.asarray(edge_ids, dtype=np.int64))
        return TripleStore(self.s[edge_ids], self.p[edge_ids], self.o[edge_ids],
                           self.num_entities, self.num_predicates)

    # -- (de)serialization ------------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "s": self.s, "p": self.p, "o": self.o,
            "meta": np.asarray([self.num_entities, self.num_predicates]),
        }

    @classmethod
    def from_arrays(cls, a: dict[str, np.ndarray]) -> "TripleStore":
        ne, npred = (int(x) for x in a["meta"])
        return cls(a["s"], a["p"], a["o"], ne, npred)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TripleStore(triples={self._T}, entities={self.num_entities},"
                f" predicates={self.num_predicates})")
