"""Hash-partitioned sharded RDF storage behind the :class:`RDFStore` protocol.

Distributed SPARQL engines scale by partitioning the graph and evaluating as
much of each query as possible locally per partition (Peng et al., VLDB'16;
Naacke et al.'s Spark study) — and a production store quickly outgrows a
single device buffer. :class:`ShardedTripleStore` brings that layout behind
the accessor surface every consumer in this repo already programs against:

- **Partitioning.** Triples are hash-partitioned by predicate into S
  :class:`TripleStore` shards (``shard_of_pred``). All triples of one
  predicate land in one shard, so a bound-predicate candidate scan — the
  common case in real workloads — touches exactly one shard (partition
  pruning); only wildcard-predicate scans fan out across shards.

- **Global triple ids.** Shard k owns the contiguous global id range
  ``[shard_offsets[k], shard_offsets[k+1])``; global = local + offset.
  ``s``/``p``/``o`` are exposed as concatenated global arrays, so the join
  matcher, repeated-variable filters, and ``subgraph`` extraction work
  unchanged on global ids.

- **Composite version.** ``version`` is a tuple over a fresh token plus the
  shard versions, so engine caches keyed on ``store.version`` can never
  confuse a sharded store with any other store (or shard).

The shard-aware *scan* fast paths live in :mod:`repro_torch.sparql.engine`: the
NumPy backend scans shards independently and keeps the per-shard partitions
(``parts()``) separate as :class:`repro_torch.sparql.matcher.CandidateParts`; the
torch backend stages per-shard device arrays and fuses each shard's
deduplicated batch scans into one ``triple_scan_many`` launch per *touched*
shard. Downstream, the matcher's join pipeline exploits the same layout:
bound-predicate equi-joins probe the owning shard's ``pred_index`` sorted
views shard-locally (the partition-disjointness condition holds trivially —
one predicate lives in exactly one shard), and partial binding tables merge
only at variable-predicate / cross-shard joins.
"""

from __future__ import annotations

import numpy as np

from .graph import PredIndex, TripleStore, _STORE_VERSIONS

# Knuth's multiplicative hash constant — spreads consecutive predicate ids
# (schema order groups correlated predicates) across shards.
_HASH_MULT = 2654435761


def shard_of_pred(pid: int | np.ndarray, num_shards: int):
    """Owning shard of predicate ``pid`` under multiplicative hashing."""
    return (np.asarray(pid, dtype=np.uint64) * _HASH_MULT) % np.uint64(
        num_shards)


class ShardedTripleStore:
    """S predicate-hash-partitioned :class:`TripleStore` shards, one
    :class:`RDFStore`.

    Construction mirrors ``TripleStore(s, p, o, num_entities,
    num_predicates)`` plus ``num_shards``. Duplicate triples share a
    predicate, hence a shard, so shard-local dedup equals global dedup.
    """

    def __init__(self, s: np.ndarray, p: np.ndarray, o: np.ndarray,
                 num_entities: int, num_predicates: int,
                 num_shards: int = 4) -> None:
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        s = np.ascontiguousarray(s, dtype=np.int64)
        p = np.ascontiguousarray(p, dtype=np.int64)
        o = np.ascontiguousarray(o, dtype=np.int64)
        if not (s.shape == p.shape == o.shape) or s.ndim != 1:
            raise ValueError("s, p, o must be 1-D arrays of equal length")
        self.num_entities = int(num_entities)
        self.num_predicates = int(num_predicates)
        self.num_shards = int(num_shards)

        owner = shard_of_pred(p, self.num_shards).astype(np.int64)
        self.shards: list[TripleStore] = [
            TripleStore(s[owner == k], p[owner == k], o[owner == k],
                        self.num_entities, self.num_predicates)
            for k in range(self.num_shards)]
        self._pred_index: dict[int, PredIndex] = {}
        self._rebuild_global_layout()

    def _rebuild_global_layout(self) -> None:
        """(Re)derive the global-id view from the shard list: offsets,
        concatenated arrays, aggregated stats, and a fresh composite
        version. Called at construction and after ``apply_delta`` mutates
        shards in place (global triple ids are ephemeral per version — every
        id-consuming cache is version-keyed)."""
        # global id layout: shard k owns [offsets[k], offsets[k+1])
        sizes = np.asarray([sh.num_triples for sh in self.shards],
                           dtype=np.int64)
        self.shard_offsets = np.concatenate(
            [np.zeros(1, dtype=np.int64), np.cumsum(sizes)])
        self.s = np.concatenate([sh.s for sh in self.shards])
        self.p = np.concatenate([sh.p for sh in self.shards])
        self.o = np.concatenate([sh.o for sh in self.shards])
        self._T = int(sizes.sum())

        # per-predicate stats: each predicate lives in exactly one shard, so
        # elementwise sums aggregate exactly
        self.pred_count = np.sum(
            [sh.pred_count for sh in self.shards], axis=0)
        self.pred_distinct_s = np.sum(
            [sh.pred_distinct_s for sh in self.shards], axis=0)
        self.pred_distinct_o = np.sum(
            [sh.pred_distinct_o for sh in self.shards], axis=0)

        self.version = (next(_STORE_VERSIONS),
                        *(sh.version for sh in self.shards))
        self._pred_index.clear()

    # -- incremental maintenance ----------------------------------------------
    def apply_delta(self, delta):
        """Apply a :class:`repro_torch.rdf.deltas.TripleDelta` per shard, in place.

        Rows are routed to their owning shards by predicate hash; **only
        touched shards** are mutated and take fresh version tokens —
        untouched shards keep theirs, so per-shard version-keyed consumers
        (the engine's bound-predicate scan cache, the torch backend's staged
        device arrays) stay valid exactly where data did not change. The
        composite version and global-id layout are rebuilt (shard sizes may
        shift every offset after the first touched shard). Returns the new
        composite version.
        """
        from .deltas import DeltaVersionError, TripleDelta
        if delta.base_version != self.version:
            raise DeltaVersionError(
                f"delta targets version {delta.base_version!r}, store is at "
                f"{self.version!r}")
        add_owner = shard_of_pred(delta.add[:, 1],
                                  self.num_shards).astype(np.int64)
        ev_owner = shard_of_pred(delta.evict[:, 1],
                                 self.num_shards).astype(np.int64)
        touched = np.union1d(np.unique(add_owner), np.unique(ev_owner))
        for k in touched:
            sh = self.shards[int(k)]
            sh.apply_delta(TripleDelta(base_version=sh.version,
                                       add=delta.add[add_owner == k],
                                       evict=delta.evict[ev_owner == k]))
        self._rebuild_global_layout()
        return self.version

    # -- sharding-specific accessors -----------------------------------------
    def shard_of_pred(self, pid: int) -> int:
        return int(shard_of_pred(pid, self.num_shards))

    def owning_part(self, pid: int) -> tuple[TripleStore, int]:
        """(owning shard, global-id offset) for predicate ``pid`` — the
        shard-local counterpart of :meth:`pred_index` (same views, ids NOT
        lifted), used by device-resident consumers that stage shard-local
        sorted views and re-lift on the host after the batch fetch."""
        k = self.shard_of_pred(pid)
        return self.shards[k], int(self.shard_offsets[k])

    def parts(self) -> list[tuple[TripleStore, int]]:
        """Non-empty ``(shard, global_id_offset)`` pairs — the candidate
        partitions a wildcard-predicate scan (and the shard-local join
        pipeline downstream of it) fans out over."""
        return [(sh, int(off))
                for sh, off in zip(self.shards, self.shard_offsets)
                if sh.num_triples]

    # -- RDFStore protocol ---------------------------------------------------
    @property
    def num_triples(self) -> int:
        return self._T

    def pred_tids(self, pid: int) -> np.ndarray:
        k = self.shard_of_pred(pid)
        return self.shards[k].pred_tids(pid) + self.shard_offsets[k]

    def pred_index(self, pid: int) -> PredIndex:
        """Owning shard's sorted views, lifted to global triple ids."""
        idx = self._pred_index.get(pid)
        if idx is None:
            k = self.shard_of_pred(pid)
            off = self.shard_offsets[k]
            local = self.shards[k].pred_index(pid)
            idx = PredIndex(
                tids=local.tids + off,
                s_order=local.s_order + off, s_sorted=local.s_sorted,
                o_order=local.o_order + off, o_sorted=local.o_sorted,
            )
            self._pred_index[pid] = idx
        return idx

    def triples(self) -> np.ndarray:
        """[T, 3] int64 array of (s, p, o) in global-id order."""
        return np.stack([self.s, self.p, self.o], axis=1)

    def size_bytes(self) -> int:
        return sum(sh.size_bytes() for sh in self.shards)

    def subgraph(self, edge_ids: np.ndarray) -> "ShardedTripleStore":
        """Induced subgraph by global edge ids; stays sharded with the same
        shard count (shards can end up empty — pruning still applies)."""
        edge_ids = np.unique(np.asarray(edge_ids, dtype=np.int64))
        return ShardedTripleStore(
            self.s[edge_ids], self.p[edge_ids], self.o[edge_ids],
            self.num_entities, self.num_predicates,
            num_shards=self.num_shards)

    # -- (de)serialization ---------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "s": self.s, "p": self.p, "o": self.o,
            "meta": np.asarray([self.num_entities, self.num_predicates,
                                self.num_shards]),
        }

    @classmethod
    def from_arrays(cls, a: dict[str, np.ndarray]) -> "ShardedTripleStore":
        ne, npred, ns = (int(x) for x in a["meta"])
        return cls(a["s"], a["p"], a["o"], ne, npred, num_shards=ns)

    @classmethod
    def from_store(cls, store, num_shards: int) -> "ShardedTripleStore":
        """Re-partition any :class:`RDFStore` into ``num_shards`` shards."""
        return cls(store.s, store.p, store.o, store.num_entities,
                   store.num_predicates, num_shards=num_shards)

    def __repr__(self) -> str:  # pragma: no cover
        per = [sh.num_triples for sh in self.shards]
        return (f"ShardedTripleStore(triples={self._T}, shards={per}, "
                f"entities={self.num_entities}, "
                f"predicates={self.num_predicates})")
