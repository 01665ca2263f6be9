"""Versioned triple deltas — the placement data-plane's wire format.

The paper's data-localization half (§3.2) keeps pattern-induced subgraphs
G[P] resident at edge servers. The seed reproduction refreshed them by
rebuilding and re-shipping the *entire* induced subgraph whenever residency
changed; edge KG systems (Xu et al., *Knowledge Graph Management on the
Edge*) show that what makes dynamic placement viable under constrained
links is incremental, diff-based maintenance of the edge-resident fragment.
This module is that diff protocol:

**Delta protocol.** A :class:`TripleDelta` carries the *content* difference
between an edge store's current triples and its target residency:

- ``add``   — ``[A, 3]`` int64 ``(s, p, o)`` rows to insert (shipped in
  full from the cloud: 24 modeled bytes per triple);
- ``evict`` — ``[E, 3]`` rows to remove (the edge already holds the
  content, so the wire carries only a per-triple key: 8 modeled bytes);
- ``base_version`` — the store version the delta applies to. Application
  is guarded: applying a delta to any other version raises
  :class:`DeltaVersionError`, so a half-computed rebalance can never land
  on a store that moved underneath it.

Deltas are expressed in triple *content*, not local triple ids — stores
deduplicate and re-sort on every mutation, so content is the only id-stable
coordinate system across versions (cloud-global edge ids are stable too,
and :class:`repro.edge.server.EdgeServer` tracks residency in them; the
delta itself stays self-contained). Application is idempotent per side:
adding an already-present row or evicting an absent one is a no-op, which
is what makes ``apply(delta)`` / ``apply(delta.inverse(v))`` an exact
round-trip (asserted in ``tests/test_rebalance.py``).

Application is ``store.apply_delta(delta)``, in place on either store
kind: :class:`repro_torch.rdf.graph.TripleStore` rebuilds its
arrays/indexes and takes a fresh version token;
:class:`repro_torch.rdf.sharding.ShardedTripleStore` routes the delta's rows to
their owning shards by predicate hash and mutates **only the touched
shards** — untouched shards keep their version tokens, so version-keyed
consumers (the engine's per-shard scan cache, the torch backend's staged
device arrays) invalidate exactly where data changed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# modeled wire cost (matches repro_torch.rdf.graph.triples_size_bytes's 3x int64
# row layout): an added triple ships its full row, an evicted one only a key
ADD_WIRE_BYTES = 3 * 8
EVICT_WIRE_BYTES = 8


class DeltaVersionError(RuntimeError):
    """Delta applied to a store whose version moved since computation."""


def as_rows(x: np.ndarray) -> np.ndarray:
    """Normalize to a contiguous ``[N, 3]`` int64 row array."""
    x = np.asarray(x, dtype=np.int64)
    if x.size == 0:
        return np.zeros((0, 3), dtype=np.int64)
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError("triple rows must have shape [N, 3]")
    return np.ascontiguousarray(x)


def member_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Boolean mask over ``a``'s rows: which appear in ``b``.

    Bytewise row membership (one void view + sorted ``searchsorted``) —
    the primitive both delete acks and coalesced-commit bookkeeping use.
    """
    a, b = as_rows(a), as_rows(b)
    if len(a) == 0 or len(b) == 0:
        return np.zeros(len(a), dtype=bool)
    void = np.dtype((np.void, a.dtype.itemsize * 3))
    av = np.ascontiguousarray(a).view(void).ravel()
    bv = np.sort(np.ascontiguousarray(b).view(void).ravel())
    pos = np.searchsorted(bv, av)
    pos[pos == len(bv)] = len(bv) - 1
    return bv[pos] == av


def union_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Deduplicated row-set union of two ``[N, 3]`` arrays."""
    a, b = as_rows(a), as_rows(b)
    if len(a) == 0:
        return np.unique(b, axis=0) if len(b) else b
    if len(b) == 0:
        return np.unique(a, axis=0)
    return np.unique(np.concatenate([a, b]), axis=0)


def setdiff_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rows of ``a`` not present in ``b`` (both deduplicated ``[N, 3]``).

    Pure lexicographic set algebra: rows of ``b`` are concatenated first, so
    a unique row whose first occurrence lands in the ``a`` region is in
    ``a`` only.
    """
    a, b = as_rows(a), as_rows(b)
    if len(a) == 0 or len(b) == 0:
        return a
    both = np.concatenate([b, a])
    uniq, first = np.unique(both, axis=0, return_index=True)
    return uniq[first >= len(b)]


@dataclass(frozen=True)
class TripleDelta:
    """Content diff from one store version to a target residency."""

    base_version: object                 # store version this applies to
    add: np.ndarray = field(default_factory=lambda: np.zeros((0, 3),
                                                             dtype=np.int64))
    evict: np.ndarray = field(default_factory=lambda: np.zeros((0, 3),
                                                               dtype=np.int64))

    def __post_init__(self) -> None:
        object.__setattr__(self, "add", as_rows(self.add))
        object.__setattr__(self, "evict", as_rows(self.evict))

    @property
    def n_add(self) -> int:
        return len(self.add)

    @property
    def n_evict(self) -> int:
        return len(self.evict)

    @property
    def is_noop(self) -> bool:
        return not (len(self.add) or len(self.evict))

    @property
    def shipped_bytes(self) -> int:
        """Modeled cloud->edge wire bytes: full rows for adds, keys for
        evicts (the edge already holds evicted content)."""
        return (len(self.add) * ADD_WIRE_BYTES
                + len(self.evict) * EVICT_WIRE_BYTES)

    def inverse(self, base_version) -> "TripleDelta":
        """The delta undoing this one, applicable to ``base_version`` (the
        version the forward application produced)."""
        return TripleDelta(base_version=base_version,
                           add=self.evict, evict=self.add)


def delta_between(store, target_rows: np.ndarray) -> TripleDelta:
    """Delta turning ``store``'s current content into ``target_rows``.

    ``store`` is any :class:`repro_torch.rdf.graph.RDFStore`; ``target_rows`` is
    an ``[N, 3]`` row array (deduplicated internally). The result satisfies
    ``add ∩ current = ∅`` and ``evict ⊆ current``, which is what makes the
    inverse round-trip exact.
    """
    target = as_rows(target_rows)
    target = (np.unique(target, axis=0) if len(target)
              else target.reshape(0, 3))
    current = store.triples()
    return TripleDelta(base_version=store.version,
                       add=setdiff_rows(target, current),
                       evict=setdiff_rows(current, target))


def rows_at(cloud_store, edge_ids: np.ndarray) -> np.ndarray:
    """Cloud triple rows at the given (cloud-global) edge ids."""
    eids = np.unique(np.asarray(edge_ids, dtype=np.int64))
    return np.stack([cloud_store.s[eids], cloud_store.p[eids],
                     cloud_store.o[eids]], axis=1) if len(eids) else \
        np.zeros((0, 3), dtype=np.int64)
