"""Batched, backend-pluggable BGP query execution engine.

The paper's edge-cloud design (§3, Eq. 5) has every edge server execute a
*stream* of queries against its pattern-induced subgraphs, and the cloud the
rest against G. This module turns the single-query matcher into a serving
engine with three layers:

**1. Backend registry.** :class:`MatcherBackend` abstracts the per-pattern
candidate scan — the hot spot that touches every stored triple. Backends take
any :class:`repro_torch.rdf.graph.RDFStore` (the monolithic :class:`TripleStore` or
:class:`repro_torch.rdf.sharding.ShardedTripleStore`) and are registered by name
(``register_backend``) / constructed via ``get_backend(name)``:

- ``"numpy"`` — :class:`NumpyBackend`, the portable per-predicate-slice path
  (exactly :func:`repro_torch.sparql.matcher._candidates`). On a sharded store it
  scans shards independently and concatenates global triple ids — one shard
  for a bound predicate, a fan-out across shards for wildcard predicates.
- ``"torch"`` — :class:`TorchBackend`, routes scans through the
  ``triple_scan`` CUDA kernel on the card (the plain torch version when the
  caller asks for ``device="cpu"``). The pattern arrives as kernel
  arguments, so ONE build serves every pattern; batches of
  deduplicated scans go through ``triple_scan_many``. On a sharded store the
  backend stages *per-shard* device arrays and fuses each shard's scans into
  one launch per **touched** shard — a bound-predicate scan streams only the
  owning shard's triples (partition pruning), not the whole store.

Both backends return identical candidate-id *sets* (order may differ), so
join results are identical as solution multisets.

**2. Batching with scan dedup + a cross-round scan LRU.** Candidate scans
are keyed by their *scan key* — the pattern's constant components plus its
repeated-variable equality structure (variable *names* don't matter for the
scan). :meth:`QueryEngine.execute_batch` runs each distinct scan of a batch
once; results additionally land in a byte-bounded LRU so hot candidate
scans survive *between* batches (``scan_cache_hits`` /
``scan_cache_misses`` in :class:`EngineStats`). LRU keys are
**version-granular**: a bound-predicate scan on a sharded store keys on the
predicate's OWNING SHARD's version and stores shard-local ids (re-lifted by
the store's current offset at hit time), so a placement delta
(:mod:`repro_torch.rdf.deltas`) mutating other shards invalidates nothing here;
wildcard scans and monolithic stores key on the full store version. Cached
candidate arrays are shared — read-only.

**3. LRU result cache.** Full match results are memoized under the key
``(store.version, pattern-key)`` where *pattern-key* is the query's BGP
canonicalized by renaming variables in first-occurrence order — so
alpha-equivalent queries (same shape, same constants, different variable
names) share an entry, while queries differing in any constant do not.
``store.version`` is a hashable token unique to the store's *contents* (a
composite tuple over shard versions for sharded stores); rebalancing either
deploys a new store or mutates one in place through the delta protocol —
both take fresh version tokens, so stale entries can never be served (they
age out of the LRU).
Cached arrays are shared between hits — treat :class:`MatchResult` buffers
as read-only.

**4. Shard-parallel join pipeline.** Candidate scans are returned as
:class:`repro_torch.sparql.matcher.CandidateParts` — per-shard partitions instead
of one concatenated global id array — and each query executes under a
:func:`repro_torch.sparql.matcher.plan_bgp` plan: bound-predicate equi-joins run
shard-locally (probing the owning shard's presorted ``PredIndex``, no scan
and no per-join sort), and partial binding tables are merged only at
variable-predicate / cross-shard joins. ``shard_local_joins=False`` falls
back to the global scan+sort join (the ``--join`` baseline in
``benchmarks/bench_engine.py``). Per-phase stats land in
:class:`EngineStats`: ``prescan_seconds`` / ``join_seconds`` and the
``join`` :class:`~repro_torch.sparql.matcher.JoinStats` counters.

**5. Device-resident join pipeline (torch backend).** With
``TorchBackend(device_resident=True)`` (the default) and
``shard_local_joins`` on, every cache-missed query that
:func:`repro_torch.sparql.device_join.device_eligible` accepts — bound-predicate
star/path shapes with no repeated variables, whose every non-seed plan
step is a presorted probe — executes entirely on the card: the seed
scan (fused with its first probe via ``scan_probe`` where possible),
on-device compaction, and ``probe_sorted`` CUDA joins over staged
shard-local ``PredIndex`` views. All such queries of a batch share ONE
bulk device->host transfer (``EngineStats.host_transfers``; O(1)-byte
control scalars are counted separately as ``scalar_syncs``). Everything
else — variable predicates, repeated variables, equality-masked closing
joins — transparently falls back to the host pipeline above
(``device_queries`` / ``device_fallbacks`` record the split, and
``JoinStats.joins_device`` marks where each presorted join ran). Force
the host path with ``device_resident=False``. The backend runs on
``cuda`` unless the caller passes ``device="cpu"``, which runs the plain
torch versions of the kernels; the mode is reported in
``EngineStats.backend_mode`` (``"torch-cuda"`` / ``"torch-cpu"``).

**Cache key contracts.**

- *scan key* (:func:`scan_key`): constants + repeated-variable structure
  only — it deliberately ignores variable *spelling*, so ``(?x p ?y)`` and
  ``(?u p ?v)`` share one candidate scan.
- *query key* (:func:`query_key`): the BGP canonicalized by first-occurrence
  variable renaming; the projection is deliberately **excluded** — a cached
  :class:`MatchResult` binds all variables, and projection is applied by the
  caller, so queries differing only in ``SELECT`` lists share an entry.

**Thread safety.** One engine may serve overlapped server batches
(``EdgeCloudSystem.run_round_batched(overlap=True)``) from multiple
threads: the result/scan caches and stats are guarded by an internal lock,
while the NumPy/torch hot paths run outside it (they release the GIL on
large arrays, which is what makes overlapped rounds pay off).

Semantics: identical to per-query :func:`repro_torch.sparql.matcher.match_bgp` —
solution multisets are equal on every backend and store kind, asserted
against the oracle in ``tests/test_engine.py`` / ``tests/test_sharding.py``
/ ``tests/test_join_pipeline.py``.

**Layering.** This engine executes BGPs only. The SPARQL algebra layer
(:mod:`repro_torch.sparql.algebra`, surfaced by
:class:`repro_torch.sparql.endpoint.SparqlEndpoint`) sits on top: operator trees
whose BGP leaves are batched through :meth:`QueryEngine.execute_batch`, so
every cache and backend here serves full SELECT/ASK queries unchanged.
``QueryEngine.execute(QueryGraph)`` remains the thin BGP-subset shim.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..rdf.graph import RDFStore
from .device_join import DeviceBatch, device_eligible
from .matcher import (CandidateParts, JoinStats, MatchResult, _candidates,
                      match_bgp, plan_bgp)
from .query import QueryGraph, TriplePattern

# ---------------------------------------------------------------------------
# scan / query keys
# ---------------------------------------------------------------------------


def scan_key(tp: TriplePattern) -> tuple:
    """Identity of a candidate scan: constants + repeated-variable structure.

    Two patterns with the same constants and the same variable-repetition
    shape (e.g. ``(?x p ?x)`` vs ``(?y p ?y)``) select the same triple ids.
    """
    s = tp.s if isinstance(tp.s, int) else None
    p = tp.p if isinstance(tp.p, int) else None
    o = tp.o if isinstance(tp.o, int) else None
    rep_so = isinstance(tp.s, str) and isinstance(tp.o, str) and tp.s == tp.o
    rep_sp = isinstance(tp.s, str) and isinstance(tp.p, str) and tp.s == tp.p
    rep_op = isinstance(tp.o, str) and isinstance(tp.p, str) and tp.o == tp.p
    return (s, p, o, rep_so, rep_sp, rep_op)


def query_key(q: QueryGraph) -> tuple[tuple, dict[str, str]]:
    """(canonical BGP key, canonical->actual variable name map).

    Variables are renamed ``?_0, ?_1, ...`` in first-occurrence order over
    the patterns (s, p, o), so alpha-equivalent BGPs share a key. Projection
    is excluded: a :class:`MatchResult` binds *all* variables.
    """
    ren: dict[str, str] = {}

    def canon(t):
        if isinstance(t, int):
            return t
        if t not in ren:
            ren[t] = f"?_{len(ren)}"
        return ren[t]

    key = tuple((canon(tp.s), canon(tp.p), canon(tp.o)) for tp in q.patterns)
    return key, {v: k for k, v in ren.items()}


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class MatcherBackend:
    """Candidate-scan provider behind :class:`QueryEngine`.

    Contract: ``candidates(store, tp)`` returns exactly the *global* triple
    ids of ``store`` whose constant components match ``tp`` and whose
    repeated variables (if any) are satisfiable — the same *set* NumPy's
    ``_candidates`` yields, in any order. ``store`` is any
    :class:`repro_torch.rdf.graph.RDFStore`; shard-aware backends may exploit a
    sharded store's layout (``store.shards`` / ``store.shard_offsets``).
    """

    name = "abstract"

    def candidates(self, store: RDFStore, tp: TriplePattern) -> np.ndarray:
        raise NotImplementedError

    def candidate_parts(self, store: RDFStore,
                        tp: TriplePattern) -> CandidateParts:
        """Partitioned scan: per-shard global-id arrays (default: one part).

        Shard-aware backends override this so the matcher can join each
        partition shard-locally and merge partial binding tables only at
        variable-predicate / cross-shard joins.
        """
        return CandidateParts([self.candidates(store, tp)])

    def prescan_parts(self, store: RDFStore, tps: list[TriplePattern],
                      ) -> dict[tuple, CandidateParts]:
        """Partitioned scan of many deduplicated patterns up front."""
        out: dict[tuple, CandidateParts] = {}
        for tp in tps:
            k = scan_key(tp)
            if k not in out:
                out[k] = self.candidate_parts(store, tp)
        return out

    def prescan(self, store: RDFStore,
                tps: list[TriplePattern]) -> dict[tuple, np.ndarray]:
        """Scan many deduplicated patterns up front (concatenated ids)."""
        return {k: parts.concat()
                for k, parts in self.prescan_parts(store, tps).items()}


class NumpyBackend(MatcherBackend):
    """Portable path: per-predicate CSR slice + constant masks.

    Sharded stores are scanned shard-by-shard with local ``_candidates``
    calls whose results are lifted to global ids — exactly one shard for a
    bound-predicate pattern, all (non-empty) shards for a wildcard one.
    """

    name = "numpy"

    def candidate_parts(self, store: RDFStore,
                        tp: TriplePattern) -> CandidateParts:
        shards = getattr(store, "shards", None)
        if shards is None:
            return CandidateParts([_candidates(store, tp)])
        # A sharded store's global accessors would give the same answer, but
        # scanning shard-locally is the access shape a distributed deployment
        # needs (shards on separate hosts have no global arrays) — keep the
        # fan-out explicit and lift local ids by the shard offset. The parts
        # stay separate so the join can run shard-locally as well.
        if isinstance(tp.p, int):       # partition pruning: one owning shard
            k = store.shard_of_pred(tp.p)
            return CandidateParts(
                [_candidates(shards[k], tp) + store.shard_offsets[k]])
        return CandidateParts([_candidates(sh, tp) + off
                               for sh, off in store.parts()])

    def candidates(self, store: RDFStore, tp: TriplePattern) -> np.ndarray:
        return self.candidate_parts(store, tp).concat()


def _tree_leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _tree_leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tree_leaves(v, out)
    else:
        out.append(tree)


def _tree_rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_tree_leaves` order, by
    the next items of the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _tree_rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_rebuild(v, leaves) for v in tree)
    return next(leaves)


class TorchBackend(MatcherBackend):
    """Scans via the ``triple_scan`` CUDA kernel, joins optionally
    device-resident via the ``probe_sorted`` / ``scan_probe`` kernels.

    [T, 3] int32 triple tables are staged to ``device`` once per (shard)
    store version; every scan then evaluates a constant/wildcard mask on
    the device, followed by compaction and repeated-variable filters.
    ``device`` defaults to ``cuda`` (a ``RuntimeError`` when CUDA is
    missing); ``device="cpu"`` runs the kernels' plain torch versions.

    On a :class:`~repro_torch.rdf.sharding.ShardedTripleStore` each shard is
    staged as its own tensor, and a scan streams only the shards it can
    touch: the single predicate-owning shard for bound-predicate patterns,
    every non-empty shard for wildcard-predicate ones. ``prescan`` groups a
    batch's deduplicated scans by touched shard and fuses each group through
    ``triple_scan_many`` — one kernel launch per *touched shard*, not per
    pattern — then materializes every group's masks in ONE bulk
    device->host transfer.

    ``device_resident=True`` (default) additionally lets the engine run
    device-eligible queries fully on the device through
    :mod:`repro_torch.sparql.device_join` — shard-local ``pred_index``
    sorted views get their own staged LRU keyed by (shard version,
    predicate), so a placement delta invalidates only touched shards'
    views. ``host_transfers`` / ``host_transfer_bytes`` count bulk
    device->host copies (one packed ``.cpu()`` per :meth:`_fetch`, however
    many columns it carries); ``scalar_syncs`` counts the O(1) control
    scalars (row counts) host-driven allocation needs.
    """

    name = "torch"

    # device copies of (shard) triple arrays kept alive at once: one engine
    # serves cloud + K edge stores interleaved — and a sharded store stages
    # one array per shard — so a single slot would re-upload [T, 3] arrays
    # on every store switch within a round
    MAX_STAGED_STORES = 16
    # staged (shard version, predicate) sorted-view tuples for the device
    # join path; four small int32 arrays per hot predicate
    MAX_STAGED_VIEWS = 256

    def __init__(self, device: str | torch.device | None = None,
                 max_staged: int | None = None,
                 device_resident: bool = True) -> None:
        self.device = resolve_device(device)
        self.mode = f"torch-{self.device.type}"
        self.device_resident = bool(device_resident)
        self.max_staged = int(max_staged if max_staged is not None
                              else self.MAX_STAGED_STORES)
        self.max_staged_views = self.MAX_STAGED_VIEWS
        self._staged: OrderedDict[int, torch.Tensor] = OrderedDict()
        self._staged_views: OrderedDict[tuple, tuple] = OrderedDict()
        # transfer accounting (see class docstring); cumulative totals are
        # mirrored into EngineStats at every batch end
        self.host_transfers = 0
        self.host_transfer_bytes = 0
        self.scalar_syncs = 0
        # [T, 3] arrays copied to the device (staging LRU misses): a system
        # whose cloud and edge stores need more flat arrays than
        # ``max_staged`` re-uploads some of them every round
        self.staged_uploads = 0
        # staging LRU is shared across overlapped server batches
        self._stage_lock = threading.Lock()

    def _fetch(self, tree):
        """ONE bulk device->host copy of a nested list/tuple/dict of int32
        tensors: the leaves are packed into one device buffer, copied with
        one ``.cpu()`` and split on the host into numpy arrays of the same
        shapes. Every mask / binding-column transfer routes through here so
        ``host_transfers`` counts actual transfer events."""
        leaves: list = []
        _tree_leaves(tree, leaves)
        for a in leaves:
            if a.dtype != torch.int32:
                raise TypeError(f"_fetch moves int32 tensors, got {a.dtype}")
        packed = (torch.cat([a.reshape(-1) for a in leaves]) if leaves
                  else torch.zeros(0, dtype=torch.int32, device=self.device))
        host = packed.cpu().numpy()
        arrays, start = [], 0
        for a in leaves:
            n = a.numel()
            arrays.append(host[start:start + n].reshape(tuple(a.shape)))
            start += n
        with self._stage_lock:
            self.host_transfers += 1
            self.host_transfer_bytes += int(host.nbytes)
        return _tree_rebuild(tree, iter(arrays))

    def _scalar(self, x: torch.Tensor) -> int:
        """Sync one O(1) control scalar off the device (counted separately
        from bulk transfers — see the class docstring)."""
        with self._stage_lock:
            self.scalar_syncs += 1
        return int(x)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(self.device)

    def _triples(self, store, min_slots: int = 1) -> torch.Tensor:
        """Device [T, 3] int32 copy of one *flat* store (a shard or a
        monolithic :class:`TripleStore`), LRU-kept by store version.

        ``min_slots`` widens the eviction limit to the number of flat
        arrays the *current* store needs at once, so a sharded store with
        more shards than ``max_staged`` never evicts its own shards
        mid-round (which would re-upload the full store every scan).
        """
        with self._stage_lock:
            arr = self._staged.get(store.version)
            if arr is not None:
                self._staged.move_to_end(store.version)
                return arr
        if max(store.num_entities, store.num_predicates) >= 2 ** 31:
            raise ValueError("dictionary ids exceed int32 kernel range")
        arr = self._to_device(store.triples())
        with self._stage_lock:
            self.staged_uploads += 1
            self._staged[store.version] = arr
            limit = max(self.max_staged, min_slots)
            while len(self._staged) > limit:
                self._staged.popitem(last=False)
        return arr

    def _pred_views(self, store: RDFStore, pid: int):
        """Device copies of predicate ``pid``'s shard-LOCAL ``PredIndex``
        sorted views: ``((s_sorted, s_order, o_sorted, o_order), offset,
        flat_store)``, LRU-kept by (owning shard version, pid) — the same
        version-granular discipline as the scan LRU, so a delta-rebalance
        invalidates only touched shards' staged views."""
        flat, off = store.owning_part(pid)
        key = (flat.version, pid)
        with self._stage_lock:
            views = self._staged_views.get(key)
            if views is not None:
                self._staged_views.move_to_end(key)
                return views, off, flat
        idx = flat.pred_index(pid)
        views = tuple(self._to_device(a)
                      for a in (idx.s_sorted, idx.s_order,
                                idx.o_sorted, idx.o_order))
        with self._stage_lock:
            self._staged_views[key] = views
            while len(self._staged_views) > self.max_staged_views:
                self._staged_views.popitem(last=False)
        return views, off, flat

    @staticmethod
    def _store_slots(store: RDFStore) -> int:
        """Flat device arrays ``store`` occupies when fully staged."""
        shards = getattr(store, "shards", None)
        if shards is None:
            return 1
        return max(1, sum(1 for sh in shards if sh.num_triples))

    @staticmethod
    def _scan_parts(store: RDFStore, tp: TriplePattern
                    ) -> list[tuple[object, int]]:
        """(flat store, global offset) pairs a scan for ``tp`` must touch."""
        shards = getattr(store, "shards", None)
        if shards is None:
            return [(store, 0)]
        if isinstance(tp.p, int):       # partition pruning: one owning shard
            k = store.shard_of_pred(tp.p)
            pair = (shards[k], int(store.shard_offsets[k]))
            return [pair] if shards[k].num_triples else []
        return [(sh, int(off)) for sh, off in store.parts()]

    @staticmethod
    def _pattern_vec(tp: TriplePattern) -> np.ndarray:
        return np.asarray(
            [tp.s if isinstance(tp.s, int) else -1,
             tp.p if isinstance(tp.p, int) else -1,
             tp.o if isinstance(tp.o, int) else -1], dtype=np.int32)

    @staticmethod
    def _repeated_var_filter(store: RDFStore, tp: TriplePattern,
                             tids: np.ndarray) -> np.ndarray:
        if isinstance(tp.s, str) and isinstance(tp.o, str) and tp.s == tp.o:
            tids = tids[store.s[tids] == store.o[tids]]
        if isinstance(tp.s, str) and isinstance(tp.p, str) and tp.s == tp.p:
            tids = tids[store.s[tids] == store.p[tids]]
        if isinstance(tp.o, str) and isinstance(tp.p, str) and tp.o == tp.p:
            tids = tids[store.o[tids] == store.p[tids]]
        return tids

    def candidate_parts(self, store: RDFStore,
                        tp: TriplePattern) -> CandidateParts:
        from ..kernels.triple_scan import triple_scan

        pat = self._pattern_vec(tp).tolist()
        slots = self._store_slots(store)
        scan_parts = self._scan_parts(store, tp)
        masks = [triple_scan(self._triples(flat, min_slots=slots), pat)
                 for flat, _off in scan_parts]
        parts: list[np.ndarray] = []
        for (flat, off), mask in zip(scan_parts,
                                     self._fetch(masks) if masks else []):
            tids = np.flatnonzero(mask).astype(np.int64) + off
            # the repeated-variable filter distributes over partitions
            parts.append(self._repeated_var_filter(store, tp, tids))
        return CandidateParts(parts)

    def candidates(self, store: RDFStore, tp: TriplePattern) -> np.ndarray:
        return self.candidate_parts(store, tp).concat()

    def prescan_parts(self, store: RDFStore, tps: list[TriplePattern],
                      ) -> dict[tuple, CandidateParts]:
        from ..kernels.triple_scan import triple_scan_many

        uniq: dict[tuple, TriplePattern] = {}
        for tp in tps:
            uniq.setdefault(scan_key(tp), tp)
        if not uniq:
            return {}

        # group deduplicated scans by the flat store (shard) they touch;
        # a monolithic store is a single group
        groups: dict[int, tuple[object, int, list[tuple]]] = {}
        for k, tp in uniq.items():
            for flat, off in self._scan_parts(store, tp):
                g = groups.get(id(flat))
                if g is None:
                    g = groups[id(flat)] = (flat, off, [])
                g[2].append(k)

        slots = self._store_slots(store)
        parts: dict[tuple, list[np.ndarray]] = {k: [] for k in uniq}
        launches = []
        for flat, off, keys in groups.values():     # one launch per group
            pats = np.stack([self._pattern_vec(uniq[k]) for k in keys])
            launches.append((off, keys, triple_scan_many(
                self._triples(flat, min_slots=slots), self._to_device(pats))))
        # ONE bulk transfer materializes every group's masks together
        fetched = self._fetch([m for _, _, m in launches]) if launches else []
        for (off, keys, _), masks in zip(launches, fetched):
            for i, k in enumerate(keys):
                tids = np.flatnonzero(masks[i]).astype(np.int64) + off
                parts[k].append(
                    self._repeated_var_filter(store, uniq[k], tids))
        return {k: CandidateParts(parts[k]) for k in uniq}


_BACKENDS: dict[str, Callable[..., MatcherBackend]] = {}


def register_backend(name: str,
                     factory: Callable[..., MatcherBackend]) -> None:
    _BACKENDS[name] = factory


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def get_backend(name: str, **kw) -> MatcherBackend:
    if name not in _BACKENDS:
        raise KeyError(f"unknown matcher backend {name!r}; "
                       f"have {available_backends()}")
    return _BACKENDS[name](**kw)


register_backend("numpy", NumpyBackend)
register_backend("torch", TorchBackend)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclass
class EngineStats:
    """Engine counters.

    Scan-counter contract (asserted in ``tests/test_join_pipeline.py``):
    ``scans_requested`` counts per-pattern scan *requests* — once per
    planned scannable pattern of each result-cache-missed query at batch
    start, plus once per unplanned mid-join lookup in the ``scan()``
    closure (a key not covered by the batch's prescan). Planned patterns
    are never re-counted by the closure (their keys are always memoized
    before execution), so ``scans_requested >= scans_executed`` and
    ``scans_deduped`` can never go negative; every executed scan
    corresponds to exactly one scan-LRU miss (``scans_executed ==
    scan_cache_misses``). Patterns taking the shard-local presorted join
    (``JoinStep.use_pred_index``) never request a scan at all.

    Per-phase timings: ``prescan_seconds`` (candidate-scan phase),
    ``join_seconds`` (time inside ``match_bgp`` joins), ``exec_seconds``
    (whole ``execute_batch`` calls, summed across overlapped threads).
    ``join`` aggregates the :class:`~repro_torch.sparql.matcher.JoinStats`
    pipeline counters.

    Per-operator algebra counters (incremented by
    :mod:`repro_torch.sparql.algebra` through :meth:`QueryEngine.bump_stats`):
    ``bgp_leaves`` — BGP leaves executed through this engine on behalf of
    algebra plans (each also counts once in ``queries``);
    ``filters_applied`` / ``optional_joins`` — FILTER / OPTIONAL
    (left-join) operator applications; ``union_branches`` — branches
    fed into UNION concatenations; ``values_joins`` — inline VALUES
    tables materialized into joins.

    Device-residency counters: ``backend_mode`` is the resolved execution
    mode (``"numpy"``, ``"torch-cuda"``, ``"torch-cpu"``).
    ``device_queries`` / ``device_fallbacks`` split the cache-missed
    queries of a device-capable backend into those served by the
    device-resident pipeline (:mod:`repro_torch.sparql.device_join`) vs those
    that fell back to the host join path (ineligible shape: variable
    predicates, repeated variables, masked joins, wildcard seed on a
    sharded store). ``host_transfers`` / ``host_transfer_bytes`` /
    ``scalar_syncs`` MIRROR the backend's cumulative totals (absolute
    values re-copied at every batch end, so per-batch deltas are
    meaningful): ``host_transfers`` counts bulk device->host array
    materializations — exactly ONE per batch when every missed query is
    device-eligible, one more for the host path's fused prescan when the
    batch is mixed — while ``scalar_syncs`` counts the O(1)-byte row-count
    reads host-driven allocation needs (excluded from the one-transfer
    contract; see :mod:`repro_torch.sparql.device_join`).
    """

    queries: int = 0
    batches: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    scans_requested: int = 0
    scans_executed: int = 0
    scan_cache_hits: int = 0
    scan_cache_misses: int = 0
    scan_cache_evictions: int = 0
    exec_seconds: float = 0.0
    prescan_seconds: float = 0.0
    join_seconds: float = 0.0
    join: JoinStats = field(default_factory=JoinStats)
    bgp_leaves: int = 0
    filters_applied: int = 0
    optional_joins: int = 0
    union_branches: int = 0
    values_joins: int = 0
    backend_mode: str = ""
    device_queries: int = 0
    device_fallbacks: int = 0
    host_transfers: int = 0
    host_transfer_bytes: int = 0
    scalar_syncs: int = 0

    @property
    def scans_deduped(self) -> int:
        return self.scans_requested - self.scans_executed


class QueryEngine:
    """Batched BGP executor with scan dedup and an LRU result cache.

    See the module docstring for batching semantics and cache keying.
    ``cache_size`` bounds the number of memoized :class:`MatchResult`s
    (0 disables caching). One engine instance may serve many stores — cache
    keys embed ``store.version``.
    """

    def __init__(self, backend: str | MatcherBackend = "torch",
                 cache_size: int = 256, max_rows: int = 5_000_000,
                 cache_bytes: int = 512 * 1024 * 1024,
                 scan_cache_bytes: int = 64 * 1024 * 1024,
                 scan_cache_size: int = 4096,
                 shard_local_joins: bool = True) -> None:
        self.backend = (backend if isinstance(backend, MatcherBackend)
                        else get_backend(backend))
        self.cache_size = int(cache_size)
        # one result near max_rows can be hundreds of MB of int64 bindings,
        # so the LRU is bounded by bytes as well as entry count
        self.cache_bytes = int(cache_bytes)
        # candidate-scan LRU keyed (store.version, scan key): hot scans
        # survive between batches (scan_cache_bytes=0 disables). The count
        # bound matters independently of the byte bound: empty candidate
        # arrays are 0 bytes, so probe-miss workloads would otherwise grow
        # the dict without limit as store versions churn.
        self.scan_cache_bytes = int(scan_cache_bytes)
        self.scan_cache_size = int(scan_cache_size)
        self.max_rows = int(max_rows)
        # False = global scan+sort joins (the pre-shard-parallel baseline,
        # kept as the --join benchmark reference)
        self.shard_local_joins = bool(shard_local_joins)
        self.stats = EngineStats()
        self.stats.backend_mode = getattr(self.backend, "mode",
                                          self.backend.name)
        self._cache: OrderedDict[tuple, MatchResult] = OrderedDict()
        self._cached_bytes = 0
        # values are (CandidateParts, put-time global-id offset)
        self._scan_cache: OrderedDict[tuple, tuple] = OrderedDict()
        self._scan_cached_bytes = 0
        # join plans keyed (store.version, canonical BGP key): planning is
        # pure-Python (GIL-bound), so memoizing it both speeds cold batches
        # and shrinks the serialized fraction of overlapped rounds
        self._plan_cache: OrderedDict[tuple, list] = OrderedDict()
        self._plan_cache_size = 4096
        # guards caches + stats when one engine serves overlapped server
        # batches from multiple threads; the matcher hot path runs unlocked
        self._lock = threading.RLock()

    def cache_probe(self, store: RDFStore, q: QueryGraph) -> dict:
        """Non-mutating cache provenance for one BGP: would this query hit
        the result cache, and how many of its planned candidate scans sit
        in the scan LRU? Counters are NOT incremented — this is the
        read-only surface ``explain`` (:func:`repro_torch.sparql.algebra.
        explain_plan`) builds on, keeping the cache representation private
        to this module.

        Returns ``{"result_cached": bool, "scans_cached": int,
        "scans_total": int}``.
        """
        ck, _ = query_key(q)
        with self._lock:
            hit = (store.version, ck) in self._cache
        plan = plan_bgp(store, q, shard_local=self.shard_local_joins)
        scannable = [q.patterns[st.pattern] for st in plan if st.needs_scan]
        cached = 0
        for tp in scannable:
            key, _off = self._scan_entry(store, tp, scan_key(tp))
            with self._lock:
                cached += key in self._scan_cache
        return {"result_cached": hit, "scans_cached": cached,
                "scans_total": len(scannable)}

    def bump_stats(self, **counters: int) -> None:
        """Thread-safely increment :class:`EngineStats` integer counters —
        how the algebra evaluator (:mod:`repro_torch.sparql.algebra`) reports
        per-operator counts into the shared engine stats."""
        with self._lock:
            for name, n in counters.items():
                setattr(self.stats, name, getattr(self.stats, name) + n)

    # -- cache ---------------------------------------------------------------
    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()
            self._cached_bytes = 0
            self._scan_cache.clear()
            self._scan_cached_bytes = 0
            # join plans survive: like store.pred_index they are derived
            # metadata (store-version-keyed, never stale), not cached data

    def _plan_for(self, store: RDFStore, q: QueryGraph, ck: tuple) -> list:
        key = (store.version, ck)
        with self._lock:
            plan = self._plan_cache.get(key)
            if plan is not None:
                self._plan_cache.move_to_end(key)
                return plan
        plan = plan_bgp(store, q, shard_local=self.shard_local_joins)
        with self._lock:
            self._plan_cache[key] = plan
            while len(self._plan_cache) > self._plan_cache_size:
                self._plan_cache.popitem(last=False)
        return plan

    def _cache_get(self, key: tuple) -> MatchResult | None:
        with self._lock:
            res = self._cache.get(key)
            if res is not None:
                self._cache.move_to_end(key)
                self.stats.cache_hits += 1
            else:
                self.stats.cache_misses += 1
            return res

    @staticmethod
    def _result_bytes(res: MatchResult) -> int:
        return int(res.bindings.nbytes + res.edge_ids.nbytes)

    def _cache_put(self, key: tuple, res: MatchResult) -> None:
        if self.cache_size <= 0:
            return
        nbytes = self._result_bytes(res)
        if nbytes > self.cache_bytes:
            return                       # would evict everything; skip
        with self._lock:
            displaced = self._cache.pop(key, None)
            if displaced is not None:    # overwrite: release the old bytes
                self._cached_bytes -= self._result_bytes(displaced)
            self._cache[key] = res
            self._cached_bytes += nbytes
            while (len(self._cache) > self.cache_size
                   or self._cached_bytes > self.cache_bytes):
                _, old = self._cache.popitem(last=False)
                self._cached_bytes -= self._result_bytes(old)
                self.stats.cache_evictions += 1

    # -- scan cache ----------------------------------------------------------
    @staticmethod
    def _scan_entry(store: RDFStore, tp: TriplePattern,
                    k: tuple) -> tuple[tuple, int]:
        """(cache key, global-id offset) for one candidate scan.

        Version-granular invalidation: a bound-predicate scan on a sharded
        store touches exactly the predicate's owning shard, so its entry is
        keyed by that SHARD's version and stored in shard-local ids — a
        placement delta (:mod:`repro_torch.rdf.deltas`) mutating other shards
        leaves the entry valid, and the store's *current* offset re-lifts
        the ids at hit time (offsets shift when earlier shards grow). All
        other scans (wildcard predicate, monolithic store) key on the full
        store version with offset 0. Shard version tokens are globally
        unique, so entries can never collide across stores — and a shard
        queried directly as a flat store shares its entries for free.
        """
        shards = getattr(store, "shards", None)
        if shards is not None and isinstance(tp.p, int):
            sid = store.shard_of_pred(tp.p)
            return ((shards[sid].version, k),
                    int(store.shard_offsets[sid]))
        return (store.version, k), 0

    def _scan_lookup(self, store: RDFStore, tp: TriplePattern,
                     k: tuple) -> CandidateParts | None:
        key, off = self._scan_entry(store, tp, k)
        hit = self._scan_cache_get(key)
        if hit is None:
            return None
        parts, stored_off = hit
        # ids stored at put-time offsets: zero-copy (shift 0) until a delta
        # actually moves this shard's offset or another store reuses the
        # shard at a different global position
        return parts.shifted(off - stored_off)

    def _scan_store(self, store: RDFStore, tp: TriplePattern, k: tuple,
                    parts: CandidateParts) -> None:
        key, off = self._scan_entry(store, tp, k)
        self._scan_cache_put(key, (parts, off))

    def _scan_cache_get(self, key: tuple):
        with self._lock:
            parts = self._scan_cache.get(key)
            if parts is not None:
                self._scan_cache.move_to_end(key)
                self.stats.scan_cache_hits += 1
            else:
                self.stats.scan_cache_misses += 1
            return parts

    def _scan_cache_put(self, key: tuple, entry) -> None:
        """``entry`` is ``(CandidateParts, put_time_offset)`` — see
        :meth:`_scan_lookup`."""
        if self.scan_cache_bytes <= 0:
            return
        nbytes = int(entry[0].nbytes)
        if nbytes > self.scan_cache_bytes:
            return
        with self._lock:
            displaced = self._scan_cache.pop(key, None)
            if displaced is not None:
                self._scan_cached_bytes -= int(displaced[0].nbytes)
            self._scan_cache[key] = entry
            self._scan_cached_bytes += nbytes
            while (len(self._scan_cache) > self.scan_cache_size
                   or self._scan_cached_bytes > self.scan_cache_bytes):
                _, old = self._scan_cache.popitem(last=False)
                self._scan_cached_bytes -= int(old[0].nbytes)
                self.stats.scan_cache_evictions += 1

    @staticmethod
    def _remap(res: MatchResult, canon_to_actual: dict[str, str]
               ) -> MatchResult:
        """Re-label a cached canonical result with a query's variable names."""
        return MatchResult(
            var_names=[canon_to_actual[v] for v in res.var_names],
            bindings=res.bindings, edge_ids=res.edge_ids)

    @staticmethod
    def _canonical(q: QueryGraph, canon_to_actual: dict[str, str]
                   ) -> QueryGraph:
        """``q`` under canonical variable names, so execution results are
        independent of this query's variable spelling (cache-entry form)."""
        actual_to_canon = {a: c for c, a in canon_to_actual.items()}
        return QueryGraph(
            patterns=[TriplePattern(
                *(actual_to_canon.get(t, t) if isinstance(t, str)
                  else t for t in (tp.s, tp.p, tp.o)))
                for tp in q.patterns],
            projection=[])

    # -- execution -----------------------------------------------------------
    def execute(self, store: RDFStore, q: QueryGraph) -> MatchResult:
        return self.execute_batch(store, [q])[0]

    def execute_batch(self, store: RDFStore,
                      queries: list[QueryGraph]) -> list[MatchResult]:
        """Execute ``queries`` against ``store``; results align by index.

        Identical candidate scans run once per batch and are retained in the
        cross-batch scan LRU; alpha-equivalent queries resolve from the
        result cache (within the batch and across calls, until the store
        version changes).
        """
        t0 = time.perf_counter()
        with self._lock:
            self.stats.batches += 1
            self.stats.queries += len(queries)

        keyed = [query_key(q) for q in queries]
        with self._lock:
            misses = [i for i, (ck, _) in enumerate(keyed)
                      if (store.version, ck) not in self._cache]

        # plan each cache-missed query so only the patterns the join
        # pipeline will actually scan are prescanned (shard-local presorted
        # joins skip the scan entirely); scan memo seeded from the
        # cross-batch scan LRU, the remaining distinct keys execute once.
        # Device-eligible queries peel off into the device-resident pipeline
        # instead — their scans and joins never touch the host scan path
        # (or its counters), and their bindings leave the device in one
        # bulk transfer at the end of the device phase.
        memo: dict[tuple, CandidateParts] = {}
        plans: dict[int, list] = {}
        device_jobs: dict[tuple, tuple] = {}    # ck -> (canonical q, plan)
        join_stats = JoinStats()
        join_dt = 0.0
        use_device = (self.shard_local_joins
                      and getattr(self.backend, "device_resident", False))
        if misses:
            need: list[TriplePattern] = []
            for i in misses:
                ck, canon_to_actual = keyed[i]
                plans[i] = self._plan_for(store, queries[i], ck)
                if use_device:
                    if ck in device_jobs:
                        with self._lock:
                            self.stats.device_queries += 1
                        continue
                    cq = self._canonical(queries[i], canon_to_actual)
                    if device_eligible(store, cq, plans[i]):
                        device_jobs[ck] = (cq, plans[i])
                        with self._lock:
                            self.stats.device_queries += 1
                        continue
                    with self._lock:
                        self.stats.device_fallbacks += 1
                need += [queries[i].patterns[st.pattern]
                         for st in plans[i] if st.needs_scan]
            with self._lock:
                self.stats.scans_requested += len(need)
            uniq: dict[tuple, TriplePattern] = {}
            for tp in need:
                uniq.setdefault(scan_key(tp), tp)
            fresh: list[TriplePattern] = []
            for k, tp in uniq.items():
                hit = self._scan_lookup(store, tp, k)
                if hit is not None:
                    memo[k] = hit
                else:
                    fresh.append(tp)
            if fresh:
                t_scan = time.perf_counter()
                scanned = self.backend.prescan_parts(store, fresh)
                memo.update(scanned)
                for k, parts in scanned.items():
                    self._scan_store(store, uniq[k], k, parts)
                with self._lock:
                    self.stats.scans_executed += len(scanned)
                    self.stats.prescan_seconds += (time.perf_counter()
                                                   - t_scan)

        # device-resident phase: all queued queries execute on device, then
        # ONE bulk device->host transfer materializes their results
        device_results: dict[tuple, MatchResult] = {}
        if device_jobs:
            t_dev = time.perf_counter()
            dbatch = DeviceBatch(self.backend, store)
            for ck, (cq, plan) in device_jobs.items():
                dbatch.add(ck, cq, plan)
            device_results = dbatch.run(max_rows=self.max_rows,
                                        stats=join_stats)
            join_dt += time.perf_counter() - t_dev

        def scan(st: RDFStore, tp: TriplePattern) -> CandidateParts:
            k = scan_key(tp)
            if k not in memo:          # unplanned pattern added mid-join
                with self._lock:
                    self.stats.scans_requested += 1
                parts = self._scan_lookup(st, tp, k)
                if parts is None:
                    parts = self.backend.candidate_parts(st, tp)
                    self._scan_store(st, tp, k, parts)
                    with self._lock:
                        self.stats.scans_executed += 1
                memo[k] = parts
            return memo[k]

        out: list[MatchResult | None] = [None] * len(queries)
        for i, q in enumerate(queries):
            ck, canon_to_actual = keyed[i]
            cached = self._cache_get((store.version, ck))
            if cached is None:
                dres = device_results.get(ck)
                if dres is not None:
                    cached = dres
                else:
                    # execute under canonical names so the cached entry is
                    # independent of this query's variable spelling
                    canon_q = self._canonical(q, canon_to_actual)
                    t_join = time.perf_counter()
                    cached = match_bgp(store, canon_q,
                                       max_rows=self.max_rows,
                                       candidates=scan, plan=plans.get(i),
                                       stats=join_stats,
                                       shard_local=self.shard_local_joins)
                    join_dt += time.perf_counter() - t_join
                self._cache_put((store.version, ck), cached)
            out[i] = self._remap(cached, canon_to_actual)
        with self._lock:
            self.stats.join_seconds += join_dt
            self.stats.join.merge(join_stats)
            bk = self.backend
            if hasattr(bk, "host_transfers"):
                # absolute backend totals, re-mirrored each batch so
                # callers can take per-batch deltas
                self.stats.host_transfers = bk.host_transfers
                self.stats.host_transfer_bytes = bk.host_transfer_bytes
                self.stats.scalar_syncs = bk.scalar_syncs
            self.stats.exec_seconds += time.perf_counter() - t0
        return out
