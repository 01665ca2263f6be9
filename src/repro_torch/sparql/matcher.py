"""Vectorized BGP homomorphism matching over any :class:`RDFStore`.

This is the query engine that runs on both the cloud and the edge servers
(the paper uses Neptune / gStore; see DESIGN.md §3 for why we re-express
matching as data-parallel binding-table joins for a TPU-native system).
In the full-SPARQL stack this matcher is the **leaf executor**: the
algebra layer (:mod:`repro_torch.sparql.algebra`) compiles FILTER / OPTIONAL /
UNION / modifier queries to operator trees whose BGP leaves each run one
:func:`match_bgp` through the batched engine.

Algorithm: greedy selectivity-ordered left-deep join, planned by
:func:`plan_bgp`:

1. estimate cardinality of every triple pattern from per-predicate stats;
2. start from the most selective pattern, then repeatedly join in the
   connected pattern with the lowest estimated cost;
3. each join is a sort/``searchsorted`` equi-join on one shared variable
   (a vertex variable when one is bound, else a bound *predicate*
   variable), followed by equality masks for any other shared components.

**Shard-parallel joins.** Candidate scans arrive as
:class:`CandidateParts` — partition-disjoint global-id arrays, one per
touched shard of a :class:`repro_torch.rdf.sharding.ShardedTripleStore` (a
monolithic store is a single partition). An equi-join distributes over any
partition of the probe side, so each partition is sorted and probed
*shard-locally* and the partial binding tables are merged only afterwards —
merging happens exactly at variable-predicate / cross-shard joins, since a
bound-predicate pattern's candidates always live in one shard
(predicate-hash partitioning). Bound-predicate patterns whose subject and
object are both unconstrained variables skip the scan + per-join sort
entirely and probe the owning shard's cached :class:`~repro_torch.rdf.graph.
PredIndex` sorted views (``plan_bgp`` marks these steps
``use_pred_index``); the sort is built once per (shard, predicate) and
amortized across every query in the workload.

**Capacity.** ``max_rows`` bounds the *surviving* (post-equality-mask) rows
of each join: the expansion is processed in chunks of at most ``max_rows``
pre-mask rows, so a join whose raw fan-out is huge but whose true result is
small no longer raises :class:`MatchCapacityError`.

The per-pattern *candidate scan* (predicate slice + constant masks) is exactly
what the ``triple_scan`` CUDA kernel accelerates on the GPU; the NumPy path here
is the portable implementation with identical semantics. The matcher only
touches the :class:`repro_torch.rdf.graph.RDFStore` accessor surface (global triple
ids), so it runs unchanged over the monolithic :class:`TripleStore` or the
sharded :class:`repro_torch.rdf.sharding.ShardedTripleStore`.

Semantics: SPARQL BGP solutions = homomorphisms (paper Def. 3). Variables may
map to the same vertex; a variable predicate matches any edge label. Each
solution row binds every variable and records the matched triple (edge) id per
pattern — the latter feeds pattern-induced subgraph construction (Def. 5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..rdf.graph import RDFStore
from .query import QueryGraph, TriplePattern


class MatchCapacityError(RuntimeError):
    """Raised when an intermediate binding table exceeds the row cap."""


class CandidateParts:
    """Partition-disjoint candidate triple ids for one pattern scan.

    ``parts`` holds one global-id array per touched shard (a monolithic
    store contributes a single partition). Partitions are disjoint by
    construction — a triple id lives in exactly one shard — which is what
    makes the per-partition (shard-local) equi-join sound: the join
    distributes over any partition of the probe side, and the partial
    binding tables are simply concatenated.
    """

    __slots__ = ("parts",)

    def __init__(self, parts) -> None:
        self.parts: list[np.ndarray] = [
            np.asarray(p, dtype=np.int64) for p in parts if len(p)]

    @classmethod
    def of(cls, cand) -> "CandidateParts":
        """Normalize a plain tid array (legacy scan result) to one part."""
        return cand if isinstance(cand, cls) else cls([cand])

    @property
    def nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.parts)

    @property
    def total(self) -> int:
        return sum(len(p) for p in self.parts)

    def concat(self) -> np.ndarray:
        if not self.parts:
            return np.zeros(0, dtype=np.int64)
        if len(self.parts) == 1:
            return self.parts[0]
        return np.concatenate(self.parts)

    def shifted(self, delta: int) -> "CandidateParts":
        """A copy with every id shifted by ``delta`` (``0`` returns self).

        Lets the engine's scan LRU store bound-predicate candidates in
        shard-LOCAL coordinates keyed by the owning shard's version: a
        placement delta to another shard moves this shard's global-id
        offset but not its content, and the hit is re-lifted here.
        """
        if not delta:
            return self
        out = CandidateParts.__new__(CandidateParts)
        out.parts = [p + delta for p in self.parts]
        return out

    def __len__(self) -> int:  # pragma: no cover - convenience
        return self.total


@dataclass
class JoinStats:
    """Per-phase join-pipeline counters (surfaced via ``EngineStats.join``).

    ``joins_pred_index``: shard-local presorted equi-joins (no scan, no
    per-join sort — the owning shard's cached ``PredIndex`` is probed).
    ``joins_vertex``: generic sorted equi-joins on a bound vertex variable.
    ``joins_pred_var``: equi-joins on a bound *predicate* variable (the path
    that used to fall through to a cartesian expansion).
    ``joins_cartesian``: seed expansions + genuinely disconnected products.
    ``partitions_probed``: candidate partitions probed across all joins.
    ``merged_joins``: joins that merged >1 partition's partial bindings
    (variable-predicate / cross-shard joins on a sharded store).
    ``joins_device``: presorted joins executed by the device-resident
    pipeline (:mod:`repro_torch.sparql.device_join`) through the
    ``probe_sorted`` / ``scan_probe`` CUDA kernels instead of host
    ``searchsorted``; every such join ALSO counts in ``joins_pred_index``
    (it is the same plan step), so host/device runs agree on every other
    counter and ``joins_device`` isolates where the join ran.
    """

    joins_pred_index: int = 0
    joins_vertex: int = 0
    joins_pred_var: int = 0
    joins_cartesian: int = 0
    partitions_probed: int = 0
    merged_joins: int = 0
    joins_device: int = 0

    def merge(self, other: "JoinStats") -> None:
        self.joins_pred_index += other.joins_pred_index
        self.joins_vertex += other.joins_vertex
        self.joins_pred_var += other.joins_pred_var
        self.joins_cartesian += other.joins_cartesian
        self.partitions_probed += other.partitions_probed
        self.merged_joins += other.merged_joins
        self.joins_device += other.joins_device


@dataclass
class MatchResult:
    """All homomorphic matches of a query.

    ``var_names``: binding columns (vertex + predicate variables)
    ``bindings``:  [R, V] int64 — entity/predicate ids per solution
    ``edge_ids``:  [R, E] int64 — matched triple id per original pattern
    """

    var_names: list[str]
    bindings: np.ndarray
    edge_ids: np.ndarray

    @property
    def num_matches(self) -> int:
        return self.bindings.shape[0]

    def column(self, var: str) -> np.ndarray:
        return self.bindings[:, self.var_names.index(var)]

    def project(self, projection: list[str]) -> np.ndarray:
        """[R, len(projection)] solution table (SPARQL multiset semantics)."""
        if not projection:
            return self.bindings
        idx = [self.var_names.index(v) for v in projection]
        return self.bindings[:, idx]

    def result_bytes(self, projection: list[str]) -> int:
        """Modeled result size w_n: 8 bytes per projected binding cell."""
        proj = self.project(projection)
        return int(proj.shape[0] * max(1, proj.shape[1]) * 8)


def estimate_pattern_cardinality(store: RDFStore, tp: TriplePattern) -> float:
    """Selectivity-style cardinality estimate (Stocker et al., WWW'08)."""
    if isinstance(tp.p, int):
        n = float(store.pred_count[tp.p])
        ds = max(1.0, float(store.pred_distinct_s[tp.p]))
        do = max(1.0, float(store.pred_distinct_o[tp.p]))
    else:
        n = float(store.num_triples)
        ds = max(1.0, float(np.mean(store.pred_distinct_s))
                 if store.num_predicates else 1.0)
        do = max(1.0, float(np.mean(store.pred_distinct_o))
                 if store.num_predicates else 1.0)
    if isinstance(tp.s, int):
        n /= ds
    if isinstance(tp.o, int):
        n /= do
    return max(n, 0.0)


def _candidates(store: RDFStore, tp: TriplePattern) -> np.ndarray:
    """Triple ids satisfying the constant components of ``tp``."""
    if isinstance(tp.p, int):
        tids = store.pred_tids(tp.p)
    else:
        tids = np.arange(store.num_triples, dtype=np.int64)
    if isinstance(tp.s, int):
        tids = tids[store.s[tids] == tp.s]
    if isinstance(tp.o, int):
        tids = tids[store.o[tids] == tp.o]
    # intra-pattern repeated variables, e.g. (?x, p, ?x) or (?x, ?x, ?y)
    if (isinstance(tp.s, str) and isinstance(tp.o, str) and tp.s == tp.o):
        tids = tids[store.s[tids] == store.o[tids]]
    if (isinstance(tp.s, str) and isinstance(tp.p, str) and tp.s == tp.p):
        tids = tids[store.s[tids] == store.p[tids]]
    if (isinstance(tp.o, str) and isinstance(tp.p, str) and tp.o == tp.p):
        tids = tids[store.o[tids] == store.p[tids]]
    return tids


def _order_patterns(store: RDFStore, q: QueryGraph) -> list[int]:
    """Greedy selectivity-ordered, connectivity-respecting pattern order."""
    n = len(q.patterns)
    est = [estimate_pattern_cardinality(store, tp) for tp in q.patterns]
    bound: set[str] = set()
    remaining = set(range(n))
    order: list[int] = []
    while remaining:
        def key(i: int) -> tuple:
            tp = q.patterns[i]
            shared = sum(1 for v in tp.variables() if v in bound)
            connected = 1 if (shared > 0 or not order) else 0
            return (-connected, -shared, est[i], i)
        pick = min(remaining, key=key)
        order.append(pick)
        remaining.remove(pick)
        bound.update(q.patterns[pick].variables())
    return order


@dataclass(frozen=True)
class JoinStep:
    """One planned step of the left-deep join pipeline.

    ``kind``: ``"seed"`` (first pattern / unit-table expansion),
    ``"vertex"`` (equi-join on a bound vertex variable), ``"pred"``
    (equi-join on a bound predicate variable), or ``"cartesian"``
    (disconnected component — no shared bound variable at all).
    ``use_pred_index``: the step probes the owning shard's cached
    ``PredIndex`` sorted views instead of scanning + sorting candidates;
    such steps never request a candidate scan (``needs_scan`` is False).
    ``device_probe``: the step is additionally *device-capable* — a
    ``use_pred_index`` join whose other endpoint is still unbound at this
    step, so no equality masks apply and the whole join is expressible as
    the ``probe_sorted`` kernel + torch expansion. Backends without device
    residency (numpy, or torch with ``device_resident=False``) simply ignore
    the flag and run the step on the host — the transparent fallback.
    """

    pattern: int
    kind: str
    use_pred_index: bool = False
    device_probe: bool = False

    @property
    def needs_scan(self) -> bool:
        return not self.use_pred_index


def plan_bgp(store: RDFStore, q: QueryGraph,
             shard_local: bool = True) -> list[JoinStep]:
    """Join plan for ``q``: pattern order + join kind per step.

    Walks :func:`_order_patterns` tracking the bound-variable set, so the
    engine can know *before execution* which patterns will request a
    candidate scan (``JoinStep.needs_scan``) and which will take the
    shard-local presorted ``pred_index`` path. ``shard_local=False`` disables
    the presorted path (every step scans + sorts globally) — the baseline
    mode benchmarked by ``bench_engine.py --join``.
    """
    steps: list[JoinStep] = []
    bound: set[str] = set()
    for j, i in enumerate(_order_patterns(store, q)):
        tp = q.patterns[i]
        svar = tp.s if isinstance(tp.s, str) else None
        ovar = tp.o if isinstance(tp.o, str) else None
        pvar = tp.p if isinstance(tp.p, str) else None
        dp = False
        if j == 0:
            kind, upi = "seed", False
        elif svar in bound or ovar in bound:
            kind = "vertex"
            # presorted shard-local join: candidates are exactly the owning
            # shard's predicate slice (no constants, no repeated variables)
            upi = (shard_local and isinstance(tp.p, int)
                   and svar is not None and ovar is not None
                   and svar != ovar)
            # device-capable when exactly one endpoint is bound: no
            # equality masks, so probe + expansion covers the whole join
            dp = upi and not (svar in bound and ovar in bound)
        elif pvar in bound:
            kind, upi = "pred", False
        else:
            kind, upi = "cartesian", False
        steps.append(JoinStep(pattern=i, kind=kind, use_pred_index=upi,
                              device_probe=dp))
        bound.update(tp.variables())
    return steps


def _probe_partitions(views, tvals, checks, max_rows: int,
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-partition ``searchsorted`` probe with chunked expansion.

    ``views``: [(keys_sorted, tids_in_key_order)] — one per candidate
    partition (shard). ``tvals``: the binding column being joined.
    ``checks``: [(store_column, binding_column_values)] equality masks for
    other already-bound components, applied *per chunk* so ``max_rows``
    bounds the surviving rows, not the raw pre-mask fan-out. Returns
    (row_idx, sel_tid) of the merged partial joins.
    """
    out_rows: list[np.ndarray] = []
    out_tids: list[np.ndarray] = []
    kept = 0
    R = len(tvals)
    chunk_cap = max(int(max_rows), 1)

    def emit(row_idx: np.ndarray, sel: np.ndarray) -> None:
        nonlocal kept
        mask = None
        for col, bvals in checks:
            m = col[sel] == bvals[row_idx]
            mask = m if mask is None else (mask & m)
        if mask is not None and not mask.all():
            row_idx, sel = row_idx[mask], sel[mask]
        kept += len(sel)
        if kept > max_rows:
            raise MatchCapacityError(
                f"join would keep more than {max_rows} rows")
        if len(sel):
            out_rows.append(row_idx)
            out_tids.append(sel)

    for keys, stids in views:
        lo = np.searchsorted(keys, tvals, side="left")
        hi = np.searchsorted(keys, tvals, side="right")
        counts = hi - lo
        cum = np.cumsum(counts)
        if not len(cum) or not cum[-1]:
            continue
        r0 = 0
        while r0 < R:
            base = int(cum[r0 - 1]) if r0 else 0
            r1 = int(np.searchsorted(cum, base + chunk_cap, side="right"))
            if r1 <= r0:
                # a single row's fan-out exceeds the cap: sub-chunk its
                # candidate range so peak memory stays ~chunk_cap rows
                lo_r, hi_r = int(lo[r0]), int(hi[r0])
                for c0 in range(lo_r, hi_r, chunk_cap):
                    sel = stids[c0:min(c0 + chunk_cap, hi_r)]
                    emit(np.full(len(sel), r0, dtype=np.int64), sel)
                r0 += 1
                continue
            c_counts = counts[r0:r1]
            c_total = int(cum[r1 - 1]) - base
            if c_total:
                row_idx = np.repeat(np.arange(r0, r1), c_counts)
                starts = np.repeat(lo[r0:r1], c_counts)
                within = (np.arange(c_total)
                          - np.repeat(np.cumsum(c_counts) - c_counts,
                                      c_counts))
                emit(row_idx, stids[starts + within])
            r0 = r1
    if not out_rows:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    return np.concatenate(out_rows), np.concatenate(out_tids)


def match_bgp(store: RDFStore, q: QueryGraph,
              max_rows: int = 5_000_000,
              candidates=None, plan: list[JoinStep] | None = None,
              stats: JoinStats | None = None,
              shard_local: bool = True) -> MatchResult:
    """All homomorphic matches of ``q`` over ``store`` (paper Def. 3).

    ``candidates``: optional ``(store, tp) -> tids | CandidateParts``
    override for the per-pattern candidate scan — how
    :mod:`repro_torch.sparql.engine` routes scans through a pluggable backend
    (NumPy slicing or the ``triple_scan`` CUDA kernel) and deduplicates
    them across a query batch. Must return exactly the triple ids
    :func:`_candidates` would (any order); a :class:`CandidateParts` keeps
    per-shard partitions so the join runs shard-locally and merges partial
    binding tables only at variable-predicate / cross-shard joins.

    ``plan``: precomputed :func:`plan_bgp` output (the engine passes it so
    planning isn't repeated); ``stats``: optional :class:`JoinStats` to
    increment; ``shard_local``: forwarded to :func:`plan_bgp` when planning
    here.
    """
    if candidates is None:
        candidates = _candidates
    if plan is None:
        plan = plan_bgp(store, q, shard_local=shard_local)
    var_names: list[str] = []
    bindings = np.zeros((1, 0), dtype=np.int64)   # one empty row = unit table
    edge_cols: dict[int, np.ndarray] = {}

    for step in plan:
        pat_i = step.pattern
        tp = q.patterns[pat_i]
        svar = tp.s if isinstance(tp.s, str) else None
        ovar = tp.o if isinstance(tp.o, str) else None
        pvar = tp.p if isinstance(tp.p, str) else None
        s_bound = svar is not None and svar in var_names
        o_bound = ovar is not None and ovar in var_names
        p_bound = pvar is not None and pvar in var_names

        R = bindings.shape[0]
        if s_bound or o_bound:
            # ---- equi-join on a bound vertex variable ----------------------
            join_on_s = s_bound
            joinvar = svar if join_on_s else ovar
            tvals = bindings[:, var_names.index(joinvar)]
            if step.use_pred_index:
                # shard-local presorted join: probe the owning shard's
                # cached PredIndex — no scan, no per-join argsort
                idx = store.pred_index(tp.p)
                views = [(idx.s_sorted, idx.s_order) if join_on_s
                         else (idx.o_sorted, idx.o_order)]
                if stats is not None:
                    stats.joins_pred_index += 1
            else:
                parts = CandidateParts.of(candidates(store, tp))
                key_arr = store.s if join_on_s else store.o
                views = []
                for ptids in parts.parts:
                    kv = key_arr[ptids]
                    order_ = np.argsort(kv, kind="stable")
                    views.append((kv[order_], ptids[order_]))
                if stats is not None:
                    stats.joins_vertex += 1
                    stats.merged_joins += len(views) > 1
            checks = []
            if s_bound and o_bound:
                # joined on s above -> o must still agree with its binding
                checks.append((store.o, bindings[:, var_names.index(ovar)]))
            if p_bound:
                checks.append((store.p, bindings[:, var_names.index(pvar)]))
            if stats is not None:
                stats.partitions_probed += len(views)
            row_idx, sel_tid = _probe_partitions(views, tvals, checks,
                                                 max_rows)
        elif p_bound:
            # ---- equi-join on a bound PREDICATE variable -------------------
            # (used to fall through to the cartesian branch and could raise
            # MatchCapacityError on the pre-mask R*C count even when the true
            # result was tiny)
            tvals = bindings[:, var_names.index(pvar)]
            parts = CandidateParts.of(candidates(store, tp))
            views = []
            for ptids in parts.parts:
                kv = store.p[ptids]
                order_ = np.argsort(kv, kind="stable")
                views.append((kv[order_], ptids[order_]))
            if stats is not None:
                stats.joins_pred_var += 1
                stats.partitions_probed += len(views)
                stats.merged_joins += len(views) > 1
            row_idx, sel_tid = _probe_partitions(views, tvals, [], max_rows)
        else:
            # ---- no shared bound variable: cartesian expansion -------------
            # (no equality masks can apply here, so the pre-expansion count
            # IS the surviving count and the capacity check is exact)
            cand = CandidateParts.of(candidates(store, tp)).concat()
            C = len(cand)
            total = R * C
            if total > max_rows:
                raise MatchCapacityError(
                    f"cartesian would produce {total} rows")
            row_idx = np.repeat(np.arange(R), C)
            sel_tid = np.tile(cand, R)
            if stats is not None:
                stats.joins_cartesian += 1
                stats.partitions_probed += 1

        sel_s, sel_p, sel_o = (store.s[sel_tid], store.p[sel_tid],
                               store.o[sel_tid])
        new_bind = bindings[row_idx]

        # ---- append new variable columns -----------------------------------
        add_cols: list[np.ndarray] = []
        for varname, vals, already in (
                (svar, sel_s, s_bound), (ovar, sel_o, o_bound),
                (pvar, sel_p, p_bound)):
            if (varname is not None and not already
                    and varname not in var_names):
                var_names.append(varname)
                add_cols.append(vals)
            # (?x p ?x) with ?x new: candidates pre-filtered to s==o and the
            # column was added on the s pass, so the o pass lands here.
        bindings = (np.concatenate([new_bind] + [c[:, None] for c in add_cols],
                                   axis=1)
                    if add_cols else new_bind)
        # previously matched patterns' edge columns follow the expansion
        for k in list(edge_cols):
            edge_cols[k] = edge_cols[k][row_idx]
        edge_cols[pat_i] = sel_tid

    E = len(q.patterns)
    R = bindings.shape[0]
    edge_ids = np.zeros((R, E), dtype=np.int64)
    for i in range(E):
        edge_ids[:, i] = edge_cols[i]
    return MatchResult(var_names=var_names, bindings=bindings,
                       edge_ids=edge_ids)


# ---------------------------------------------------------------------------
# Oracle: naive backtracking matcher (tests only)
# ---------------------------------------------------------------------------

def match_oracle(store: RDFStore, q: QueryGraph) -> tuple[set[tuple], list[str]]:
    """Exponential-time reference matcher (tests only).

    Returns ``(solutions, var_order)`` where each solution is a tuple of
    bindings in ``var_order``. Compare against ``match_bgp`` as sets after
    reordering columns by variable name."""
    vs = q.variables
    triples = store.triples()

    out: set[tuple] = set()

    def rec(i: int, env: dict[str, int]) -> None:
        if i == len(q.patterns):
            out.add(tuple(env[v] for v in vs))
            return
        tp = q.patterns[i]
        for (s, p, o) in triples:
            def unify(term, val, env):
                if isinstance(term, int):
                    return env if term == val else None
                if term in env:
                    return env if env[term] == val else None
                e2 = dict(env)
                e2[term] = int(val)
                return e2
            e = unify(tp.s, s, env)
            if e is None:
                continue
            e = unify(tp.p, p, e)
            if e is None:
                continue
            e = unify(tp.o, o, e)
            if e is None:
                continue
            rec(i + 1, e)

    rec(0, {})
    return out, vs
