"""Collaborative partial evaluation for cross-edge queries.

The paper executes a query at an edge only when EVERY required BGP leaf's
pattern is resident there; anything else is cloud-only. Partial evaluation
(Peng et al., "Processing SPARQL Queries Over Distributed RDF Graphs")
turns that class collaborative:

1. **Plan** (:func:`plan_partial`): split each required leaf into maximal
   connected sub-BGP *fragments* whose patterns are resident at some edge
   (:func:`repro_torch.core.pattern.leaf_residency` reports the per-leaf
   residency matrix). Non-resident fragments stay at the cloud as
   residuals. Contributing edges are picked least-loaded-first.
2. **Execute** (:func:`execute_partial_batch`): every contributing edge
   runs its fragments as ONE engine batch against its resident subgraph
   G[P]; the cloud runs the residual fragments plus any OPTIONAL leaves.
   Each edge ships a **dictionary-free binding table** — the raw
   ``[R, V]`` int64 array plus variable names, exactly the buffers the
   fork-pool IPC path already moves — whose size is the plan's egress
   (``shipped_bits``).
3. **Assemble**: fragment tables of one leaf combine with the composite-key
   ``searchsorted`` compatibility join (:func:`repro_torch.sparql.algebra.
   _join_tables`); assembled leaves feed the ordinary algebra evaluator.

**Correctness.** An edge's store is the *induced subgraph* of the cloud
store over its resident patterns, so a fragment isomorphic to a resident
pattern finds exactly the cloud's match set (the paper's completeness
guarantee) — over the SAME global dictionary ids. And for a BGP split into
fragments T₁ ∪ T₂, the match multiset of the whole equals the compatibility
join of the fragments' match multisets on their shared variables (matches
are homomorphisms; stores are deduplicated so no multiplicities appear).
Assembly therefore reproduces the cloud-only result as a multiset; plans
whose results are row-ORDER-sensitive (LIMIT / OFFSET) are never planned
partially (:func:`plan_partial` returns None).

**Staleness.** A plan records each contributing edge's store version at
planning time; :func:`execute_partial_batch` re-verifies the versions and
transparently falls back to whole-query cloud execution when a rebalance
moved any edge in between — a stale partial table is never assembled.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.pattern import leaf_residency, pattern_of
from .algebra import (OrderSliceNode, SolutionTable, _eval, _join_tables,
                      execute_any_batch, is_algebra_plan)
from .matcher import MatchResult
from .query import QueryGraph

CLOUD = -1


@dataclass
class Fragment:
    """A connected sub-BGP of one required leaf, pinned to one server.

    ``leaf_pos`` indexes the plan's full ``bgp_leaves()`` list (or -1 when
    the query is a plain :class:`QueryGraph`). ``server_id`` is the
    contributing edge, or :data:`CLOUD` for a residual no edge holds.
    """

    query: QueryGraph
    leaf_pos: int
    server_id: int


@dataclass
class PartialPlan:
    """An executable partial-evaluation plan for one query."""

    query: object                      # plain QueryGraph or algebra plan
    fragments: list[Fragment]
    store_versions: dict[int, object] = field(default_factory=dict)

    @property
    def edge_set(self) -> list[int]:
        """Sorted contributing edge server ids."""
        return sorted({f.server_id for f in self.fragments
                       if f.server_id >= 0})

    def describe(self) -> list[str]:
        """Human-readable per-server leaf split (endpoint ``explain``)."""
        out = []
        for f in self.fragments:
            where = "cloud" if f.server_id < 0 else f"ES{f.server_id}"
            leaf = "query" if f.leaf_pos < 0 else f"leaf {f.leaf_pos}"
            pats = " . ".join(
                f"{tp.s} {tp.p} {tp.o}" for tp in f.query.patterns)
            out.append(f"{leaf} [{pats}] @ {where}")
        return out


@dataclass
class PartialExecution:
    """Outcome of one partial plan: assembled result + honest accounting."""

    result: object                     # MatchResult | SolutionTable
    servers: tuple[int, ...]           # edges that actually contributed
    shipped_bits: float                # binding-table egress, bits
    per_server_rows: dict[int, int]
    per_server_seconds: dict[int, float]
    fallback: bool = False             # stale placement -> ran at cloud
    per_server_bits: dict[int, float] = field(default_factory=dict)
    # per-phase engine wall (prescan + join seconds) per server — the
    # realized-latency input (repro_torch.core.cost.measured_cycles): raw wall
    # above includes coordinator Python overhead that would misprice the
    # cloud assembly as from-scratch evaluation
    per_server_engine_seconds: dict[int, float] = field(
        default_factory=dict)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


def _order_sensitive(root) -> bool:
    """True when the plan's result depends on row order (LIMIT/OFFSET):
    assembly reproduces the cloud result as a *multiset*, which is exactly
    what every other operator (incl. DISTINCT and bare ORDER BY) consumes."""
    stack = [root]
    while stack:
        n = stack.pop()
        if isinstance(n, OrderSliceNode) and (n.limit is not None
                                              or n.offset > 0):
            return True
        stack.extend(n.children())
    return False


def _sub_query(lq: QueryGraph, idxs: list[int]) -> QueryGraph:
    return QueryGraph(patterns=[lq.patterns[i] for i in idxs], projection=[])


def _resident_cols(sub: QueryGraph, servers: list) -> list[int]:
    p = pattern_of(sub)
    return [j for j, es in enumerate(servers)
            if es.store is not None and es.can_execute(p)]


def _split_leaf(lq: QueryGraph, servers: list,
                ) -> list[tuple[tuple[int, ...], list[int]]]:
    """Cover ``lq``'s patterns with maximal connected sub-BGPs, each with
    the server columns where its pattern is resident (empty -> residual).

    Greedy grow: seed with the lowest unplaced pattern, then repeatedly
    absorb vertex-adjacent patterns while the combined pattern stays
    resident somewhere. Deterministic for a fixed placement.
    """
    n = len(lq.patterns)
    cols = _resident_cols(lq, servers)
    if cols:
        return [(tuple(range(n)), cols)]
    verts = [{lq.patterns[i].s, lq.patterns[i].o} for i in range(n)]
    out: list[tuple[tuple[int, ...], list[int]]] = []
    remaining = list(range(n))
    while remaining:
        i = remaining.pop(0)
        frag = [i]
        cur = _resident_cols(_sub_query(lq, frag), servers)
        if cur:
            grown = True
            while grown and remaining:
                grown = False
                for j in list(remaining):
                    if not any(verts[j] & verts[k] for k in frag):
                        continue
                    cand = _resident_cols(_sub_query(lq, frag + [j]), servers)
                    if cand:
                        frag.append(j)
                        remaining.remove(j)
                        cur = cand
                        grown = True
        out.append((tuple(frag), cur))
    return out


def plan_partial(q, edge_servers: list) -> PartialPlan | None:
    """Build a partial-evaluation plan for ``q``, or None when partial
    execution is not certifiable (no contributing edge, order-sensitive
    slice, uncertifiable leaves)."""
    if is_algebra_plan(q) and _order_sensitive(q):
        return None
    servers = list(edge_servers)
    res = leaf_residency(q, servers)
    if res is None:
        return None
    fragments: list[Fragment] = []
    load: dict[int, int] = {}
    any_edge = False
    for lq, pos in zip(res.leaves, res.leaf_idx):
        for idxs, cols in _split_leaf(lq, servers):
            if cols:
                sid = min((s.server_id for j, s in enumerate(servers)
                           if j in cols),
                          key=lambda s: (load.get(s, 0), s))
                load[sid] = load.get(sid, 0) + 1
                any_edge = True
            else:
                sid = CLOUD
            fragments.append(Fragment(query=_sub_query(lq, list(idxs)),
                                      leaf_pos=pos, server_id=sid))
    if not any_edge:
        return None
    by_id = {es.server_id: es for es in servers}
    versions = {sid: by_id[sid].store.version
                for sid in {f.server_id for f in fragments if f.server_id >= 0}}
    return PartialPlan(query=q, fragments=fragments, store_versions=versions)


# ---------------------------------------------------------------------------
# execution + assembly
# ---------------------------------------------------------------------------


def _table_bits(res) -> float:
    """Dictionary-free wire size of a shipped binding table: R x V int64
    cells (variable-name header amortized away, matching ``result_bits``)."""
    r = int(res.bindings.shape[0])
    v = max(1, int(res.bindings.shape[1]))
    return float(r * v * 64)


def _as_table(res, pred_vars: frozenset, d) -> SolutionTable:
    if isinstance(res, SolutionTable):
        return res
    t = SolutionTable(list(res.var_names), res.bindings, pred_vars)
    t.dictionary = d
    return t


def _assemble_leaf(tables: list, pred_vars: frozenset, d, cap: int):
    """Compatibility-join a leaf's fragment tables (composite-key
    searchsorted equi-join). A single whole-leaf table passes through
    untouched so the one-fragment case is byte-identical to local
    evaluation."""
    if len(tables) == 1:
        return tables[0]
    acc = _as_table(tables[0], pred_vars, d)
    for t in tables[1:]:
        acc = _join_tables(acc, _as_table(t, pred_vars, d), "inner", cap)
    return acc


def execute_partial_batch(plans: list[PartialPlan], cloud_store, engine,
                          edges_by_id: dict[int, object],
                          max_rows: int | None = None,
                          ) -> list[PartialExecution]:
    """Execute a batch of partial plans with per-server fragment batching.

    All fragments bound for one edge run as ONE ``engine.execute_batch``
    against that edge's store (scan dedup / result-cache sharing apply
    per server); residual fragments and OPTIONAL leaves batch against the
    cloud store. Stale plans (an edge's store version moved since
    planning) fall back to whole-query cloud execution, marked
    ``fallback=True`` — results are always current.
    """
    cap = int(max_rows if max_rows is not None
              else getattr(engine, "max_rows", 5_000_000))
    stale = [False] * len(plans)
    for i, plan in enumerate(plans):
        for sid, ver in plan.store_versions.items():
            es = edges_by_id.get(sid)
            if es is None or es.store is None or es.store.version != ver:
                stale[i] = True
                break

    # ---- gather per-server jobs: (plan idx, slot key, query) -------------
    jobs: dict[int, list[tuple[int, tuple, QueryGraph]]] = {}
    for i, plan in enumerate(plans):
        if stale[i]:
            continue
        for fi, frag in enumerate(plan.fragments):
            jobs.setdefault(frag.server_id, []).append(
                (i, ("frag", fi), frag.query))
        if is_algebra_plan(plan.query):
            covered = {f.leaf_pos for f in plan.fragments}
            for pos, leaf in enumerate(plan.query.bgp_leaves()):
                if pos not in covered and leaf.patterns:
                    jobs.setdefault(CLOUD, []).append(
                        (i, ("leaf", pos), leaf.query))

    # ---- execute: one engine batch per server ----------------------------
    results: dict[tuple[int, tuple], object] = {}
    per_rows: dict[int, dict[int, int]] = {i: {} for i in range(len(plans))}
    per_secs: dict[int, dict[int, float]] = {i: {} for i in range(len(plans))}
    shipped: dict[int, float] = {i: 0.0 for i in range(len(plans))}
    per_bits: dict[int, dict[int, float]] = {i: {} for i in range(len(plans))}
    per_eng: dict[int, dict[int, float]] = {i: {} for i in range(len(plans))}
    stats = engine.stats
    for sid, batch in sorted(jobs.items()):
        store = cloud_store if sid == CLOUD else edges_by_id[sid].store
        e0 = stats.prescan_seconds + stats.join_seconds
        t0 = time.perf_counter()
        outs = engine.execute_batch(store, [q for (_, _, q) in batch])
        dt = time.perf_counter() - t0
        # per-phase engine wall, clamped to batch wall (the phase
        # accumulators are shared across overlapped threads); the 1ns
        # floor marks "measured (essentially free)" as distinct from
        # "not measured" for measured_cycles' fallback
        deng = max(min(stats.prescan_seconds + stats.join_seconds - e0,
                       dt), 1e-9)
        per_plan = {}
        for (i, slot, _), res in zip(batch, outs):
            results[(i, slot)] = res
            per_plan.setdefault(i, 0)
            per_plan[i] += res.num_matches
            if sid != CLOUD and slot[0] == "frag":
                b = _table_bits(res)
                shipped[i] += b
                per_bits[i][sid] = per_bits[i].get(sid, 0.0) + b
        for i, nrows in per_plan.items():
            per_rows[i][sid] = per_rows[i].get(sid, 0) + nrows
            # wall apportioned evenly across the batch's plans, matching
            # the servers' batched accounting convention
            per_secs[i][sid] = (per_secs[i].get(sid, 0.0)
                                + dt / max(1, len(per_plan)))
            per_eng[i][sid] = (per_eng[i].get(sid, 0.0)
                               + deng / max(1, len(per_plan)))

    # ---- fallback: whole-query cloud execution ---------------------------
    fb_idx = [i for i in range(len(plans)) if stale[i]]
    fb_res = (execute_any_batch(cloud_store, engine,
                                [plans[i].query for i in fb_idx], cap)
              if fb_idx else [])

    # ---- assemble --------------------------------------------------------
    out: list[PartialExecution] = []
    fb_iter = iter(fb_res)
    for i, plan in enumerate(plans):
        if stale[i]:
            out.append(PartialExecution(
                result=next(fb_iter), servers=(), shipped_bits=0.0,
                per_server_rows={}, per_server_seconds={}, fallback=True))
            continue
        root = plan.query
        d = getattr(root, "dictionary", None)
        pred_vars = getattr(root, "pred_vars", frozenset())
        by_leaf: dict[int, list] = {}
        for fi, frag in enumerate(plan.fragments):
            by_leaf.setdefault(frag.leaf_pos, []).append(
                results[(i, ("frag", fi))])
        a0 = stats.prescan_seconds + stats.join_seconds
        t_asm = time.perf_counter()
        if is_algebra_plan(root):
            leaves = root.bgp_leaves()
            leaf_results = {}
            for pos, tables in by_leaf.items():
                leaf_results[id(leaves[pos])] = _assemble_leaf(
                    tables, pred_vars, d, cap)
            for pos, leaf in enumerate(leaves):
                if pos not in by_leaf and leaf.patterns:
                    leaf_results[id(leaf)] = results[(i, ("leaf", pos))]
            final = _eval(root, leaf_results, engine, d, pred_vars, cap)
        else:
            t = _assemble_leaf(by_leaf[-1], pred_vars, d, cap)
            bindings = np.ascontiguousarray(t.bindings)
            final = MatchResult(
                var_names=list(t.var_names), bindings=bindings,
                edge_ids=np.zeros((bindings.shape[0], 0), dtype=np.int64))
        # assembly runs at the cloud: charge its wall there, so per-server
        # walls honestly cover everything the coordinator did for this plan
        asm_wall = time.perf_counter() - t_asm
        per_secs[i][CLOUD] = per_secs[i].get(CLOUD, 0.0) + asm_wall
        per_eng[i][CLOUD] = (per_eng[i].get(CLOUD, 0.0) + max(
            min(stats.prescan_seconds + stats.join_seconds - a0,
                asm_wall), 1e-9))
        used = tuple(sorted(k for k in per_rows[i] if k >= 0))
        out.append(PartialExecution(
            result=final, servers=used, shipped_bits=shipped[i],
            per_server_rows=per_rows[i], per_server_seconds=per_secs[i],
            per_server_bits=per_bits[i],
            per_server_engine_seconds=per_eng[i]))
    return out
