"""Device-resident BGP execution: scans, compaction and presorted joins on
the card, with ONE device->host transfer per engine batch.

The host join pipeline (:mod:`repro_torch.sparql.matcher`) interleaves
device scans with host control flow. This module keeps the whole pipeline
of a *device-eligible* query on the device the backend stages to:

1. **Seed scan** through the ``triple_scan`` kernel (or the fused
   ``scan_probe`` when the next step probes a seed column — the
   bound-predicate star shape), compacted with ``torch.nonzero``.
2. **Presorted joins** through the ``probe_sorted`` kernel over staged
   shard-local ``pred_index`` views, expanded to binding rows with
   ``cumsum`` / ``repeat_interleave`` / gathers — the device analogue of
   ``matcher._probe_partitions``.
3. **One bulk fetch**: every queued query's binding and edge columns leave
   the device in a single packed copy at the end of the batch (counted in
   ``EngineStats.host_transfers``).

**Eligibility** (:func:`device_eligible`) — everything else falls back to
the host path transparently: the seed pattern must touch a single flat
store (bound predicate on a sharded store, or any pattern on a monolithic
one) and no pattern may repeat a variable; every subsequent plan step must
be ``JoinStep.device_probe`` (a shard-local presorted join with no
equality masks).

**Transfer accounting.** Host control flow still needs O(1) scalars off
the device (a matched-row count to size the compaction, a fan-out total to
size each expansion). These are counted in ``scalar_syncs``;
``host_transfers`` counts bulk array copies only. Every fetched column is
int32, so byte counts equal the JAX package's event for event.

Capacity semantics match the host exactly: a device join's fan-out has no
equality masks, so its raw expansion IS the surviving row count and
:class:`~repro_torch.sparql.matcher.MatchCapacityError` is raised at the
same ``max_rows`` threshold the host would hit.
"""

from __future__ import annotations

import numpy as np
import torch

from .matcher import JoinStep, JoinStats, MatchCapacityError, MatchResult
from .query import QueryGraph, TriplePattern


def _repeats_var(tp: TriplePattern) -> bool:
    vs = [t for t in (tp.s, tp.p, tp.o) if isinstance(t, str)]
    return len(vs) != len(set(vs))


def device_eligible(store, q: QueryGraph, plan: list[JoinStep]) -> bool:
    """Can ``q`` run fully device-resident under ``plan`` on ``store``?

    See the module docstring for the covered query class. The decision is
    per *canonical* query, so alpha-equivalent queries share it.
    """
    if not q.patterns or store.num_triples == 0:
        return False
    if max(store.num_entities, store.num_predicates) >= 2 ** 31:
        return False                      # ids exceed int32 kernel range
    if any(_repeats_var(tp) for tp in q.patterns):
        return False                      # device path has no repeat filters
    tp0 = q.patterns[plan[0].pattern]
    if getattr(store, "shards", None) is not None \
            and not isinstance(tp0.p, int):
        return False                      # wildcard seed fans out over shards
    return all(st.device_probe for st in plan[1:])


class DeviceBatch:
    """Accumulates device-eligible queries of one engine batch and executes
    them with a single bulk device->host transfer.

    Usage: ``add()`` each (canonical-key, canonical-query, plan) triple,
    then ``run()`` once — returns ``{ck: MatchResult}`` with canonical
    variable names, ready for the engine's result cache.
    """

    def __init__(self, backend, store) -> None:
        self._be = backend
        self._store = store
        self._jobs: list[tuple[tuple, QueryGraph, list[JoinStep]]] = []

    def add(self, ck: tuple, q: QueryGraph, plan: list[JoinStep]) -> None:
        self._jobs.append((ck, q, plan))

    def run(self, max_rows: int,
            stats: JoinStats | None = None) -> dict[tuple, MatchResult]:
        if not self._jobs:
            return {}
        pend = [(ck, len(q.patterns),
                 self._exec(q, plan, max_rows, stats))
                for ck, q, plan in self._jobs]
        # the ONE bulk transfer: every job's binding + edge columns at once
        fetched = self._be._fetch([(cols, {k: e for k, (e, _) in edges.items()})
                                   for _, _, (cols, edges) in pend])
        out: dict[tuple, MatchResult] = {}
        for (ck, E, (_, edges)), (h_cols, h_edges) in zip(pend, fetched):
            R = len(next(iter(h_edges.values())))
            if h_cols:
                bindings = np.stack(
                    [np.asarray(c, dtype=np.int64) for c in h_cols.values()],
                    axis=1)
            else:
                bindings = np.zeros((R, 0), dtype=np.int64)
            edge_ids = np.zeros((R, E), dtype=np.int64)
            for k in range(E):
                # re-lift shard-local tids by the owning shard's offset
                edge_ids[:, k] = (np.asarray(h_edges[k], dtype=np.int64)
                                  + edges[k][1])
            out[ck] = MatchResult(var_names=list(h_cols),
                                  bindings=bindings, edge_ids=edge_ids)
        return out

    # -- per-query device pipeline -------------------------------------------
    def _exec(self, q: QueryGraph, plan: list[JoinStep], max_rows: int,
              stats: JoinStats | None):
        """Build one query's device-resident column set (nothing fetched).

        Returns ``(cols, edges)``: ``cols`` maps variable name -> device
        int32 value column (host append order: s, o, p per step);
        ``edges`` maps pattern index -> (device shard-LOCAL int32 tid
        column, global-id offset). Gathers index with int64 tensors.
        """
        from ..kernels.join_probe import probe_sorted, scan_probe
        from ..kernels.triple_scan import triple_scan

        be, store = self._be, self._store
        slots = be._store_slots(store)
        empty = torch.zeros(0, dtype=torch.int32, device=be.device)
        cols: dict[str, torch.Tensor] = {}
        edges: dict[int, tuple[torch.Tensor, int]] = {}

        # ---- seed: scan + on-device compaction -----------------------------
        tp0 = q.patterns[plan[0].pattern]
        svar0 = tp0.s if isinstance(tp0.s, str) else None
        pvar0 = tp0.p if isinstance(tp0.p, str) else None
        ovar0 = tp0.o if isinstance(tp0.o, str) else None
        if stats is not None:            # parity with the host seed expansion
            stats.joins_cartesian += 1
            stats.partitions_probed += 1
        parts = be._scan_parts(store, tp0)
        fused = None
        if not parts or parts[0][0].num_triples == 0:
            R, off0 = 0, (parts[0][1] if parts else 0)
            rows = empty
        else:
            flat0, off0 = parts[0]
            arr0 = be._triples(flat0, min_slots=slots)
            pat = be._pattern_vec(tp0).tolist()
            fuse_col = self._fuse_col(q, plan, tp0)
            if fuse_col is not None:
                col, keys = fuse_col
                mask, lo_all, hi_all = scan_probe(arr0, pat, keys, col)
            else:
                mask = triple_scan(arr0, pat)
            R = be._scalar(mask.sum())
            if R:
                rows = torch.nonzero(mask).squeeze(1)
                if fuse_col is not None:
                    fused = (lo_all[rows], hi_all[rows])
            else:
                rows = empty
        for varname, c in ((svar0, 0), (ovar0, 2), (pvar0, 1)):
            if varname is not None:
                cols[varname] = (arr0[rows, c] if R else empty)
        edges[plan[0].pattern] = (rows.to(torch.int32), off0)

        # ---- presorted probe joins -----------------------------------------
        for si, step in enumerate(plan[1:], start=1):
            tp = q.patterns[step.pattern]
            svar = tp.s if isinstance(tp.s, str) else None
            ovar = tp.o if isinstance(tp.o, str) else None
            join_on_s = svar in cols
            newvar = ovar if join_on_s else svar
            views, offk, flatk = be._pred_views(store, tp.p)
            keys, stids = ((views[0], views[1]) if join_on_s
                           else (views[2], views[3]))
            if stats is not None:
                stats.joins_pred_index += 1   # same plan step as the host
                stats.joins_device += 1       # ... but executed on device
                stats.partitions_probed += 1
            if R == 0:
                cols[newvar] = empty
                edges[step.pattern] = (empty, offk)
                continue
            if si == 1 and fused is not None:
                lo, hi = fused
            else:
                lo, hi = probe_sorted(keys, cols[svar if join_on_s else ovar])
            counts = (hi - lo).to(torch.int64)
            cum = torch.cumsum(counts, 0)
            total = be._scalar(cum[-1])
            if total > max_rows:
                raise MatchCapacityError(
                    f"join would keep more than {max_rows} rows")
            if total == 0:
                R = 0
                for v in cols:
                    cols[v] = empty
                for k in edges:
                    edges[k] = (empty, edges[k][1])
                cols[newvar] = empty
                edges[step.pattern] = (empty, offk)
                continue
            # expansion of the [lo, hi) runs: cumsum / repeat_interleave /
            # gather, sized by the synced total so nothing else syncs
            row_idx = torch.repeat_interleave(counts, output_size=total)
            starts = torch.repeat_interleave(lo.to(torch.int64), counts,
                                             output_size=total)
            within = (torch.arange(total, device=be.device)
                      - torch.repeat_interleave(cum - counts, counts,
                                                output_size=total))
            sel_local = stids[starts + within]
            arrk = be._triples(flatk, min_slots=slots)
            for v in cols:
                cols[v] = cols[v][row_idx]
            for k in edges:
                edges[k] = (edges[k][0][row_idx], edges[k][1])
            cols[newvar] = arrk[sel_local.to(torch.int64),
                                2 if join_on_s else 0]
            edges[step.pattern] = (sel_local, offk)
            R = total
        return cols, edges

    def _fuse_col(self, q: QueryGraph, plan: list[JoinStep],
                  tp0: TriplePattern):
        """(triple column, device sorted keys) when step 1 probes a seed
        triple column directly — the ``scan_probe`` fusion window — else
        None (seed bound a predicate variable the join uses, or the query
        is a single pattern)."""
        if len(plan) < 2:
            return None
        tp1 = q.patterns[plan[1].pattern]
        svar1 = tp1.s if isinstance(tp1.s, str) else None
        join_on_s = svar1 is not None and svar1 in tp0.variables()
        joinvar = svar1 if join_on_s else tp1.o
        col = 0 if joinvar == tp0.s else 2 if joinvar == tp0.o else None
        if col is None:                    # join var came from seed's p
            return None
        views, _off, _flat = self._be._pred_views(self._store, tp1.p)
        return col, (views[0] if join_on_s else views[2])
