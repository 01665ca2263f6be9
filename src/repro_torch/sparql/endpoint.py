"""`SparqlEndpoint` — the one-object public query API.

>>> ep = SparqlEndpoint(store, dictionary)          # torch engine on cuda
>>> ep.query('SELECT ?x WHERE { ?x <likes> ?p . FILTER (?p != "P0") }')
>>> ep.ask('ASK { ?x <subgenreOf> ?y }')
>>> print(ep.explain(text))                         # plan + cache provenance
>>> ep.query_many(texts)                            # one engine batch
>>> ep.update('INSERT DATA { <u> <likes> <p> }')    # the write path

Everything funnels through :mod:`repro_torch.sparql.algebra`: queries
compile to operator trees whose BGP leaves run on the shard-parallel
batched engine, so the scan/plan/result LRUs, backend registry (``numpy`` /
``torch``), and sharded stores all apply unchanged. Compiled plans are
memoized per query text (`plan_cache_size`), making repeated text queries
parse-free.

The endpoint runs the ``torch`` backend on ``cuda`` unless the caller
passes ``device="cpu"`` or ``backend="numpy"``.

Construction from the edge-cloud stack:

- :meth:`from_system` (or ``system=``) shares an
  :class:`~repro_torch.edge.system.EdgeCloudSystem`'s cloud store,
  dictionary and engine; :meth:`run_round` then parses per-user query texts
  and delegates to ``system.run_round_batched`` — algebra queries are
  B&B-scheduled onto edges via per-leaf pattern feasibility
  (:func:`repro_torch.core.pattern.feasibility_patterns`) exactly like
  BGPs, and :meth:`explain` appends the scheduler's dry run.
- :meth:`update` / :meth:`update_many` are the write path (SPARQL UPDATE):
  through ``system.apply_update`` / ``apply_delta`` when a system is
  attached, straight onto the store otherwise.

The serving pool's ``admit_many`` is not part of this package yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..rdf.dictionary import Dictionary
from ..rdf.graph import RDFStore
from .algebra import (AskNode, Node, SolutionTable, compile_query,
                      evaluate_many, explain_plan)
from .engine import EngineStats, QueryEngine, TorchBackend
from .query import ParseError, parse_query


class SparqlEndpoint:
    """Unified SELECT/ASK endpoint over any :class:`RDFStore`.

    ``engine`` (or ``backend`` and ``device``) selects the execution
    engine; one endpoint may share an engine with other endpoints or with a
    running system (caches are version-keyed and lock-guarded). ``system``
    attaches the cloud-edge scheduler and its write path.
    """

    def __init__(self, store: RDFStore | None = None,
                 dictionary: Dictionary | None = None, *,
                 engine: QueryEngine | None = None,
                 backend: str = "torch",
                 device: str | torch.device | None = None,
                 system=None,
                 plan_cache_size: int = 256,
                 result_cache_size: int = 256,
                 result_cache_bytes: int = 256 * 1024 * 1024) -> None:
        if system is not None:
            store = store if store is not None else system.cloud.store
            dictionary = (dictionary if dictionary is not None
                          else system.dictionary)
            engine = engine if engine is not None else system.engine
        if store is None or dictionary is None:
            raise ValueError("SparqlEndpoint needs a store and a dictionary "
                             "(or system=...)")
        self.store = store
        self.dictionary = dictionary
        self.system = system
        if engine is None:
            engine = QueryEngine(backend=(TorchBackend(device=device)
                                          if backend == "torch" else backend))
        self.engine = engine
        # plan memo keyed (text, dictionary.version): compiled plans bake
        # dictionary ids in (triple constants, FILTER-operand ent_id /
        # pred_id), so a plan compiled before the dictionary grew may hold
        # stale/missing ids — growth invalidates
        self._plans: OrderedDict[tuple, Node] = OrderedDict()
        self._plan_cache_size = int(plan_cache_size)
        # guards the plan memo, the result memo, and the memo counters: one
        # endpoint may be driven from many threads
        self._memo_lock = threading.Lock()
        # full-result memo provenance (engine cache counters don't see memo
        # hits — a memo hit never reaches the engine)
        self.memo_hits = 0
        self.memo_misses = 0
        # full-query result LRU keyed (text, store.version): a hot repeated
        # query skips operator re-evaluation entirely, and the version key
        # makes entries self-invalidating when the store changes (size 0
        # disables). Count- AND byte-bounded like the engine's LRUs. Cached
        # tables are shared — treat as read-only.
        self._results: OrderedDict[tuple, SolutionTable] = OrderedDict()
        self._result_cache_size = int(result_cache_size)
        self._result_cache_bytes = int(result_cache_bytes)
        self._result_bytes = 0
        # store commits performed by the write path (one per applied
        # delta): a coalesced window of updates counts one
        self.write_commits = 0

    # -- parsing / planning --------------------------------------------------
    def parse(self, text: str) -> Node:
        """Compile ``text`` to an operator tree, memoized per
        ``(text, dictionary.version)``."""
        key = (text, self.dictionary.version)
        with self._memo_lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                return plan
        plan = compile_query(parse_query(text, self.dictionary),
                             self.dictionary)
        with self._memo_lock:
            self._plans[key] = plan
            while len(self._plans) > self._plan_cache_size:
                self._plans.popitem(last=False)
        return plan

    def explain(self, text: str, user: int = 0) -> str:
        """Operator tree + per-BGP-leaf cache-hit provenance and estimated
        cardinalities against this endpoint's store/engine state.

        With an :class:`~repro_torch.edge.system.EdgeCloudSystem` attached,
        a scheduler dry-run for ``user`` is appended: the chosen assignment
        kind (edge / cloud / partial) and, for a partial plan, the
        per-server leaf split."""
        plan = self.parse(text)
        out = explain_plan(plan, self.store, self.engine)
        if self.system is not None:
            out += "\n" + self.system.explain_assignment(plan, user=user)
        return out

    # -- execution -----------------------------------------------------------
    def _run(self, texts: list[str]) -> list[SolutionTable]:
        """Evaluate query texts with full-result memoization: misses (and
        in-batch duplicates, once) evaluate as ONE batch, hits return the
        cached table for the CURRENT store version.

        The store version is snapshotted at dispatch and re-validated after
        evaluation: if it moved mid-batch, the freshly computed tables are
        returned but NOT cached.
        """
        v = self.store.version
        found: dict[str, SolutionTable] = {}
        todo: dict[str, Node] = {}
        for t in texts:
            if t in found or t in todo:
                continue
            with self._memo_lock:
                hit = self._results.get((t, v))
                if hit is not None:
                    self._results.move_to_end((t, v))
                    self.memo_hits += 1
            if hit is not None:
                found[t] = hit
            else:
                with self._memo_lock:
                    self.memo_misses += 1
                todo[t] = self.parse(t)
        if todo:
            tables = evaluate_many(list(todo.values()), self.store,
                                   self.engine)
            # answer from the local snapshot — the LRU trim below may evict
            # entries belonging to a batch wider than the cache
            found.update(zip(todo, tables))
            if self._result_cache_size > 0 and self.store.version == v:
                with self._memo_lock:
                    for t, tbl in zip(todo, tables):
                        nbytes = int(tbl.bindings.nbytes)
                        if nbytes > self._result_cache_bytes:
                            continue   # would evict everything; skip
                        displaced = self._results.pop((t, v), None)
                        if displaced is not None:
                            self._result_bytes -= int(
                                displaced.bindings.nbytes)
                        self._results[(t, v)] = tbl
                        self._result_bytes += nbytes
                    while (len(self._results) > self._result_cache_size
                           or self._result_bytes > self._result_cache_bytes):
                        _, old = self._results.popitem(last=False)
                        self._result_bytes -= int(old.bindings.nbytes)
        return [found[t] for t in texts]

    def clear_cache(self) -> None:
        """Cold-start: drop the endpoint's result memo AND the engine's
        scan/plan/result LRUs (compiled plans survive — they are
        store-independent)."""
        with self._memo_lock:
            self._results.clear()
            self._result_bytes = 0
        self.engine.clear_cache()

    def query(self, text: str) -> SolutionTable:
        """Run a SELECT query; returns a decoded-access solution table."""
        if isinstance(self.parse(text), AskNode):
            raise ParseError("ASK query — use SparqlEndpoint.ask")
        return self._run([text])[0]

    def query_many(self, texts: list[str]) -> list[SolutionTable]:
        """Run many SELECT/ASK queries as ONE engine batch: every BGP leaf
        of every query prescans/dedups together and alpha-equivalent
        sub-BGPs share result-cache entries; repeated texts hit the
        endpoint's full-result memo."""
        return self._run(texts)

    def ask(self, text: str) -> bool:
        """Run an ASK query (a SELECT is accepted too: non-empty result)."""
        return self._run([text])[0].num_matches > 0

    # -- the write path ------------------------------------------------------
    def update(self, text: str) -> dict:
        """Execute a SPARQL UPDATE (``INSERT DATA`` / ``DELETE DATA`` /
        ``DELETE WHERE``) and return an ack dict.

        With an :class:`~repro_torch.edge.system.EdgeCloudSystem` attached, the
        write goes through ``system.apply_update`` — the single ingest path
        (placement lock, id-stable shard routing, induced-memo
        carry-forward, version-consistent edge propagation). A standalone
        endpoint applies the delta directly to its store. Either way the
        store version moves, so this endpoint's result memo
        self-invalidates (version-keyed); new INSERT DATA terms bump the
        dictionary version, invalidating the plan memo the same way.
        """
        from .query import parse_update
        from .update import compile_update
        parsed = parse_update(text, self.dictionary)
        if self.system is not None:
            rep = self.system.apply_update(parsed)
            self.write_commits += 1
            return {
                "kind": rep.kind, "inserted": rep.n_add,
                "deleted": rep.n_evict, "new_terms": rep.new_terms,
                "dropped_rows": rep.dropped_rows,
                "edges_updated": rep.edges_updated,
                "shipped_bytes": rep.shipped_bytes,
                "placement_epoch": rep.placement_epoch,
            }
        return self._apply_standalone(compile_update(parsed,
                                                     self.dictionary))

    def _apply_standalone(self, cu) -> dict:
        """Apply one compiled update directly to the endpoint's store (no
        system attached)."""
        from ..rdf.deltas import TripleDelta
        from .update import ground_delta, where_evict_rows
        if cu.where is not None:
            delta = TripleDelta(base_version=self.store.version,
                                evict=where_evict_rows(cu, self.store))
        else:
            delta = ground_delta(cu, self.store)
        if not delta.is_noop:
            self.store.apply_delta(delta)
        self.write_commits += 1
        return {"kind": cu.kind, "inserted": delta.n_add,
                "deleted": delta.n_evict, "new_terms": cu.new_terms,
                "dropped_rows": cu.dropped_rows, "edges_updated": 0,
                "shipped_bytes": 0, "placement_epoch": 0}

    def update_many(self, texts: list[str]) -> list:
        """Execute a window of updates in arrival order, **coalescing**
        consecutive ground updates (``INSERT DATA`` / ``DELETE DATA``) into
        ONE store commit (the write-batching path).

        Returns one entry per text, position-aligned: an ack dict (as
        :meth:`update` returns, plus ``"coalesced"`` — the commit group
        size) or the exception that text failed with. Semantics:

        - **arrival order**: each ground run folds into net add/evict row
          sets with sequential override (a later delete of an inserted row
          cancels it); per-text ``inserted`` / ``deleted`` counts are
          computed against the *effective* store content at that text's
          position, so acks match what sequential application would report.
        - ``DELETE WHERE`` cannot be folded (its evict set depends on the
          live store), so it flushes the pending group first and runs
          individually at its position.
        - **failure isolation**: a text that fails to parse/compile rejects
          only itself; the rest of the window still commits. A failing
          *commit* rejects every text of its group (their effects are one
          delta — none applied).

        The one-commit guarantee is what amortizes remap/propagation: with
        a system attached the whole group is one ``system.apply_delta``
        (one placement-lock round, one induced-memo carry-forward, one
        version-consistent edge propagation) instead of one per text.
        """
        from ..rdf.deltas import member_rows, setdiff_rows, union_rows
        from .query import parse_update
        from .update import compile_update
        results: list = [None] * len(texts)
        group: list[tuple[int, object]] = []   # (text idx, CompiledUpdate)

        def flush() -> None:
            if not group:
                return
            idxs = [i for i, _ in group]
            cus = [cu for _, cu in group]
            group.clear()
            # fold the run into net row sets, acking each update against
            # the effective content at its position
            cur = self.store.triples()
            net_add = np.zeros((0, 3), dtype=np.int64)
            net_evict = np.zeros((0, 3), dtype=np.int64)
            acks = []
            for cu in cus:
                ev = cu.evict
                hit = ((member_rows(ev, cur) & ~member_rows(ev, net_evict))
                       | member_rows(ev, net_add))
                deleted = int(hit.sum())
                if len(ev):
                    net_add = setdiff_rows(net_add, ev)
                    net_evict = union_rows(net_evict, ev)
                ad = cu.add
                have = ((member_rows(ad, cur) & ~member_rows(ad, net_evict))
                        | member_rows(ad, net_add))
                inserted = int(len(ad) - have.sum())
                if len(ad):
                    net_evict = setdiff_rows(net_evict, ad)
                    net_add = union_rows(net_add, ad)
                acks.append({"kind": cu.kind, "inserted": inserted,
                             "deleted": deleted, "new_terms": cu.new_terms,
                             "dropped_rows": cu.dropped_rows,
                             "coalesced": len(cus)})
            try:
                if self.system is not None:
                    rep = self.system.apply_delta(add=net_add,
                                                  evict=net_evict)
                    extra = {"edges_updated": rep.edges_updated,
                             "shipped_bytes": rep.shipped_bytes,
                             "placement_epoch": rep.placement_epoch}
                else:
                    from ..rdf.deltas import TripleDelta
                    delta = TripleDelta(
                        base_version=self.store.version,
                        add=setdiff_rows(net_add, cur),
                        evict=net_evict[member_rows(net_evict, cur)])
                    if not delta.is_noop:
                        self.store.apply_delta(delta)
                    extra = {"edges_updated": 0, "shipped_bytes": 0,
                             "placement_epoch": 0}
                self.write_commits += 1
            except Exception as err:   # one delta: the whole group fails
                for i in idxs:
                    results[i] = err
                return
            for i, ack in zip(idxs, acks):
                ack.update(extra)
                results[i] = ack

        for i, text in enumerate(texts):
            try:
                cu = compile_update(parse_update(text, self.dictionary),
                                    self.dictionary)
            except Exception as err:
                results[i] = err
                continue
            if cu.where is not None:
                flush()                # preserve arrival order around it
                try:
                    if self.system is not None:
                        rep = self.system.apply_update(cu)
                        self.write_commits += 1
                        results[i] = {
                            "kind": rep.kind, "inserted": rep.n_add,
                            "deleted": rep.n_evict,
                            "new_terms": rep.new_terms,
                            "dropped_rows": rep.dropped_rows,
                            "edges_updated": rep.edges_updated,
                            "shipped_bytes": rep.shipped_bytes,
                            "placement_epoch": rep.placement_epoch,
                            "coalesced": 1}
                    else:
                        results[i] = self._apply_standalone(cu)
                        results[i]["coalesced"] = 1
                except Exception as err:
                    results[i] = err
            else:
                group.append((i, cu))
        flush()
        return results

    @property
    def stats(self) -> EngineStats:
        return self.engine.stats

    # -- cloud-edge integration -----------------------------------------------
    @classmethod
    def from_system(cls, system, **kw) -> "SparqlEndpoint":
        """Endpoint sharing an :class:`~repro_torch.edge.system.EdgeCloudSystem`'s
        cloud store, dictionary, and engine (one cache domain)."""
        return cls(system=system, **kw)

    def run_round(self, user_texts: list[tuple[int, str]],
                  policy: str = "bnb", **kw):
        """Parse per-user query texts and run one scheduling round through
        ``system.run_round_batched`` — algebra queries route to edges
        whenever every *required* BGP leaf's pattern is resident there."""
        if self.system is None:
            raise ValueError("endpoint has no EdgeCloudSystem attached")
        queries = [(user, self.parse(text)) for user, text in user_texts]
        return self.system.run_round_batched(queries, policy=policy, **kw)
