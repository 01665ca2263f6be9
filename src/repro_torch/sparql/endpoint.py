"""`SparqlEndpoint` — the one-object public query API, read path.

>>> ep = SparqlEndpoint(store, dictionary)          # torch engine on cuda
>>> ep.query('SELECT ?x WHERE { ?x <likes> ?p . FILTER (?p != "P0") }')
>>> ep.ask('ASK { ?x <subgenreOf> ?y }')
>>> print(ep.explain(text))                         # plan + cache provenance
>>> ep.query_many(texts)                            # one engine batch

Everything funnels through :mod:`repro_torch.sparql.algebra`: queries
compile to operator trees whose BGP leaves run on the shard-parallel
batched engine, so the scan/plan/result LRUs, backend registry (``numpy`` /
``torch``), and sharded stores all apply unchanged. Compiled plans are
memoized per query text (`plan_cache_size`), making repeated text queries
parse-free.

The endpoint runs the ``torch`` backend on ``cuda`` unless the caller
passes ``device="cpu"`` or ``backend="numpy"``. The write path (SPARQL
UPDATE) and the cloud-edge system hooks are not part of this package yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

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
    engine; one endpoint may share an engine with other endpoints (caches
    are version-keyed and lock-guarded).
    """

    def __init__(self, store: RDFStore, dictionary: Dictionary, *,
                 engine: QueryEngine | None = None,
                 backend: str = "torch",
                 device: str | torch.device | None = None,
                 plan_cache_size: int = 256,
                 result_cache_size: int = 256,
                 result_cache_bytes: int = 256 * 1024 * 1024) -> None:
        if store is None or dictionary is None:
            raise ValueError("SparqlEndpoint needs a store and a dictionary")
        self.store = store
        self.dictionary = dictionary
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

    def explain(self, text: str) -> str:
        """Operator tree + per-BGP-leaf cache-hit provenance and estimated
        cardinalities against this endpoint's store/engine state."""
        return explain_plan(self.parse(text), self.store, self.engine)

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

    @property
    def stats(self) -> EngineStats:
        return self.engine.stats
