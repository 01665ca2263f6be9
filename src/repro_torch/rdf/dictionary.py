"""Dictionary encoding for RDF terms.

RDF engines (gStore, RDF-3X, Virtuoso, ...) map URIs/literals to dense integer
ids once at load time; all query processing then happens on integers. The
cloud and every edge server share one global dictionary, so a subgraph shipped
to an edge needs no re-encoding (paper §2.2: edges store subgraphs of the same
graph G).
"""

from __future__ import annotations

import numpy as np


class Dictionary:
    """Bidirectional term <-> id mapping (entities and predicates separate).

    Entity ids and predicate ids live in independent id spaces, mirroring the
    paper's graph model G = {V, E, L, f}: V indexes entities, L indexes
    properties.
    """

    def __init__(self) -> None:
        self._ent2id: dict[str, int] = {}
        self._id2ent: list[str] = []
        self._pred2id: dict[str, int] = {}
        self._id2pred: list[str] = []
        self._version = 0

    # -- encoding ----------------------------------------------------------
    def add_entity(self, term: str) -> int:
        eid = self._ent2id.get(term)
        if eid is None:
            eid = len(self._id2ent)
            self._ent2id[term] = eid
            self._id2ent.append(term)
            self._version += 1
        return eid

    def add_predicate(self, term: str) -> int:
        pid = self._pred2id.get(term)
        if pid is None:
            pid = len(self._id2pred)
            self._pred2id[term] = pid
            self._id2pred.append(term)
            self._version += 1
        return pid

    @property
    def version(self) -> int:
        """Monotone token bumped whenever a NEW term is added.

        Compiled query plans bake dictionary ids in (triple constants,
        FILTER-operand ``ent_id`` / ``pred_id``), so anything memoizing a
        plan must key on this alongside the query text — a term unknown at
        compile time may exist after live ingest grows the dictionary
        (:class:`repro_torch.sparql.endpoint.SparqlEndpoint` does exactly this).
        """
        return self._version

    # -- lookup ------------------------------------------------------------
    def entity_id(self, term: str) -> int:
        return self._ent2id[term]

    def predicate_id(self, term: str) -> int:
        return self._pred2id[term]

    def has_entity(self, term: str) -> bool:
        return term in self._ent2id

    def has_predicate(self, term: str) -> bool:
        return term in self._pred2id

    def entity(self, eid: int) -> str:
        return self._id2ent[eid]

    def predicate(self, pid: int) -> str:
        return self._id2pred[pid]

    @property
    def num_entities(self) -> int:
        return len(self._id2ent)

    @property
    def num_predicates(self) -> int:
        return len(self._id2pred)

    # -- (de)serialization ---------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "entities": np.asarray(self._id2ent, dtype=object),
            "predicates": np.asarray(self._id2pred, dtype=object),
        }

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray]) -> "Dictionary":
        d = cls()
        for t in arrays["entities"]:
            d.add_entity(str(t))
        for t in arrays["predicates"]:
            d.add_predicate(str(t))
        return d
