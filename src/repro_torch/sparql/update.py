"""SPARQL UPDATE compilation: parsed updates -> cloud-side triple deltas.

The write half of the live-ingest path. :func:`compile_update` takes a
:class:`repro_torch.sparql.query.ParsedUpdate` (term *strings*, prefix-expanded)
and resolves it through the shared :class:`repro_torch.rdf.dictionary.Dictionary`:

- ``INSERT DATA`` **encodes** — brand-new terms are minted (bumping
  ``Dictionary.version`` so plan memos keyed on it invalidate, see the
  endpoint);
- ``DELETE DATA`` **resolves** — a row mentioning a term the dictionary has
  never seen cannot exist in any store, so it is dropped as a no-op (counted
  in ``dropped_rows``, never an error: SPARQL UPDATE delete of absent data
  succeeds);
- ``DELETE WHERE`` compiles its template to a :class:`QueryGraph`; an
  unknown constant makes the template unsatisfiable, so the whole update
  degenerates to a no-op.

Ground forms turn into a version-guarded :class:`TripleDelta` against the
cloud store via :func:`ground_delta`. ``DELETE WHERE`` is evaluated at
*apply* time (under the system's placement lock) by
:func:`where_evict_rows`: the matched triples of the template BGP are
exactly the triples the update removes, and the matcher already reports the
matched edge id per pattern per solution row.

The single ingest path that applies these to a live system (shard routing,
induced-index carry-forward, edge propagation) is
``repro_torch.edge.system.EdgeCloudSystem.apply_update``; a standalone endpoint
without a system applies the delta directly to its store.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..rdf.deltas import TripleDelta, as_rows, setdiff_rows
from ..rdf.dictionary import Dictionary
from .query import ParsedUpdate, ParseError, QueryGraph, TriplePattern


def _empty_rows() -> np.ndarray:
    return np.zeros((0, 3), dtype=np.int64)


@dataclass(frozen=True)
class CompiledUpdate:
    """A dictionary-resolved update, ready to apply to any store.

    ``add`` / ``evict`` are ground ``[N, 3]`` id rows (deduplicated); for
    ``delete_where``, ``where`` holds the template BGP and the ground arrays
    stay empty — the evict set is computed against the live store at apply
    time. ``new_terms`` counts dictionary terms minted (INSERT DATA only);
    ``dropped_rows`` counts ground delete rows discarded because a term was
    unknown (plus 1 for an unsatisfiable DELETE WHERE template).
    """

    kind: str
    add: np.ndarray = field(default_factory=_empty_rows)
    evict: np.ndarray = field(default_factory=_empty_rows)
    where: QueryGraph | None = None
    new_terms: int = 0
    dropped_rows: int = 0
    text: str = ""

    @property
    def is_ground(self) -> bool:
        return self.where is None

    @property
    def is_noop(self) -> bool:
        return (self.where is None and not len(self.add)
                and not len(self.evict))

    def touched_predicates(self) -> set[int] | None:
        """Predicate ids this update can possibly touch — the feasibility
        invalidation key for pattern memos (a pattern whose edge labels are
        all bound and disjoint from this set keeps its matches verbatim).
        ``None`` means "potentially every predicate" (a DELETE WHERE
        template with a variable predicate)."""
        pids: set[int] = set()
        for rows in (self.add, self.evict):
            if len(rows):
                pids.update(int(p) for p in np.unique(rows[:, 1]))
        if self.where is not None:
            for tp in self.where.patterns:
                if isinstance(tp.p, str):       # variable predicate: any
                    return None
                pids.add(int(tp.p))
        return pids


def _require_terms(triples: list[tuple], kind: str) -> None:
    for trip in triples:
        for tag, _ in trip:
            if tag != "term":
                raise ParseError(f"{kind} takes ground triples only")


def compile_update(parsed: ParsedUpdate,
                   dictionary: Dictionary) -> CompiledUpdate:
    """Resolve a parsed update through the dictionary (see module doc)."""
    kind = parsed.kind
    if kind == "insert_data":
        _require_terms(parsed.triples, "INSERT DATA")
        v0 = dictionary.version
        rows = [(dictionary.add_entity(s), dictionary.add_predicate(p),
                 dictionary.add_entity(o))
                for ((_, s), (_, p), (_, o)) in parsed.triples]
        add = (np.unique(as_rows(np.array(rows, dtype=np.int64)), axis=0)
               if rows else _empty_rows())
        return CompiledUpdate(kind=kind, add=add,
                              new_terms=dictionary.version - v0,
                              text=parsed.text)

    if kind == "delete_data":
        _require_terms(parsed.triples, "DELETE DATA")
        rows, dropped = [], 0
        for (_, s), (_, p), (_, o) in parsed.triples:
            if (dictionary.has_entity(s) and dictionary.has_predicate(p)
                    and dictionary.has_entity(o)):
                rows.append((dictionary.entity_id(s),
                             dictionary.predicate_id(p),
                             dictionary.entity_id(o)))
            else:
                dropped += 1            # unknown term: the row cannot exist
        evict = (np.unique(as_rows(np.array(rows, dtype=np.int64)), axis=0)
                 if rows else _empty_rows())
        return CompiledUpdate(kind=kind, evict=evict, dropped_rows=dropped,
                              text=parsed.text)

    if kind == "delete_where":
        pats: list[TriplePattern] = []
        for (stag, s), (ptag, p), (otag, o) in parsed.triples:
            if ptag == "term" and not dictionary.has_predicate(p):
                return CompiledUpdate(kind=kind, dropped_rows=1,
                                      text=parsed.text)
            for tag, t in ((stag, s), (otag, o)):
                if tag == "term" and not dictionary.has_entity(t):
                    return CompiledUpdate(kind=kind, dropped_rows=1,
                                          text=parsed.text)
            pats.append(TriplePattern(
                s=s if stag == "var" else dictionary.entity_id(s),
                p=p if ptag == "var" else dictionary.predicate_id(p),
                o=o if otag == "var" else dictionary.entity_id(o)))
        return CompiledUpdate(kind=kind,
                              where=QueryGraph(patterns=pats, projection=[]),
                              text=parsed.text)

    raise ParseError(f"unknown update kind {kind!r}")


def ground_delta(cu: CompiledUpdate, store) -> TripleDelta:
    """Version-guarded delta for a ground (data-form) update against
    ``store``'s current content: adds already present and evicts already
    absent are stripped so the delta stays minimal and invertible."""
    if cu.where is not None:
        raise ValueError("DELETE WHERE needs where_evict_rows at apply time")
    current = store.triples()
    return TripleDelta(base_version=store.version,
                       add=setdiff_rows(cu.add, current),
                       evict=cu.evict[_present_mask(cu.evict, current)])


def _present_mask(rows: np.ndarray, current: np.ndarray) -> np.ndarray:
    """Boolean mask of ``rows`` present in ``current`` (both [N, 3])."""
    from ..rdf.deltas import member_rows
    return member_rows(rows, current)


def where_evict_rows(cu: CompiledUpdate, store,
                     max_rows: int = 5_000_000) -> np.ndarray:
    """Evaluate a DELETE WHERE template against ``store`` and return the
    matched triple rows (the exact rows the update removes).

    Must run under whatever lock serializes the store (the system's
    placement lock): the matched edge ids are only meaningful against the
    version they were computed on.
    """
    from .matcher import match_bgp

    if cu.where is None:
        return _empty_rows()
    res = match_bgp(store, cu.where, max_rows=max_rows)
    if res.edge_ids.size == 0:
        return _empty_rows()
    eids = np.unique(res.edge_ids.reshape(-1))
    return np.stack([store.s[eids], store.p[eids], store.o[eids]], axis=1)
