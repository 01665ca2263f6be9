"""Subgraph-sampling BGP templates with known exact cardinalities.

WatDiv-style benchmarks instantiate *structural templates* against the
actual data so constants are witnessed by real triples and every query is
guaranteed non-empty. :class:`PatternSampler` generalizes that recipe to
the live store: instead of a fixed schema-bound template table
(:data:`repro_torch.rdf.generator._TEMPLATES`), it **walks the graph itself**
through the :class:`~repro_torch.rdf.graph.RDFStore` protocol surface
(``pred_index`` sorted views + ``searchsorted``), so it works unchanged
over a monolithic :class:`~repro_torch.rdf.graph.TripleStore` or a
:class:`~repro_torch.rdf.sharding.ShardedTripleStore`, on any dataset.

Four shapes, each grown from a uniformly sampled seed triple:

- ``star``      — one center subject with ``size`` distinct out-predicates;
- ``path``      — a ``size``-hop subject→object random walk;
- ``flower``    — a star whose petals are extended one more hop where the
  witness object has out-edges (the paper's "flower" pattern);
- ``snowflake`` — a path with extra star edges grafted at both endpoints.

Every edge of a sampled pattern is backed by a concrete *witness* triple
discovered during the walk, so the witness assignment is one solution and
the query matches at least once. ``const_frac`` instantiates that fraction
of leaf positions with their witness constants (selectivity knob);
``decorations`` optionally wraps the BGP in witness-preserving algebra
(FILTER / OPTIONAL / UNION / VALUES / LIMIT).

The rendered SPARQL text is evaluated at sample time (parse → compile →
evaluate on a private numpy engine) and the **exact** result cardinality
is recorded on the :class:`SampledQuery` — the ground truth the traffic
driver and ``benchmarks/bench_workload.py`` verify served answers against.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

from ..rdf.dictionary import Dictionary
from ..rdf.graph import RDFStore
from ..sparql.algebra import compile_query, evaluate_plan
from ..sparql.engine import QueryEngine
from ..sparql.query import parse_query

SHAPES = ("star", "path", "flower", "snowflake")

#: decorations understood by :attr:`ShapeConfig.decorations`
DECORATIONS = ("filter", "optional", "union", "values", "limit")


@dataclass(frozen=True)
class ShapeConfig:
    """Per-shape sampling knobs.

    ``size`` is the star arity / path hop count (flower and snowflake
    derive their extension counts from it). ``const_frac`` is the
    probability that each eligible leaf position is instantiated with its
    witness constant. ``decorations`` is a pool; each sampled query draws
    one uniformly (include ``None`` in the pool to mix in plain BGPs).
    """

    shape: str
    size: int = 3
    const_frac: float = 0.3
    decorations: tuple = ()

    def __post_init__(self) -> None:
        if self.shape not in SHAPES:
            raise ValueError(f"unknown shape {self.shape!r}; "
                             f"expected one of {SHAPES}")
        if self.size < 1:
            raise ValueError("size must be >= 1")
        if not 0.0 <= self.const_frac <= 1.0:
            raise ValueError("const_frac must be in [0, 1]")
        for dec in self.decorations:
            if dec is not None and dec not in DECORATIONS:
                raise ValueError(f"unknown decoration {dec!r}; "
                                 f"expected one of {DECORATIONS}")


@dataclass(frozen=True)
class SampledQuery:
    """One sampled template: SPARQL text + its ground-truth cardinality.

    ``cardinality`` is the exact solution-multiset size against the store
    the sampler walked, at ``store_version`` — any later write invalidates
    it (the churn write style of :mod:`~repro_torch.workload.traffic` is built
    to NOT invalidate it: churn touches only an excluded predicate and
    fresh entities, so results over sampled predicates are unchanged).
    """

    name: str
    shape: str
    text: str
    cardinality: int
    n_patterns: int
    n_consts: int                   # leaf positions instantiated
    pids: tuple                     # predicate ids the pattern uses
    decoration: str | None
    store_version: object


class PatternSampler:
    """Samples witnessed BGP shapes from a live store (see module doc).

    Parameters
    ----------
    store, dictionary : the graph to walk and its term dictionary.
    seed : deterministic sampling seed (same seed ⇒ identical queries).
    engine : optional `QueryEngine` used for ground-truth evaluation;
        defaults to a private numpy engine: the oracle of the recorded
        cardinalities, independent of the serving engine under test (on
        the card, the endpoint's torch engine), whose caches and stats it
        never touches.
    exclude_predicates : predicate ids (ints) or term strings never used
        in sampled patterns — reserve one for churn-style writes so the
        write mix cannot invalidate recorded cardinalities.
    max_attempts : walk retries per requested query before giving up
        (tiny/degenerate stores yield fewer queries than asked, never an
        error; an empty store yields ``[]``).
    """

    def __init__(self, store: RDFStore, dictionary: Dictionary, *,
                 seed: int = 0, engine: QueryEngine | None = None,
                 exclude_predicates=(), max_attempts: int = 32) -> None:
        self.store = store
        self.dictionary = dictionary
        self.rng = np.random.default_rng(seed)
        self.engine = engine or QueryEngine(backend="numpy")
        self.max_attempts = int(max_attempts)
        excl = set()
        for p in exclude_predicates:
            excl.add(dictionary.predicate_id(p) if isinstance(p, str)
                     else int(p))
        self.exclude = frozenset(excl)
        self._counter = 0

    # -- protocol-surface graph walking --------------------------------------
    def _live_pids(self) -> np.ndarray:
        """Predicates with at least one triple, minus the excluded set."""
        counts = np.asarray(self.store.pred_count)
        pids = np.flatnonzero(counts > 0)
        if self.exclude:
            pids = pids[~np.isin(pids, list(self.exclude))]
        return pids

    def _out_objects(self, eid: int, pid: int) -> np.ndarray:
        """Objects of out-edges ``(eid, pid, ?)`` via the sorted view."""
        idx = self.store.pred_index(pid)
        lo = np.searchsorted(idx.s_sorted, eid, "left")
        hi = np.searchsorted(idx.s_sorted, eid, "right")
        return self.store.o[idx.s_order[lo:hi]]

    def _out_pids(self, eid: int, pids: np.ndarray) -> list:
        """Subset of ``pids`` under which ``eid`` has an out-edge."""
        out = []
        for pid in pids:
            idx = self.store.pred_index(int(pid))
            lo = np.searchsorted(idx.s_sorted, eid, "left")
            if lo < len(idx.s_sorted) and idx.s_sorted[lo] == eid:
                out.append(int(pid))
        return out

    def _seed_subject(self, pids: np.ndarray) -> int | None:
        """Subject of a uniformly sampled non-excluded triple."""
        weights = np.asarray(self.store.pred_count)[pids]
        total = int(weights.sum())
        if total == 0:
            return None
        pid = int(self.rng.choice(pids, p=weights / total))
        tids = self.store.pred_tids(pid)
        return int(self.store.s[tids[self.rng.integers(len(tids))]])

    # -- shape growth (patterns over var names / witness ids) ----------------
    # Each grower returns (patterns, witness) or None to retry:
    # patterns: list of (s, pid, o) with s/o either a "?var" or an entity
    # id; witness: var -> entity id, one concrete solution by construction.

    def _grow_star(self, size: int, pids: np.ndarray):
        center = self._seed_subject(pids)
        if center is None:
            return None
        cand = self._out_pids(center, pids)
        if len(cand) < min(2, size):
            return None
        chosen = self.rng.choice(cand, size=min(size, len(cand)),
                                 replace=False)
        pats, witness = [], {"?x0": center}
        for i, pid in enumerate(chosen):
            objs = self._out_objects(center, int(pid))
            witness[f"?v{i}"] = int(objs[self.rng.integers(len(objs))])
            pats.append(("?x0", int(pid), f"?v{i}"))
        return pats, witness

    def _grow_path(self, size: int, pids: np.ndarray):
        cur = self._seed_subject(pids)
        if cur is None:
            return None
        pats, witness = [], {"?x0": cur}
        for hop in range(size):
            cand = self._out_pids(cur, pids)
            if not cand:
                break
            pid = int(self.rng.choice(cand))
            objs = self._out_objects(cur, pid)
            nxt = int(objs[self.rng.integers(len(objs))])
            pats.append((f"?x{hop}", pid, f"?x{hop + 1}"))
            witness[f"?x{hop + 1}"] = nxt
            cur = nxt
        if len(pats) < min(2, size):
            return None
        return pats, witness

    def _grow_flower(self, size: int, pids: np.ndarray):
        grown = self._grow_star(size, pids)
        if grown is None:
            return None
        pats, witness = grown
        petals = [p for p in pats]          # extend up to ceil(k/2) petals
        self.rng.shuffle(petals)
        extended = 0
        for (_, _, ovar) in petals:
            if extended >= max(1, (len(pats) + 1) // 2):
                break
            tip = witness[ovar]
            cand = self._out_pids(tip, pids)
            if not cand:
                continue
            pid = int(self.rng.choice(cand))
            objs = self._out_objects(tip, pid)
            wvar = f"?w{extended}"
            witness[wvar] = int(objs[self.rng.integers(len(objs))])
            pats.append((ovar, pid, wvar))
            extended += 1
        if extended == 0:                    # no petal extends: plain star
            return None
        return pats, witness

    def _grow_snowflake(self, size: int, pids: np.ndarray):
        grown = self._grow_path(size, pids)
        if grown is None:
            return None
        pats, witness = grown
        used = {pid for (_, pid, _) in pats}
        grafted = 0
        last = len(pats)                    # path hops before grafting
        for k, node_var in ((0, "?x0"), (1, f"?x{last}")):
            eid = witness[node_var]
            cand = [p for p in self._out_pids(eid, pids) if p not in used]
            if not cand:
                continue
            pid = int(self.rng.choice(cand))
            objs = self._out_objects(eid, pid)
            gvar = f"?g{k}"
            witness[gvar] = int(objs[self.rng.integers(len(objs))])
            pats.append((node_var, pid, gvar))
            used.add(pid)
            grafted += 1
        if grafted == 0:
            return None
        return pats, witness

    _GROWERS = {"star": _grow_star, "path": _grow_path,
                "flower": _grow_flower, "snowflake": _grow_snowflake}

    # -- rendering ------------------------------------------------------------
    def _instantiate(self, pats, witness, const_frac: float):
        """Replace leaf object variables by their witness constants with
        probability ``const_frac``. Only *leaf* positions (variables used
        in exactly one pattern, object side) are eligible — join variables
        stay variables so the shape keeps its structure."""
        uses = Counter()
        for s, _, o in pats:
            for t in (s, o):
                if isinstance(t, str):
                    uses[t] += 1
        out, n_consts = [], 0
        for s, pid, o in pats:
            if (isinstance(o, str) and uses[o] == 1
                    and self.rng.random() < const_frac):
                o = witness[o]
                n_consts += 1
            out.append((s, pid, o))
        return out, n_consts

    def _term(self, eid: int) -> str:
        return f"<{self.dictionary.entity(eid)}>"

    def _render(self, pats) -> tuple[str, list]:
        """SPARQL text + ordered variable list for a pattern list."""
        seen: dict[str, None] = {}
        body = []
        for s, pid, o in pats:
            st = s if isinstance(s, str) else self._term(s)
            ot = o if isinstance(o, str) else self._term(o)
            for t in (s, o):
                if isinstance(t, str):
                    seen.setdefault(t)
            body.append(f"{st} <{self.dictionary.predicate(pid)}> {ot}")
        variables = list(seen)
        return (f"SELECT {' '.join(variables)} WHERE {{ "
                + " . ".join(body) + " }"), variables

    def _decorate(self, pats, witness, decoration, pids: np.ndarray):
        """Render with a witness-preserving decoration applied."""
        text, variables = self._render(pats)
        if decoration is None or not variables:
            return text
        body = text[text.index("{") + 1:text.rindex("}")].strip()
        head = text[:text.index("{")]
        var = str(self.rng.choice(variables))
        if decoration == "filter":
            # exclude an entity that is NOT the witness: the witness row
            # survives, so the query stays non-empty
            avoid = witness[var]
            other = (avoid + 1) % max(1, self.dictionary.num_entities)
            if other == avoid:
                return text
            return f"{head}{{ {body} . FILTER (?{var[1:]} != " \
                   f"{self._term(other)}) }}"
        if decoration == "values":
            avoid = witness[var]
            other = (avoid + 1) % max(1, self.dictionary.num_entities)
            terms = f"{self._term(avoid)} {self._term(other)}" \
                if other != avoid else self._term(avoid)
            return f"{head}{{ {body} . VALUES {var} {{ {terms} }} }}"
        if decoration == "optional" and len(pats) >= 2:
            parts = body.split(" . ")
            return (f"{head}{{ {' . '.join(parts[:-1])} . "
                    f"OPTIONAL {{ {parts[-1]} }} }}")
        if decoration == "union" and len(pats) >= 2:
            parts = body.split(" . ")
            alt_pid = int(self.rng.choice(pids))
            s, _, o = pats[-1]
            st = s if isinstance(s, str) else self._term(s)
            ot = o if isinstance(o, str) else self._term(o)
            alt = f"{st} <{self.dictionary.predicate(alt_pid)}> {ot}"
            return (f"{head}{{ {' . '.join(parts[:-1])} . "
                    f"{{ {parts[-1]} }} UNION {{ {alt} }} }}")
        if decoration == "limit":
            return f"{text} LIMIT {int(self.rng.integers(1, 11))}"
        return text                          # decoration not applicable

    # -- public API -----------------------------------------------------------
    def sample(self, cfg: ShapeConfig, n: int) -> list:
        """Sample up to ``n`` queries of ``cfg``'s shape (see class doc)."""
        out: list[SampledQuery] = []
        if self.store.num_triples == 0 or n <= 0:
            return out
        pids = self._live_pids()
        if len(pids) == 0:
            return out
        grow = self._GROWERS[cfg.shape]
        attempts = 0
        budget = max(n, 1) * self.max_attempts
        while len(out) < n and attempts < budget:
            attempts += 1
            grown = grow(self, cfg.size, pids)
            if grown is None:
                continue
            pats, witness = grown
            pats, n_consts = self._instantiate(pats, witness,
                                               cfg.const_frac)
            decoration = (self.rng.choice(np.asarray(cfg.decorations,
                                                     dtype=object))
                          if cfg.decorations else None)
            decoration = None if decoration is None else str(decoration)
            text = self._decorate(pats, witness, decoration, pids)
            card = self._cardinality(text)
            self._counter += 1
            out.append(SampledQuery(
                name=f"{cfg.shape}{cfg.size}_{self._counter:04d}",
                shape=cfg.shape, text=text, cardinality=card,
                n_patterns=len(pats), n_consts=n_consts,
                pids=tuple(sorted({pid for (_, pid, _) in pats})),
                decoration=decoration,
                store_version=self.store.version))
        return out

    def sample_mix(self, cfgs, n_per: int) -> list:
        """Flat list over several shape configs, ``n_per`` queries each."""
        out: list[SampledQuery] = []
        for cfg in cfgs:
            out.extend(self.sample(cfg, n_per))
        return out

    def _cardinality(self, text: str) -> int:
        """Exact solution count for ``text`` against the live store."""
        root = compile_query(parse_query(text, self.dictionary),
                             self.dictionary)
        return len(evaluate_plan(root, self.store, self.engine))
