"""Synthetic RDF data + workload generation, WatDiv-style.

WatDiv [Aluç et al., ISWC'14] generates an e-commerce-flavoured schema with
entity classes connected by predicates of widely varying fan-out, then derives
query workloads from structural templates (star / linear / snowflake /
complex).  We reproduce that recipe at configurable scale so every benchmark
in §5 of the paper has a deterministic, self-contained data source.

All randomness flows through a seeded ``np.random.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dictionary import Dictionary
from .graph import TripleStore

# (class_from, predicate, class_to, out_degree_low, out_degree_high, coverage)
# coverage = fraction of `class_from` instances that carry this predicate.
_SCHEMA = [
    ("User",     "follows",     "User",     1, 8,  0.6),
    ("User",     "likes",       "Product",  1, 10, 0.8),
    ("User",     "makesPurchase", "Purchase", 1, 4, 0.5),
    ("Purchase", "purchaseFor", "Product",  1, 1,  1.0),
    ("Purchase", "purchaseDate", "Date",    1, 1,  1.0),
    ("Product",  "hasGenre",    "Genre",    1, 3,  0.9),
    ("Product",  "producedBy",  "Producer", 1, 1,  0.7),
    ("Product",  "hasReview",   "Review",   0, 12, 0.7),
    ("Review",   "reviewer",    "User",     1, 1,  1.0),
    ("Review",   "rating",      "Rating",   1, 1,  1.0),
    ("Product",  "retailedBy",  "Retailer", 1, 4,  0.8),
    ("Retailer", "country",     "Country",  1, 1,  1.0),
    ("User",     "country",     "Country",  1, 1,  0.9),
    ("Producer", "country",     "Country",  1, 1,  0.9),
    ("Genre",    "subgenreOf",  "Genre",    0, 2,  0.4),
]

# relative class sizes at scale=1.0 (instances per class)
_CLASS_SIZE = {
    "User": 500, "Product": 400, "Purchase": 300, "Review": 600,
    "Producer": 40, "Retailer": 30, "Genre": 25, "Date": 80,
    "Rating": 5, "Country": 20,
}


@dataclass
class GeneratedGraph:
    store: TripleStore
    dictionary: Dictionary
    class_of: dict[str, np.ndarray]   # class name -> entity id array


def generate_watdiv_like(scale: float = 1.0, seed: int = 0) -> GeneratedGraph:
    """Generate a WatDiv-flavoured RDF graph. ``scale=1`` ≈ 6-8k triples.

    Triples grow ~linearly with ``scale`` (WatDiv 100M <-> scale ≈ 1.5e4).
    """
    rng = np.random.default_rng(seed)
    d = Dictionary()
    class_of: dict[str, np.ndarray] = {}
    for cname, base in _CLASS_SIZE.items():
        n = max(2, int(base * scale))
        ids = np.asarray([d.add_entity(f"{cname}{i}") for i in range(n)])
        class_of[cname] = ids

    s_all, p_all, o_all = [], [], []
    for cfrom, pred, cto, lo, hi, cov in _SCHEMA:
        pid = d.add_predicate(pred)
        src = class_of[cfrom]
        dst = class_of[cto]
        mask = rng.random(len(src)) < cov
        srcs = src[mask]
        # power-law-ish popularity on destinations: a few hot entities get
        # most references (WatDiv models this with Zipfian object selection)
        weights = 1.0 / np.arange(1, len(dst) + 1) ** 0.8
        weights /= weights.sum()
        degs = rng.integers(lo, hi + 1, size=len(srcs))
        total = int(degs.sum())
        if total == 0:
            continue
        objs = rng.choice(dst, size=total, p=weights, replace=True)
        s_all.append(np.repeat(srcs, degs))
        p_all.append(np.full(total, pid, dtype=np.int64))
        o_all.append(objs)

    store = TripleStore(np.concatenate(s_all), np.concatenate(p_all),
                        np.concatenate(o_all), d.num_entities,
                        d.num_predicates)
    return GeneratedGraph(store=store, dictionary=d, class_of=class_of)


# ---------------------------------------------------------------------------
# Workload generation: structural templates -> concrete BGP queries
# ---------------------------------------------------------------------------

# Templates are edge lists over symbolic vertices. Vertices named "?x*" are
# variables; "C*" slots are filled with constants sampled from actual graph
# matches, guaranteeing non-empty results (how WatDiv instantiates templates).
# (src, predicate, dst)
_TEMPLATES: dict[str, list[tuple[str, str, str]]] = {
    # star: one center, several outgoing edges
    "star2": [("?x", "likes", "?p1"), ("?x", "follows", "?u1")],
    "star3": [("?x", "likes", "?p1"), ("?x", "follows", "?u1"),
              ("?x", "country", "?c")],
    # linear chains
    "chain2": [("?x", "likes", "?y"), ("?y", "hasGenre", "?g")],
    "chain3": [("?x", "makesPurchase", "?pu"), ("?pu", "purchaseFor", "?pr"),
               ("?pr", "producedBy", "?prod")],
    # snowflake: chain + star at the end
    "snowflake": [("?x", "likes", "?p"), ("?p", "hasReview", "?r"),
                  ("?r", "reviewer", "?u"), ("?p", "retailedBy", "?rt")],
    # complex: cycle-ish with a constant anchor slot
    "complex": [("?x", "likes", "?p"), ("?x", "country", "C0"),
                ("?p", "hasGenre", "?g"), ("?p", "retailedBy", "?rt"),
                ("?rt", "country", "C0")],
    # constant-anchored star (selective)
    "anchored_star": [("?x", "likes", "C0"), ("?x", "follows", "?u"),
                      ("?x", "country", "?c")],
    "anchored_chain": [("C0", "hasReview", "?r"), ("?r", "reviewer", "?u"),
                       ("?u", "country", "?c")],
}


def template_names() -> list[str]:
    return list(_TEMPLATES)


def workload_sparql(g: GeneratedGraph, n_queries: int, seed: int = 0,
                    templates: list[str] | None = None) -> list[str]:
    """Instantiate ``n_queries`` SPARQL BGP query strings from templates."""
    rng = np.random.default_rng(seed)
    names = templates or list(_TEMPLATES)
    d = g.dictionary
    queries: list[str] = []
    attempts = 0
    while len(queries) < n_queries and attempts < n_queries * 20:
        attempts += 1
        name = names[int(rng.integers(len(names)))]
        edges = _TEMPLATES[name]
        # sample constants: pick a random triple of the template's first
        # constant-adjacent predicate and reuse its entity
        const_map: dict[str, str] = {}
        ok = True
        for (sv, pred, ov) in edges:
            for slot, is_subj in ((sv, True), (ov, False)):
                if slot.startswith("C") and slot not in const_map:
                    pid = d.predicate_id(pred)
                    tids = g.store.pred_tids(pid)
                    if len(tids) == 0:
                        ok = False
                        break
                    tid = int(tids[int(rng.integers(len(tids)))])
                    eid = int(g.store.s[tid] if is_subj else g.store.o[tid])
                    const_map[slot] = d.entity(eid)
            if not ok:
                break
        if not ok:
            continue

        def term(t: str) -> str:
            if t.startswith("?"):
                return t
            return f"<{const_map[t]}>"

        variables = sorted({t for e in edges for t in (e[0], e[2])
                            if t.startswith("?")})
        body = " . ".join(
            f"{term(sv)} <{pred}> {term(ov)}" for (sv, pred, ov) in edges)
        queries.append(f"SELECT {' '.join(variables)} WHERE {{ {body} }}")
    return queries
