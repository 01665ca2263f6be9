"""Patterns, minimum DFS codes, and the edge-server pattern index.

Paper §3.2 (Data Model):

- A *pattern* generalizes a query: every constant at subject/object position
  becomes a variable (Def. 4). Predicate labels are kept; identical constants
  keep their join structure (they were one query-graph vertex already).
- Query executability at an edge server is decided by **graph isomorphism**
  between the query's pattern and a stored pattern, via canonical *minimum
  DFS codes* (gSpan [Yan/Yu/Han, SIGMOD'04]) hashed into a table.

The minimum DFS code here extends gSpan to *directed, edge-labeled
multigraphs with unlabeled vertices* (exactly the shape of SPARQL patterns):
each code entry covers ``(i, j, direction, label)`` over DFS discovery
indices; ``direction`` records the RDF edge orientation relative to the
traversal. The canonical form is the lexicographic minimum over all valid
rightmost-path DFS traversals; two patterns share a code iff isomorphic.

Limitation (documented in DESIGN.md): predicate *variables* are all encoded
with one sentinel label; patterns whose only difference is predicate-variable
sharing across edges are treated as non-indexable and routed to the cloud
(``Pattern.indexable``). Our workloads use constant predicates throughout.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..sparql.query import QueryGraph

VAR_PRED_LABEL = -2


@dataclass(frozen=True)
class Pattern:
    """A query shape: directed edge-labeled multigraph over anonymous vertices.

    ``edges``: tuple of (u, v, label) with u, v in [0, n_vertices).
    Identical duplicate edges are collapsed (they add no constraint under
    homomorphism semantics).
    """

    edges: tuple[tuple[int, int, int], ...]
    n_vertices: int
    indexable: bool = True

    @cached_property
    def code(self) -> tuple:
        return min_dfs_code(self.edges, self.n_vertices)

    @cached_property
    def key(self) -> tuple:
        """Hashable canonical key (what the paper's hash table indexes)."""
        return (self.n_vertices, self.code)

    def isomorphic_to(self, other: "Pattern") -> bool:
        return self.key == other.key

    @property
    def n_edges(self) -> int:
        return len(self.edges)


def pattern_of(q: QueryGraph) -> Pattern:
    """Def. 4: replace constants at subject/object positions by variables.

    Vertex identity (join structure) is preserved; predicate constants stay.
    """
    verts = q.vertices()
    vmap = {v: i for i, v in enumerate(verts)}
    edges = set()
    pred_vars: dict[str, int] = {}
    for tp in q.patterns:
        if isinstance(tp.p, str):
            label = VAR_PRED_LABEL
            pred_vars[tp.p] = pred_vars.get(tp.p, 0) + 1
        else:
            label = tp.p
        edges.add((vmap[tp.s], vmap[tp.o], label))
    # a predicate variable shared across edges encodes a label-join the DFS
    # code cannot express -> non-indexable (cloud-routed), stays sound
    indexable = all(c == 1 for c in pred_vars.values())
    return Pattern(edges=tuple(sorted(edges)), n_vertices=len(verts),
                   indexable=indexable)


# ---------------------------------------------------------------------------
# algebra-plan feasibility (per-BGP-leaf patterns)
# ---------------------------------------------------------------------------

def feasibility_patterns(q) -> list[Pattern] | None:
    """Patterns whose residency certifies edge executability of ``q``.

    ``q`` is a plain :class:`~repro_torch.sparql.query.QueryGraph` (one pattern —
    the pre-algebra behavior) or a compiled algebra plan
    (:class:`repro_torch.sparql.algebra.Node`). For a plan, edge execution is
    sound iff the union of its **required** BGP leaves is covered by the
    edge's pattern-induced residency: every required leaf isomorphic to a
    resident pattern finds its complete match set over G[P] (the paper's
    completeness guarantee), and FILTER / DISTINCT / ORDER / slice
    operators only ever combine or drop those rows. OPTIONAL right sides
    are *excluded from the requirement* — they can only extend solutions,
    and an edge lacking them under-binds optional columns (the documented
    relaxation; deploy their patterns too for exact cloud parity).

    Returns ``None`` when edge execution cannot be certified at all: a
    required leaf is disconnected (no DFS code exists) or the plan has no
    required leaf with patterns (nothing to anchor residency on).
    """
    leaves = getattr(q, "bgp_leaves", None)
    if leaves is None:
        return [pattern_of(q)]
    pats: list[Pattern] = []
    for leaf in q.bgp_leaves(required_only=True):
        if not leaf.query.patterns:
            continue
        if not leaf.query.is_weakly_connected():
            return None
        pats.append(pattern_of(leaf.query))
    return pats or None


@dataclass
class LeafResidency:
    """Per-required-leaf residency report — the refactor of the
    all-or-nothing edge-executable boolean into *which* leaves live where.

    leaves:   required leaf :class:`QueryGraph`\\ s (``bgp_leaves`` order)
    leaf_idx: index of each into the plan's full ``bgp_leaves()`` list;
              ``[-1]`` for a plain :class:`QueryGraph` (the query itself)
    resident: [L, K'] bool — ``leaves[i]``'s whole-leaf pattern is
              isomorphic to a pattern resident at ``servers[j]``
    servers:  the server ids the columns of ``resident`` refer to
    """

    leaves: list
    leaf_idx: list[int]
    resident: np.ndarray
    servers: list[int]

    def covered_servers(self) -> list[int]:
        """Servers holding EVERY required leaf (the legacy e[n,k] == 1)."""
        full = self.resident.all(axis=0)
        return [s for s, ok in zip(self.servers, full) if ok]


def leaf_residency(q, edge_servers) -> LeafResidency | None:
    """Report which required leaves of ``q`` are resident per edge server.

    Same certification rules as :func:`feasibility_patterns` (whole-leaf
    pattern isomorphism against each server's index; OPTIONAL right sides
    excluded), but instead of collapsing to one boolean per edge it keeps
    the [leaf x server] matrix — the input the partial-evaluation planner
    (:mod:`repro_torch.sparql.partial_eval`) needs to split a query across a set
    of contributing edges. ``edge_servers`` only need ``server_id`` and
    ``can_execute(pattern)``. Returns ``None`` when residency cannot be
    certified at all (disconnected required leaf / nothing required).
    """
    leaves = getattr(q, "bgp_leaves", None)
    if leaves is None:
        if not q.patterns or not q.is_weakly_connected():
            return None
        qs, idxs = [q], [-1]
    else:
        required = {id(leaf) for leaf in q.bgp_leaves(required_only=True)}
        qs, idxs = [], []
        for i, leaf in enumerate(q.bgp_leaves()):
            if id(leaf) not in required or not leaf.query.patterns:
                continue
            if not leaf.query.is_weakly_connected():
                return None
            qs.append(leaf.query)
            idxs.append(i)
        if not qs:
            return None
    resident = np.zeros((len(qs), len(edge_servers)), dtype=bool)
    for i, lq in enumerate(qs):
        p = pattern_of(lq)
        for j, es in enumerate(edge_servers):
            resident[i, j] = bool(es.can_execute(p))
    return LeafResidency(leaves=qs, leaf_idx=idxs, resident=resident,
                         servers=[es.server_id for es in edge_servers])


def observed_patterns(q) -> list[Pattern]:
    """Patterns the placement policy should learn from ``q`` — ALL its BGP
    leaves (OPTIONAL sides included, so dynamic placement can make optional
    parts resident and restore exact edge/cloud parity), skipping
    disconnected or empty leaves."""
    leaves = getattr(q, "bgp_leaves", None)
    if leaves is None:
        return [pattern_of(q)]
    return [pattern_of(leaf.query) for leaf in q.bgp_leaves()
            if leaf.query.patterns and leaf.query.is_weakly_connected()]


# ---------------------------------------------------------------------------
# minimum DFS code
# ---------------------------------------------------------------------------

def _entry_key(i: int, j: int, d: int, l: int) -> tuple:
    """Total order on code entries realizing gSpan's edge order.

    backward (j <= i): (i, 1, j, d, l) — forward (j > i): (j, 0, -i, d, l).
    This places, for a shared prefix, backward edges of the rightmost vertex
    before forward extensions, and deeper forward extensions last, matching
    gSpan's <_e; direction flag and label break structural ties.
    """
    if j > i:
        return (j, 0, -i, d, l)
    return (i, 1, j, d, l)


def min_dfs_code(edges: tuple[tuple[int, int, int], ...],
                 n_vertices: int) -> tuple:
    """Lexicographically minimal DFS code over all valid traversals.

    Exhaustive rightmost-path extension with lexicographic prefix pruning —
    patterns are small (the paper notes <10 triples), so this is
    microseconds-to-milliseconds in practice.
    """
    if not edges:
        return ()
    E = len(edges)
    # undirected incidence: vertex -> list of (edge_idx, other, direction);
    # direction 0 when the stored edge leaves this endpoint (u == vertex)
    inc: list[list[tuple[int, int, int]]] = [[] for _ in range(n_vertices)]
    for ei, (u, v, l) in enumerate(edges):
        inc[u].append((ei, v, 0))
        if u != v:
            inc[v].append((ei, u, 1))

    best: list[tuple] | None = None

    def search(order: tuple[int, ...], vmap: dict[int, int],
               rpath: tuple[int, ...], used: int, code: list[tuple]) -> None:
        nonlocal best
        if len(code) == E:
            if best is None or code < best:
                best = list(code)
            return
        pos = len(code)
        cands: list[tuple[tuple, int, int, int]] = []  # (key, edge, newv, src)
        rm = rpath[-1]
        on_rpath = set(rpath)
        # backward (incl. self-loop) edges from the rightmost vertex
        for (ei, other, d) in inc[order[rm]]:
            if used >> ei & 1:
                continue
            jo = vmap.get(other)
            if jo is not None and jo in on_rpath:
                cands.append((_entry_key(rm, jo, d, edges[ei][2]), ei, -1, -1))
        # forward edges from any rightmost-path vertex to a new vertex
        for ridx in rpath:
            for (ei, other, d) in inc[order[ridx]]:
                if used >> ei & 1:
                    continue
                if other not in vmap:
                    cands.append((_entry_key(ridx, len(order), d,
                                             edges[ei][2]), ei, other, ridx))
        if not cands:
            return  # dead end: remaining edges unreachable under the rule
        cands.sort(key=lambda c: c[0])
        for (k, ei, newv, src) in cands:
            if best is not None:
                code.append(k)
                worse = code > best[:pos + 1]
                code.pop()
                if worse:
                    break  # candidates are sorted: the rest are worse too
            code.append(k)
            if newv >= 0:
                nvmap = dict(vmap)
                nvmap[newv] = len(order)
                cut = rpath.index(src) + 1
                search(order + (newv,), nvmap,
                       rpath[:cut] + (len(order),), used | (1 << ei), code)
            else:
                search(order, vmap, rpath, used | (1 << ei), code)
            code.pop()

    for v0 in range(n_vertices):
        if inc[v0]:
            search((v0,), {v0: 0}, (0,), 0, [])
    if best is None:
        raise ValueError("pattern is not weakly connected")
    return tuple(best)


# ---------------------------------------------------------------------------
# pattern index (paper: canonical DFS codes hashed into a table)
# ---------------------------------------------------------------------------

class PatternIndex:
    """Hash index: canonical code -> payloads (e.g. which ES stores it).

    This is the paper's "lightweight indexing mechanism": the executable
    vector E is built by O(1) lookups instead of subgraph-matching at
    scheduling time.
    """

    def __init__(self) -> None:
        self._table: dict[tuple, list] = {}

    def add(self, p: Pattern, payload) -> None:
        if not p.indexable:
            raise ValueError("non-indexable pattern (shared predicate vars)")
        self._table.setdefault(p.key, []).append(payload)

    def lookup(self, p: Pattern) -> list:
        if not p.indexable:
            return []
        return self._table.get(p.key, [])

    def lookup_query(self, q: QueryGraph) -> list:
        return self.lookup(pattern_of(q))

    def __contains__(self, p: Pattern) -> bool:
        return bool(self.lookup(p))

    def __len__(self) -> int:
        return len(self._table)
