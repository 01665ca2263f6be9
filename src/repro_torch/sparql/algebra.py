"""SPARQL algebra: logical operator trees compiled onto the BGP engine.

The paper's system (and everything built in PRs 1-4) executes *basic graph
patterns* — the Def.-2 subset. Real SPARQL engines layer an algebra on top
(Ali et al.'s survey of RDF stores; Perez/Arenas/Gutierrez's semantics):
FILTER selection, OPTIONAL left-joins, UNION, projection, DISTINCT, and
solution modifiers. This module adds that layer **without touching the hot
path**: a query compiles to a small operator tree whose leaves are whole
BGPs, each leaf executes through :class:`repro_torch.sparql.engine.QueryEngine`
(shard-parallel scans, scan/plan/result LRUs), and the operators combine
leaf binding tables with vectorized NumPy joins.

Operator tree (:func:`compile_query` lowers a
:class:`repro_torch.sparql.query.ParsedQuery`):

- :class:`BGPNode` — one BGP match per leaf. Leaves are executed *batched*
  (:func:`evaluate_many` collects every leaf of every query into ONE
  ``engine.execute_batch`` call), so alpha-equivalent sub-BGPs across
  queries share result-cache entries and identical scans dedup exactly as
  plain BGP batches do.
- :class:`JoinNode` / :class:`OptionalNode` — SPARQL compatibility
  (natural) join / left-join, vectorized as a sort/``searchsorted``
  equi-join over composite keys; rows with unbound shared variables
  (possible under nested OPTIONAL / UNION) join per bound-mask group.
- :class:`UnionNode` — column-aligned concatenation (multiset union).
- :class:`ValuesNode` — an inline solution table (``VALUES``): the parsed
  binding rows become a constant :class:`SolutionTable` (``UNDEF`` cells
  are :data:`UNBOUND`) joined into its group through the same vectorized
  compatibility join as any other operand — an UNDEF cell is compatible
  with every binding, exactly the bound-mask group-join semantics below.
- :class:`FilterNode` — vectorized row mask from the expression AST
  (:class:`~repro_torch.sparql.query.Comparison` / ``BOUND`` / ``REGEX`` /
  boolean connectives) over dictionary-decoded terms.
- :class:`ProjectNode`, :class:`DistinctNode`, :class:`OrderSliceNode`,
  :class:`AskNode` — solution modifiers and the ASK form.

**Semantics.** Solutions are the homomorphism multisets of the leaf BGPs
combined per Perez et al.'s compatibility semantics, with the documented
simplifications of the *well-designed* fragment: a FILTER inside an
OPTIONAL group applies to the optional side before the left-join, and
error-valued FILTER comparisons (unbound operands, type-mixed order
comparisons) evaluate to plain ``False`` (two-valued logic). Term order for
``< <= > >=`` and ORDER BY is numeric when both terms parse as numbers,
lexicographic otherwise, with unbound sorting first. A brute-force
reference evaluator in ``tests/test_algebra.py`` pins every operator
against these rules on both backends and both store kinds.

**Unbound cells.** Binding tables are dense ``int64`` with
:data:`UNBOUND` (= -1) marking cells OPTIONAL / UNION left unbound —
dictionary ids are non-negative, so the sentinel can never collide.

**Edge feasibility** is per-leaf: :func:`repro.core.pattern.
feasibility_patterns` certifies a tree edge-executable iff every *required*
BGP leaf's pattern is resident (OPTIONAL right sides excluded — they can
only add bindings, and an edge lacking them returns fewer optional
bindings, a documented relaxation; parity tests deploy optional leaves
too). The scheduler then routes algebra queries exactly like BGPs.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ..rdf.dictionary import Dictionary
from ..rdf.graph import RDFStore
from .matcher import MatchCapacityError, MatchResult
from .query import (AndExpr, BoundExpr, Comparison, GroupPattern, NotExpr,
                    Operand, OrExpr, ParseError, ParsedQuery, QueryGraph,
                    RegexExpr, TriplePattern)

UNBOUND = np.int64(-1)

_NUM_RE = re.compile(r"-?\d+(\.\d+)?\Z")


def _term_key(term: str):
    """Total order on decoded terms: numerals numerically first, then
    strings lexicographically (SPARQL's numeric/string split without the
    spec's full type ladder)."""
    if _NUM_RE.match(term):
        return (0, float(term), term)
    return (1, term)


# ---------------------------------------------------------------------------
# solution tables
# ---------------------------------------------------------------------------


@dataclass
class SolutionTable:
    """A SPARQL solution multiset: named columns of dictionary ids.

    ``bindings`` is ``[R, V]`` int64 with :data:`UNBOUND` for cells a
    solution does not bind. ``pred_vars`` names the variables bound in
    predicate-id space (everything else decodes as an entity).
    ``dictionary`` (when attached by the evaluator) enables term decoding.
    Duck-types the :class:`~repro_torch.sparql.matcher.MatchResult` surface the
    servers' cost accounting consumes (``num_matches``, ``result_bytes``).
    """

    var_names: list[str]
    bindings: np.ndarray
    pred_vars: frozenset = frozenset()
    dictionary: Dictionary | None = None

    @property
    def num_matches(self) -> int:
        return int(self.bindings.shape[0])

    def __len__(self) -> int:
        return self.num_matches

    def column(self, var: str) -> np.ndarray:
        return self.bindings[:, self.var_names.index(var)]

    def result_bytes(self, projection: list[str] | None = None) -> int:
        """Modeled result size: 8 bytes per binding cell (the table is
        already projected, so the argument is accepted only for
        :class:`MatchResult` signature compatibility)."""
        r, v = self.bindings.shape
        return int(r * max(1, v) * 8)

    def decode_term(self, var: str, vid: int) -> str | None:
        if vid < 0:
            return None
        if self.dictionary is None:
            raise ValueError("SolutionTable has no dictionary attached")
        return (self.dictionary.predicate(int(vid)) if var in self.pred_vars
                else self.dictionary.entity(int(vid)))

    def rows(self, decoded: bool = True) -> list[tuple]:
        """Solution rows in ``var_names`` order; unbound cells are ``None``
        when decoding, :data:`UNBOUND` otherwise."""
        if not decoded:
            return [tuple(int(x) for x in row) for row in self.bindings]
        cols = [self._decoded_column(v) for v in self.var_names]
        return list(zip(*cols)) if cols else [()] * self.num_matches

    def _decoded_column(self, var: str) -> list[str | None]:
        ids = self.column(var)
        uniq, inv = np.unique(ids, return_inverse=True)
        terms = [self.decode_term(var, int(u)) for u in uniq]
        return [terms[i] for i in inv]

    def take(self, idx: np.ndarray) -> "SolutionTable":
        return SolutionTable(self.var_names, self.bindings[idx],
                             self.pred_vars, self.dictionary)


def _unit_table() -> SolutionTable:
    return SolutionTable([], np.zeros((1, 0), dtype=np.int64))


def _from_match(res: MatchResult, pred_vars: frozenset) -> SolutionTable:
    # cached MatchResult buffers are shared read-only; SolutionTable
    # operations only ever index into them (never write in place)
    return SolutionTable(list(res.var_names), res.bindings, pred_vars)


# ---------------------------------------------------------------------------
# operator tree
# ---------------------------------------------------------------------------


class Node:
    """Base operator. ``projection`` on the root mirrors
    ``QueryGraph.projection`` so servers account result bytes uniformly
    (unannotated on purpose: it must not become a dataclass field)."""

    projection = ()

    def children(self) -> list["Node"]:
        return []

    def bgp_leaves(self, required_only: bool = False) -> list["BGPNode"]:
        """Leaf BGPs in evaluation order. ``required_only`` drops leaves
        under OPTIONAL right sides — the ones edge feasibility must not
        depend on (they only ever extend solutions)."""
        out: list[BGPNode] = []
        self._collect(out, required_only)
        return out

    def _collect(self, out: list, required_only: bool) -> None:
        for c in self.children():
            c._collect(out, required_only)

    def label(self) -> str:
        return type(self).__name__


@dataclass
class BGPNode(Node):
    """One BGP leaf — matched via the shard-parallel engine pipeline."""

    query: QueryGraph

    def children(self) -> list[Node]:
        return []

    def _collect(self, out: list, required_only: bool) -> None:
        out.append(self)

    @property
    def patterns(self) -> list[TriplePattern]:
        return self.query.patterns

    def label(self) -> str:
        return (f"BGP({len(self.patterns)} patterns, "
                f"vars={' '.join(self.query.variables) or '-'})")


@dataclass
class JoinNode(Node):
    left: Node
    right: Node

    def children(self) -> list[Node]:
        return [self.left, self.right]

    def label(self) -> str:
        return "Join"


@dataclass
class OptionalNode(Node):
    """SPARQL left-join: keep every left solution, extend where the right
    side matches compatibly."""

    left: Node
    right: Node

    def children(self) -> list[Node]:
        return [self.left, self.right]

    def _collect(self, out: list, required_only: bool) -> None:
        self.left._collect(out, required_only)
        if not required_only:
            self.right._collect(out, required_only)

    def label(self) -> str:
        return "Optional (left-join)"


@dataclass
class UnionNode(Node):
    branches: list[Node]

    def children(self) -> list[Node]:
        return list(self.branches)

    def label(self) -> str:
        return f"Union({len(self.branches)} branches)"


@dataclass
class ValuesNode(Node):
    """Inline bindings (``VALUES``): a constant solution multiset.

    ``rows`` is ``[R, V]`` int64 over ``var_names`` with :data:`UNBOUND`
    for ``UNDEF`` cells. Not a BGP leaf: it never reaches the engine, so
    edge feasibility ignores it (the inline table is part of the plan and
    travels with it to whichever server executes)."""

    var_names: list[str]
    rows: np.ndarray

    def children(self) -> list[Node]:
        return []

    def label(self) -> str:
        return (f"Values([{' '.join(self.var_names)}], "
                f"{len(self.rows)} rows)")


@dataclass
class FilterNode(Node):
    child: Node
    expr: object

    def children(self) -> list[Node]:
        return [self.child]

    def label(self) -> str:
        return f"Filter {format_expr(self.expr)}"


@dataclass
class ProjectNode(Node):
    child: Node
    projection: list[str]

    def children(self) -> list[Node]:
        return [self.child]

    def label(self) -> str:
        return f"Project [{' '.join(self.projection) or '*'}]"


@dataclass
class DistinctNode(Node):
    """Dedup on ``on`` columns (``None`` = all), keeping first occurrence.

    Compiled *below* the final projection with ``on`` = the projection
    list, which is exactly SELECT DISTINCT's semantics."""

    child: Node
    on: list[str] | None = None

    def children(self) -> list[Node]:
        return [self.child]

    def label(self) -> str:
        return f"Distinct on=[{' '.join(self.on) if self.on else '*'}]"


@dataclass
class OrderSliceNode(Node):
    """ORDER BY + LIMIT/OFFSET (order applied first, then the slice)."""

    child: Node
    order: list[tuple[str, bool]] = field(default_factory=list)
    limit: int | None = None
    offset: int = 0

    def children(self) -> list[Node]:
        return [self.child]

    def label(self) -> str:
        keys = " ".join(f"{v}{'' if asc else ' DESC'}"
                        for v, asc in self.order)
        parts = [p for p in (
            f"order=[{keys}]" if self.order else "",
            f"limit={self.limit}" if self.limit is not None else "",
            f"offset={self.offset}" if self.offset else "") if p]
        return f"OrderSlice {' '.join(parts) or '(noop)'}"


@dataclass
class AskNode(Node):
    """ASK form: evaluates to a 0/1-row zero-column table (truthiness)."""

    child: Node

    def children(self) -> list[Node]:
        return [self.child]

    def label(self) -> str:
        return "Ask"


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------


def compile_query(parsed: ParsedQuery,
                  dictionary: Dictionary | None = None) -> Node:
    """Lower a :class:`~repro_torch.sparql.query.ParsedQuery` to an operator tree.

    Pipeline (inside-out): WHERE group -> DISTINCT (on the projection) ->
    ORDER BY + LIMIT/OFFSET -> projection (or ASK). The returned root
    carries ``dictionary`` (FILTER/ORDER term decoding), ``parsed``, and
    ``projection`` so it travels self-contained through servers and pools.
    """
    node = _compile_group(parsed.where)
    if parsed.form == "ask":
        root: Node = AskNode(node)
    else:
        if parsed.distinct:
            node = DistinctNode(node, list(parsed.projection) or None)
        if parsed.order_by or parsed.limit is not None or parsed.offset:
            node = OrderSliceNode(node, list(parsed.order_by),
                                  parsed.limit, parsed.offset)
        root = ProjectNode(node, list(parsed.projection))
    root.dictionary = dictionary
    root.parsed = parsed
    ent_vars: set[str] = set()
    pred_vars: set[str] = set()
    for leaf in root.bgp_leaves():
        for tp in leaf.patterns:
            for t in (tp.s, tp.o):
                if isinstance(t, str):
                    ent_vars.add(t)
            if isinstance(tp.p, str):
                pred_vars.add(tp.p)
    # VALUES cells are resolved in entity-id space at parse time, so their
    # variables are entity-space by construction
    for vn in _values_nodes(root):
        ent_vars.update(vn.var_names)
    mixed = ent_vars & pred_vars
    if mixed:
        # entity and predicate ids live in disjoint spaces; a column mixing
        # them cannot be decoded (FILTER/ORDER/rows would read the wrong
        # dictionary) — reject at compile time instead of mis-decoding
        raise ParseError(
            f"variable(s) {sorted(mixed)} appear in both predicate and "
            f"subject/object positions — unsupported (dictionary id spaces "
            f"are disjoint)")
    root.pred_vars = frozenset(pred_vars)
    return root


def _values_nodes(node: Node) -> list["ValuesNode"]:
    out = [node] if isinstance(node, ValuesNode) else []
    for c in node.children():
        out += _values_nodes(c)
    return out


def _compile_group(g: GroupPattern) -> Node:
    node: Node | None = None
    filters: list = []

    def join(a: Node | None, b: Node) -> Node:
        return b if a is None else JoinNode(a, b)

    for el in g.elements:
        tag = el[0]
        if tag == "bgp":
            node = join(node, BGPNode(QueryGraph(patterns=list(el[1]),
                                                 projection=[])))
        elif tag == "filter":
            filters.append(el[1])
        elif tag == "optional":
            left = node if node is not None else BGPNode(QueryGraph([], []))
            node = OptionalNode(left, _compile_group(el[1]))
        elif tag == "union":
            node = join(node, UnionNode([_compile_group(b) for b in el[1]]))
        elif tag == "group":
            node = join(node, _compile_group(el[1]))
        elif tag == "values":
            var_names, raw = el[1], el[2]
            rows = np.full((len(raw), len(var_names)), UNBOUND,
                           dtype=np.int64)
            for i, row in enumerate(raw):
                for j, cell in enumerate(row):
                    if cell is not None:
                        rows[i, j] = cell
            node = join(node, ValuesNode(list(var_names), rows))
        else:  # pragma: no cover - parser emits only the tags above
            raise ValueError(f"unknown group element {tag!r}")
    if node is None:
        node = BGPNode(QueryGraph([], []))
    for f in filters:
        node = FilterNode(node, f)
    return node


def is_algebra_plan(q) -> bool:
    """True for compiled operator trees (vs plain :class:`QueryGraph`)."""
    return isinstance(q, Node)


# ---------------------------------------------------------------------------
# vectorized joins
# ---------------------------------------------------------------------------


def _equi_pairs(lk: np.ndarray, rk: np.ndarray, budget: int,
                ) -> tuple[np.ndarray, np.ndarray]:
    """(left_idx, right_idx) of all key-equal pairs; composite keys are
    encoded to dense codes via one ``np.unique`` over both sides, then
    expanded with a sorted ``searchsorted`` probe. ``budget`` caps the
    produced pairs (:class:`MatchCapacityError` beyond it)."""
    nl, nr = len(lk), len(rk)
    if nl == 0 or nr == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    if lk.shape[1] == 0:               # no join columns: full product
        total = nl * nr
        if total > budget:
            raise MatchCapacityError(f"join would produce {total} rows")
        return (np.repeat(np.arange(nl, dtype=np.int64), nr),
                np.tile(np.arange(nr, dtype=np.int64), nl))
    _, inv = np.unique(np.concatenate([lk, rk]), axis=0, return_inverse=True)
    lcode, rcode = inv[:nl], inv[nl:]
    order = np.argsort(rcode, kind="stable")
    rsorted = rcode[order]
    lo = np.searchsorted(rsorted, lcode, side="left")
    hi = np.searchsorted(rsorted, lcode, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total > budget:
        raise MatchCapacityError(f"join would produce {total} rows")
    if not total:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    li = np.repeat(np.arange(nl, dtype=np.int64), counts)
    within = (np.arange(total, dtype=np.int64)
              - np.repeat(np.cumsum(counts) - counts, counts))
    return li, order[np.repeat(lo, counts) + within]


def _join_tables(L: SolutionTable, R: SolutionTable, how: str,
                 max_rows: int) -> SolutionTable:
    """Compatibility (natural) join of two solution tables.

    ``how``: ``"inner"`` (Join) or ``"left"`` (Optional / left-join).
    Shared variables join by equality over cells bound on BOTH sides; a
    cell unbound on one side is compatible with anything and the merged row
    takes the bound value (Perez et al.'s compatibility). Fully-bound
    inputs (the common case — BGP leaves bind everything) take a single
    vectorized equi-join; otherwise rows group by their bound-mask pattern
    and each group pair joins on its mutually-bound columns.
    """
    shared = [v for v in L.var_names if v in R.var_names]
    right_only = [v for v in R.var_names if v not in L.var_names]
    li_idx = [L.var_names.index(v) for v in shared]
    ri_idx = [R.var_names.index(v) for v in shared]
    ro_idx = [R.var_names.index(v) for v in right_only]
    lk_all = L.bindings[:, li_idx]
    rk_all = R.bindings[:, ri_idx]
    lmask = lk_all != UNBOUND
    rmask = rk_all != UNBOUND

    if lmask.all() and rmask.all():
        li, ri = _equi_pairs(lk_all, rk_all, max_rows)
        fill = False
    else:
        # group rows by bound-mask pattern; for each (left, right) group
        # pair join on the columns bound in BOTH masks — the remaining
        # shared columns are unbound on one side, hence compatible
        lpat, linv = np.unique(lmask, axis=0, return_inverse=True)
        rpat, rinv = np.unique(rmask, axis=0, return_inverse=True)
        lis: list[np.ndarray] = []
        ris: list[np.ndarray] = []
        budget = max_rows
        for a in range(len(lpat)):
            lrows = np.flatnonzero(linv == a)
            for b in range(len(rpat)):
                rrows = np.flatnonzero(rinv == b)
                both = lpat[a] & rpat[b]
                gl, gr = _equi_pairs(lk_all[lrows][:, both],
                                     rk_all[rrows][:, both], budget)
                budget = max(budget - len(gl), 0)
                lis.append(lrows[gl])
                ris.append(rrows[gr])
        li = (np.concatenate(lis) if lis
              else np.zeros(0, dtype=np.int64))
        ri = (np.concatenate(ris) if ris
              else np.zeros(0, dtype=np.int64))
        fill = True

    out_vars = L.var_names + right_only
    blocks = [L.bindings[li]]
    if ro_idx:
        blocks.append(R.bindings[ri][:, ro_idx])
    out = np.concatenate(blocks, axis=1) if len(blocks) > 1 else blocks[0]
    if out.base is not None or out is L.bindings:
        out = out.copy()               # cached leaf buffers are read-only
    if fill and shared:
        # shared cells unbound on the left take the right side's binding
        for ci, rci in zip(range(len(shared)), ri_idx):
            col = out[:, li_idx[ci]]
            need = col == UNBOUND
            if need.any():
                col[need] = R.bindings[ri[need], rci]

    if how == "left":
        matched = np.zeros(len(L.bindings), dtype=bool)
        matched[li] = True
        rest = np.flatnonzero(~matched)
        if len(rest):
            pad = np.full((len(rest), len(right_only)), UNBOUND,
                          dtype=np.int64)
            lone = np.concatenate([L.bindings[rest], pad], axis=1)
            out = np.concatenate([out, lone], axis=0)
    return SolutionTable(out_vars, out, L.pred_vars | R.pred_vars,
                         L.dictionary or R.dictionary)


def _union_tables(tables: list[SolutionTable]) -> SolutionTable:
    var_names: list[str] = []
    for t in tables:
        for v in t.var_names:
            if v not in var_names:
                var_names.append(v)
    blocks = []
    for t in tables:
        block = np.full((t.num_matches, len(var_names)), UNBOUND,
                        dtype=np.int64)
        for j, v in enumerate(var_names):
            if v in t.var_names:
                block[:, j] = t.column(v)
        blocks.append(block)
    out = (np.concatenate(blocks, axis=0) if blocks
           else np.zeros((0, len(var_names)), dtype=np.int64))
    pv = frozenset().union(*(t.pred_vars for t in tables))
    d = next((t.dictionary for t in tables if t.dictionary is not None), None)
    return SolutionTable(var_names, out, pv, d)


# ---------------------------------------------------------------------------
# FILTER expression evaluation (vectorized)
# ---------------------------------------------------------------------------


def _decode_uniques(uniq: np.ndarray, space: str,
                    d: Dictionary) -> list[str | None]:
    return [None if u < 0
            else (d.predicate(int(u)) if space == "pred"
                  else d.entity(int(u)))
            for u in uniq]


def _operand_info(op: Operand, table: SolutionTable):
    """-> ("var", ids, bound_mask, space) | ("const", term, id_in_space)."""
    if op.kind == "var":
        if op.value not in table.var_names:
            r = table.num_matches
            return ("var", np.full(r, UNBOUND), np.zeros(r, dtype=bool), "ent")
        ids = table.column(op.value)
        space = "pred" if op.value in table.pred_vars else "ent"
        return ("var", ids, ids != UNBOUND, space)
    return ("const", op.value, None)


_CMP = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}


def compare_terms(op: str, a: str, b: str) -> bool:
    """Scalar comparison over decoded terms (the single definition both the
    vectorized evaluator and the tests' brute-force reference use)."""
    if op in ("=", "!="):
        return _CMP[op](a, b)
    return _CMP[op](_term_key(a), _term_key(b))


def _eval_comparison(c: Comparison, table: SolutionTable,
                     d: Dictionary | None) -> np.ndarray:
    r = table.num_matches
    left = _operand_info(c.lhs, table)
    right = _operand_info(c.rhs, table)
    if left[0] == "const" and right[0] == "const":
        return np.full(r, compare_terms(c.op, left[1], right[1]))

    if left[0] == "const":             # normalize: variable on the left
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
        c = Comparison(flip.get(c.op, c.op), c.rhs, c.lhs)
        left, right = right, left

    _, ids, bound, space = left
    if right[0] == "const":
        term = right[1]
        if c.op in ("=", "!="):
            # id fast path: dictionary encoding is bijective per space
            cid = (c.rhs.pred_id if space == "pred" else c.rhs.ent_id)
            if cid is None:            # unknown constant: no bound id equals
                return (bound & False) if c.op == "=" else bound.copy()
            eq = ids == cid
            return (eq & bound) if c.op == "=" else (~eq & bound)
        if d is None:
            raise ValueError("order comparison needs a dictionary")
        uniq, inv = np.unique(ids, return_inverse=True)
        terms = _decode_uniques(uniq, space, d)
        per = np.array([False if t is None else compare_terms(c.op, t, term)
                        for t in terms], dtype=bool)
        return per[inv] & bound
    _, rids, rbound, rspace = right
    both = bound & rbound
    if space == rspace:
        if c.op in ("=", "!="):
            eq = ids == rids
            return (eq & both) if c.op == "=" else (~eq & both)
        if d is None:
            raise ValueError("order comparison needs a dictionary")
        # rank both columns' ids on ONE term-key order, then compare the
        # int ranks vectorized (term keys are injective per space, so rank
        # order == term order); unbound rows are masked by ``both``
        allu = np.unique(np.concatenate([ids, rids]))
        keys = [(0,) if t is None else (1, _term_key(t))
                for t in _decode_uniques(allu, space, d)]
        rank = np.empty(len(allu), dtype=np.int64)
        rank[sorted(range(len(allu)), key=keys.__getitem__)] = \
            np.arange(len(allu))
        lrank = rank[np.searchsorted(allu, ids)]
        rrank = rank[np.searchsorted(allu, rids)]
        return _CMP[c.op](lrank, rrank) & both
    if d is None:
        raise ValueError("cross-space comparison needs a dictionary")
    lu, li = np.unique(ids, return_inverse=True)
    ru_, ri = np.unique(rids, return_inverse=True)
    lt = _decode_uniques(lu, space, d)
    rt = _decode_uniques(ru_, rspace, d)
    return np.fromiter(
        (bool(b) and compare_terms(c.op, lt[a1], rt[b1])
         for a1, b1, b in zip(li, ri, both)), dtype=bool, count=r)


def eval_expr_mask(expr, table: SolutionTable,
                   d: Dictionary | None) -> np.ndarray:
    """Row mask for a FILTER expression (two-valued: errors are False)."""
    r = table.num_matches
    if isinstance(expr, Comparison):
        return _eval_comparison(expr, table, d)
    if isinstance(expr, BoundExpr):
        if expr.var not in table.var_names:
            return np.zeros(r, dtype=bool)
        return table.column(expr.var) != UNBOUND
    if isinstance(expr, RegexExpr):
        if expr.var not in table.var_names:
            return np.zeros(r, dtype=bool)
        if d is None:
            raise ValueError("REGEX needs a dictionary")
        ids = table.column(expr.var)
        space = "pred" if expr.var in table.pred_vars else "ent"
        flags = re.IGNORECASE if "i" in expr.flags else 0
        rx = re.compile(expr.pattern, flags)
        uniq, inv = np.unique(ids, return_inverse=True)
        per = np.array([t is not None and rx.search(t) is not None
                        for t in _decode_uniques(uniq, space, d)],
                       dtype=bool)
        return per[inv]
    if isinstance(expr, NotExpr):
        return ~eval_expr_mask(expr.arg, table, d)
    if isinstance(expr, AndExpr):
        m = eval_expr_mask(expr.args[0], table, d)
        for a in expr.args[1:]:
            m = m & eval_expr_mask(a, table, d)
        return m
    if isinstance(expr, OrExpr):
        m = eval_expr_mask(expr.args[0], table, d)
        for a in expr.args[1:]:
            m = m | eval_expr_mask(a, table, d)
        return m
    raise TypeError(f"unknown FILTER expression {expr!r}")


def format_expr(expr) -> str:
    if isinstance(expr, Comparison):
        def f(o: Operand) -> str:
            return o.value if o.kind == "var" else repr(o.value)
        return f"({f(expr.lhs)} {expr.op} {f(expr.rhs)})"
    if isinstance(expr, BoundExpr):
        return f"BOUND({expr.var})"
    if isinstance(expr, RegexExpr):
        fl = f", {expr.flags!r}" if expr.flags else ""
        return f"REGEX({expr.var}, {expr.pattern!r}{fl})"
    if isinstance(expr, NotExpr):
        return f"!{format_expr(expr.arg)}"
    if isinstance(expr, AndExpr):
        return "(" + " && ".join(format_expr(a) for a in expr.args) + ")"
    if isinstance(expr, OrExpr):
        return "(" + " || ".join(format_expr(a) for a in expr.args) + ")"
    return repr(expr)


# ---------------------------------------------------------------------------
# solution modifiers
# ---------------------------------------------------------------------------


def _order_table(table: SolutionTable, keys: list[tuple[str, bool]],
                 d: Dictionary | None) -> SolutionTable:
    if not keys or table.num_matches <= 1:
        return table
    if d is None:
        raise ValueError("ORDER BY needs a dictionary")
    ranks = []
    for var, asc in keys:
        if var not in table.var_names:
            continue                   # constant key: no effect
        ids = table.column(var)
        space = "pred" if var in table.pred_vars else "ent"
        uniq, inv = np.unique(ids, return_inverse=True)
        terms = _decode_uniques(uniq, space, d)
        order = sorted(range(len(uniq)),
                       key=lambda i: ((0,) if terms[i] is None
                                      else (1, _term_key(terms[i]))))
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[order] = np.arange(len(uniq))
        col = rank[inv]
        ranks.append(col if asc else -col)
    if not ranks:
        return table
    idx = np.lexsort(tuple(reversed(ranks)))   # first key = primary
    return table.take(idx)


def _distinct_table(table: SolutionTable,
                    on: list[str] | None) -> SolutionTable:
    cols = [v for v in (on or table.var_names) if v in table.var_names]
    if table.num_matches <= 1:
        return table
    sub = (table.bindings[:, [table.var_names.index(v) for v in cols]]
           if cols else np.zeros((table.num_matches, 0), dtype=np.int64))
    if sub.shape[1] == 0:
        return table.take(np.zeros(1, dtype=np.int64))
    _, first = np.unique(sub, axis=0, return_index=True)
    return table.take(np.sort(first))


def _project_table(table: SolutionTable,
                   projection: list[str]) -> SolutionTable:
    if not projection:
        return table
    r = table.num_matches
    cols = []
    for v in projection:
        cols.append(table.column(v) if v in table.var_names
                    else np.full(r, UNBOUND))
    out = (np.stack(cols, axis=1) if cols
           else np.zeros((r, 0), dtype=np.int64))
    return SolutionTable(list(projection), out, table.pred_vars,
                         table.dictionary)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _eval(node: Node, leaf_results: dict[int, MatchResult], engine,
          d: Dictionary | None, pred_vars: frozenset,
          max_rows: int) -> SolutionTable:
    if isinstance(node, BGPNode):
        if not node.patterns:
            t = _unit_table()
        else:
            t = _from_match(leaf_results[id(node)], pred_vars)
        t.dictionary = d
        return t
    if isinstance(node, ValuesNode):
        if engine is not None:
            engine.bump_stats(values_joins=1)
        return SolutionTable(list(node.var_names), node.rows,
                             dictionary=d)
    if isinstance(node, JoinNode):
        return _join_tables(
            _eval(node.left, leaf_results, engine, d, pred_vars, max_rows),
            _eval(node.right, leaf_results, engine, d, pred_vars, max_rows),
            "inner", max_rows)
    if isinstance(node, OptionalNode):
        out = _join_tables(
            _eval(node.left, leaf_results, engine, d, pred_vars, max_rows),
            _eval(node.right, leaf_results, engine, d, pred_vars, max_rows),
            "left", max_rows)
        if engine is not None:
            engine.bump_stats(optional_joins=1)
        return out
    if isinstance(node, UnionNode):
        tabs = [_eval(b, leaf_results, engine, d, pred_vars, max_rows)
                for b in node.branches]
        if engine is not None:
            engine.bump_stats(union_branches=len(tabs))
        return _union_tables(tabs)
    if isinstance(node, FilterNode):
        t = _eval(node.child, leaf_results, engine, d, pred_vars, max_rows)
        if engine is not None:
            engine.bump_stats(filters_applied=1)
        return t.take(np.flatnonzero(eval_expr_mask(node.expr, t, d)))
    if isinstance(node, ProjectNode):
        return _project_table(
            _eval(node.child, leaf_results, engine, d, pred_vars, max_rows),
            node.projection)
    if isinstance(node, DistinctNode):
        return _distinct_table(
            _eval(node.child, leaf_results, engine, d, pred_vars, max_rows),
            node.on)
    if isinstance(node, OrderSliceNode):
        t = _order_table(
            _eval(node.child, leaf_results, engine, d, pred_vars, max_rows),
            node.order, d)
        lo = max(0, node.offset)
        hi = None if node.limit is None else lo + max(0, node.limit)
        return t.take(np.arange(t.num_matches)[lo:hi])
    if isinstance(node, AskNode):
        t = _eval(node.child, leaf_results, engine, d, pred_vars, max_rows)
        n = 1 if t.num_matches else 0
        return SolutionTable([], np.zeros((n, 0), dtype=np.int64),
                             dictionary=d)
    raise TypeError(f"unknown algebra node {node!r}")


def evaluate_many(roots: list[Node], store: RDFStore, engine,
                  max_rows: int | None = None) -> list[SolutionTable]:
    """Evaluate compiled plans against ``store``; results align by index.

    ALL leaf BGPs across the batch execute as ONE
    ``engine.execute_batch`` call — identical scans dedup across queries
    and alpha-equivalent sub-BGPs share result-cache entries exactly like
    plain BGP batches (the core cache-reuse property of the algebra
    layer). The all-plans special case of :func:`execute_any_batch`.
    """
    return execute_any_batch(store, engine, roots, max_rows)


def evaluate_plan(root: Node, store: RDFStore, engine,
                  max_rows: int | None = None) -> SolutionTable:
    """Evaluate one compiled plan (see :func:`evaluate_many`)."""
    return evaluate_many([root], store, engine, max_rows)[0]


def execute_any_batch(store: RDFStore, engine, queries: list,
                      max_rows: int | None = None) -> list:
    """Execute a mixed batch of plain :class:`QueryGraph`\\ s and compiled
    algebra plans; results align by index (``MatchResult`` for BGPs,
    :class:`SolutionTable` for plans).

    Plain BGPs and every plan's leaf BGPs go through ONE
    ``engine.execute_batch`` call, so scan dedup and result-cache sharing
    span the whole mixed batch — this is what the servers
    (:mod:`repro.edge.server`) and the serving pool runner
    (:func:`repro.runtime.serving.make_sparql_runner`) call.
    """
    plans = [(i, q) for i, q in enumerate(queries) if is_algebra_plan(q)]
    plain = [(i, q) for i, q in enumerate(queries) if not is_algebra_plan(q)]
    leaves: list[BGPNode] = []
    for _, root in plans:
        leaves += [l for l in root.bgp_leaves() if l.patterns]
    batch = [q for _, q in plain] + [l.query for l in leaves]
    results = engine.execute_batch(store, batch) if batch else []
    if leaves:
        engine.bump_stats(bgp_leaves=len(leaves))
    out: list = [None] * len(queries)
    for (i, _), res in zip(plain, results[:len(plain)]):
        out[i] = res
    lookup = dict(zip(map(id, leaves), results[len(plain):]))
    cap = int(max_rows if max_rows is not None
              else getattr(engine, "max_rows", 5_000_000))
    for i, root in plans:
        d = getattr(root, "dictionary", None)
        pv = getattr(root, "pred_vars", frozenset())
        out[i] = _eval(root, lookup, engine, d, pv, cap)
    return out


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------


def explain_plan(root: Node, store: RDFStore | None = None,
                 engine=None) -> str:
    """Pretty-print an operator tree; with ``store`` + ``engine``, each BGP
    leaf line carries cache-hit provenance (result cache, scan LRU) and the
    estimated cardinality — what an admission layer reads before batching.
    """
    lines: list[str] = []

    def leaf_note(leaf: BGPNode) -> str:
        if store is None or not leaf.patterns:
            return ""
        bits = []
        from .matcher import estimate_pattern_cardinality
        est = max(estimate_pattern_cardinality(store, tp)
                  for tp in leaf.patterns)
        bits.append(f"est_rows<={est:.0f}")
        if engine is not None:
            probe = engine.cache_probe(store, leaf.query)
            hit = "hit" if probe["result_cached"] else "miss"
            bits.append(f"result-cache={hit}")
            bits.append(f"scans-cached={probe['scans_cached']}"
                        f"/{probe['scans_total']}")
        return "  [" + ", ".join(bits) + "]"

    def walk(node: Node, prefix: str, is_last: bool, is_root: bool) -> None:
        branch = "" if is_root else ("└─ " if is_last else "├─ ")
        note = leaf_note(node) if isinstance(node, BGPNode) else ""
        lines.append(prefix + branch + node.label() + note)
        kids = node.children()
        child_prefix = prefix if is_root else (
            prefix + ("   " if is_last else "│  "))
        for i, c in enumerate(kids):
            walk(c, child_prefix, i == len(kids) - 1, False)

    walk(root, "", True, True)
    return "\n".join(lines)
