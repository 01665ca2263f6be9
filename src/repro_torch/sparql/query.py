"""SPARQL query parsing: BGP query graphs (paper Def. 2) + the extended
algebra grammar behind :class:`repro_torch.sparql.endpoint.SparqlEndpoint`.

A BGP query is a directed multigraph whose vertices are entity constants or
variables and whose edge labels are predicates (constant or variable) —
:class:`QueryGraph`. On top of that Def.-2 subset, :func:`parse_query`
understands the algebra surface compiled by
:mod:`repro_torch.sparql.algebra`:

- ``SELECT [DISTINCT] ?v ... | *`` and ``ASK`` query forms;
- group graph patterns with ``FILTER`` (comparisons ``= != < <= > >=``,
  ``&& || !``, ``BOUND(?v)``, ``REGEX(?v, "pat"[, "i"])``), ``OPTIONAL``
  groups, ``{ A } UNION { B }`` chains, nested groups, and inline
  ``VALUES`` data blocks (``VALUES ?v { t ... }`` and
  ``VALUES (?v ?w) { (t t) (UNDEF t) ... }``);
- solution modifiers ``ORDER BY [ASC|DESC](?v)``, ``LIMIT`` / ``OFFSET``.

Input is **tokenized first** (strings, IRIs, vars, numbers, prefixed names,
punctuation), so quoted literals containing ``.``, ``;``, ``?``, braces, or
whitespace can never break pattern splitting — the historical dot-split
parser mis-tokenized them (regression-tested in ``tests/test_algebra.py``).

:func:`parse_sparql` remains the stable BGP-only entry point: it accepts
exactly the Def.-2 subset (plain ``SELECT`` + triple patterns) and raises
:class:`ParseError` for algebra constructs, pointing callers at
:func:`parse_query` / ``SparqlEndpoint``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ..rdf.dictionary import Dictionary

VAR_S = -1  # sentinel id for "this position is a variable"


@dataclass(frozen=True)
class TriplePattern:
    """One edge of the query graph. Ids are dictionary ids or names for vars."""

    s: str | int   # int entity id (constant) or "?name"
    p: str | int   # int predicate id or "?name"
    o: str | int

    def variables(self) -> list[str]:
        return [t for t in (self.s, self.p, self.o)
                if isinstance(t, str)]


@dataclass
class QueryGraph:
    """A BGP query: triple patterns + projection list."""

    patterns: list[TriplePattern]
    projection: list[str]  # variable names; empty == SELECT *

    @property
    def variables(self) -> list[str]:
        seen: dict[str, None] = {}
        for tp in self.patterns:
            for v in tp.variables():
                seen.setdefault(v)
        return list(seen)

    @property
    def vertex_variables(self) -> list[str]:
        seen: dict[str, None] = {}
        for tp in self.patterns:
            for t in (tp.s, tp.o):
                if isinstance(t, str):
                    seen.setdefault(t)
        return list(seen)

    def n_edges(self) -> int:
        return len(self.patterns)

    # -- structural views used by pattern canonicalization ------------------
    def vertices(self) -> list[str | int]:
        seen: dict[str | int, None] = {}
        for tp in self.patterns:
            seen.setdefault(tp.s)
            seen.setdefault(tp.o)
        return list(seen)

    def edge_array(self) -> np.ndarray:
        """[E, 3] array over *local vertex indices*; predicate -2 if variable.

        Constants keep identity through a vertex table returned alongside by
        ``vertex_table``.
        """
        vmap = {v: i for i, v in enumerate(self.vertices())}
        out = np.zeros((len(self.patterns), 3), dtype=np.int64)
        for i, tp in enumerate(self.patterns):
            out[i, 0] = vmap[tp.s]
            out[i, 1] = -2 if isinstance(tp.p, str) else tp.p
            out[i, 2] = vmap[tp.o]
        return out

    def is_weakly_connected(self) -> bool:
        verts = self.vertices()
        if not verts:
            return True
        vmap = {v: i for i, v in enumerate(verts)}
        parent = list(range(len(verts)))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for tp in self.patterns:
            ra, rb = find(vmap[tp.s]), find(vmap[tp.o])
            if ra != rb:
                parent[ra] = rb
        return len({find(i) for i in range(len(verts))}) == 1


class ParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# FILTER expression AST (evaluated by repro_torch.sparql.algebra)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Operand:
    """A FILTER operand: a variable or a constant term.

    ``kind`` is ``"var"`` (``value`` holds ``?name``) or ``"term"``
    (``value`` holds the *decoded* term string — IRI text, literal text, or
    numeral). ``ent_id`` / ``pred_id`` carry the dictionary ids when the
    constant is known in the respective space (``None`` otherwise —
    FILTER constants need not exist in the graph, unlike triple constants).
    """

    kind: str
    value: str
    ent_id: int | None = None
    pred_id: int | None = None


@dataclass(frozen=True)
class Comparison:
    op: str          # one of = != < <= > >=
    lhs: Operand
    rhs: Operand


@dataclass(frozen=True)
class BoundExpr:
    var: str


@dataclass(frozen=True)
class RegexExpr:
    var: str
    pattern: str
    flags: str = ""


@dataclass(frozen=True)
class NotExpr:
    arg: object


@dataclass(frozen=True)
class AndExpr:
    args: tuple


@dataclass(frozen=True)
class OrExpr:
    args: tuple


# ---------------------------------------------------------------------------
# parsed-query AST
# ---------------------------------------------------------------------------


@dataclass
class GroupPattern:
    """One ``{ ... }`` group: an ordered element list.

    Elements are tagged tuples —
    ``("bgp", [TriplePattern, ...])``, ``("filter", expr)``,
    ``("optional", GroupPattern)``, ``("union", [GroupPattern, ...])``,
    ``("group", GroupPattern)``, ``("values", [var, ...], [row, ...])``
    where each VALUES row is a tuple of entity ids with ``None`` for
    ``UNDEF`` cells. Consecutive triple patterns accumulate into one
    ``"bgp"`` element (one BGP leaf after compilation).
    """

    elements: list = field(default_factory=list)

    def is_plain_bgp(self) -> bool:
        return (len(self.elements) == 1 and self.elements[0][0] == "bgp")


@dataclass
class ParsedQuery:
    """Syntax-level query AST (input to ``algebra.compile_query``)."""

    form: str                           # "select" | "ask"
    distinct: bool
    projection: list[str]               # [] == SELECT *
    where: GroupPattern
    order_by: list[tuple[str, bool]]    # (var, ascending)
    limit: int | None
    offset: int
    text: str = ""

    def is_plain_bgp_select(self) -> bool:
        """True iff this is exactly the Def.-2 subset ``parse_sparql`` covers."""
        return (self.form == "select" and not self.distinct
                and not self.order_by and self.limit is None
                and not self.offset and self.where.is_plain_bgp())


@dataclass
class ParsedUpdate:
    """Syntax-level SPARQL UPDATE AST (input to
    ``repro_torch.sparql.update.compile_update``).

    ``kind`` is ``"insert_data"``, ``"delete_data"``, or ``"delete_where"``.
    ``triples`` holds ``(s, p, o)`` tuples whose positions are tagged
    ``("term", text)`` for constants (prefix-expanded term strings, NOT
    dictionary ids — ``INSERT DATA`` may mention brand-new terms) or
    ``("var", "?name")`` (``delete_where`` only).
    """

    kind: str
    triples: list[tuple]
    text: str = ""


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+|\#[^\n]*)
    | (?P<string>"(?:[^"\\]|\\.)*")
    | (?P<iri><[^<>\s]*>)
    | (?P<var>\?\w+)
    | (?P<num>-?\d+(?:\.\d+)?)
    | (?P<pname>[A-Za-z_]\w*:[\w\-.]*)
    | (?P<name>[A-Za-z_]\w*)
    | (?P<op>&&|\|\||!=|<=|>=|[{}().,;=<>!*])
    """,
    re.VERBOSE,
)

_KEYWORDS = {"select", "ask", "where", "filter", "optional", "union",
             "distinct", "order", "by", "asc", "desc", "limit", "offset",
             "bound", "regex", "prefix", "insert", "delete", "data",
             "values", "undef"}


def _tokenize(text: str) -> list[tuple[str, str]]:
    """``(type, text)`` tokens; strings are recognized before any other
    syntax, so literal contents can never be split as punctuation."""
    out: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ParseError(f"cannot tokenize at: {text[pos:pos + 20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    return out


def _unquote(tok: str) -> str:
    return tok[1:-1].replace('\\"', '"').replace("\\\\", "\\")


# ---------------------------------------------------------------------------
# recursive-descent parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, text: str, dictionary: Dictionary) -> None:
        self.toks = _tokenize(text)
        self.pos = 0
        self.d = dictionary
        self.prefixes: dict[str, str] = {}

    # -- token helpers ------------------------------------------------------
    def peek(self, ahead: int = 0) -> tuple[str, str]:
        i = self.pos + ahead
        return self.toks[i] if i < len(self.toks) else ("eof", "")

    def next(self) -> tuple[str, str]:
        t = self.peek()
        self.pos += 1
        return t

    def at_keyword(self, *kws: str) -> bool:
        kind, txt = self.peek()
        return kind == "name" and txt.lower() in kws

    def expect_keyword(self, kw: str) -> None:
        if not self.at_keyword(kw):
            raise ParseError(f"expected {kw.upper()!r}, got {self.peek()[1]!r}")
        self.next()

    def expect_op(self, op: str) -> None:
        kind, txt = self.peek()
        if kind != "op" or txt != op:
            raise ParseError(f"expected {op!r}, got {txt!r}")
        self.next()

    def at_op(self, *ops: str) -> bool:
        kind, txt = self.peek()
        return kind == "op" and txt in ops

    # -- term decoding ------------------------------------------------------
    def _expand(self, kind: str, txt: str) -> str:
        """Token -> term string (IRI text / literal text / numeral)."""
        if kind == "iri":
            return txt[1:-1]
        if kind == "string":
            return _unquote(txt)
        if kind == "num":
            return txt
        if kind == "pname":
            pfx, _, local = txt.partition(":")
            if pfx not in self.prefixes:
                raise ParseError(f"unknown prefix {pfx!r}")
            return self.prefixes[pfx] + local
        raise ParseError(f"not a term: {txt!r}")

    def _decode_triple_term(self, position: str) -> str | int:
        kind, txt = self.next()
        if kind == "var":
            return txt
        term = self._expand(kind, txt)
        if position == "p":
            if not self.d.has_predicate(term):
                raise ParseError(f"unknown predicate {term!r}")
            return self.d.predicate_id(term)
        if not self.d.has_entity(term):
            raise ParseError(f"unknown entity {term!r}")
        return self.d.entity_id(term)

    # -- grammar ------------------------------------------------------------
    def parse_prologue(self) -> None:
        while self.at_keyword("prefix"):
            self.next()
            kind, txt = self.next()
            if kind != "pname" or not txt.endswith(":"):
                raise ParseError(f"bad PREFIX name {txt!r}")
            ikind, itxt = self.next()
            if ikind != "iri":
                raise ParseError(f"bad PREFIX IRI {itxt!r}")
            self.prefixes[txt[:-1]] = itxt[1:-1]

    def parse(self) -> ParsedQuery:
        self.parse_prologue()

        if self.at_keyword("ask"):
            self.next()
            form, distinct, projection = "ask", False, []
        elif self.at_keyword("select"):
            self.next()
            form = "select"
            distinct = False
            if self.at_keyword("distinct"):
                self.next()
                distinct = True
            projection = []
            if self.at_op("*"):
                self.next()
            else:
                while self.peek()[0] == "var":
                    projection.append(self.next()[1])
                if not projection:
                    raise ParseError("SELECT needs a projection (?vars or *)")
        else:
            raise ParseError("not a SELECT ... WHERE { ... } query")

        if self.at_keyword("where"):
            self.next()
        where = self.parse_group()

        order_by: list[tuple[str, bool]] = []
        limit: int | None = None
        offset = 0
        while self.peek()[0] != "eof":
            if self.at_keyword("order"):
                self.next()
                self.expect_keyword("by")
                while True:
                    if self.at_keyword("asc", "desc"):
                        asc = self.next()[1].lower() == "asc"
                        self.expect_op("(")
                        kind, var = self.next()
                        if kind != "var":
                            raise ParseError("ORDER BY key must be a ?var")
                        self.expect_op(")")
                        order_by.append((var, asc))
                    elif self.peek()[0] == "var":
                        order_by.append((self.next()[1], True))
                    else:
                        break
                if not order_by:
                    raise ParseError("empty ORDER BY")
            elif self.at_keyword("limit"):
                self.next()
                kind, txt = self.next()
                if kind != "num" or not txt.isdigit():
                    raise ParseError(f"LIMIT needs a non-negative integer, "
                                     f"got {txt!r}")
                limit = int(txt)
            elif self.at_keyword("offset"):
                self.next()
                kind, txt = self.next()
                if kind != "num" or not txt.isdigit():
                    raise ParseError(f"OFFSET needs a non-negative integer, "
                                     f"got {txt!r}")
                offset = int(txt)
            else:
                raise ParseError(f"trailing tokens: {self.peek()[1]!r}")
        if form == "ask" and (distinct or order_by or limit is not None
                              or offset):
            raise ParseError("ASK takes no solution modifiers")
        return ParsedQuery(form=form, distinct=distinct,
                           projection=projection, where=where,
                           order_by=order_by, limit=limit, offset=offset)

    def parse_group(self) -> GroupPattern:
        self.expect_op("{")
        g = GroupPattern()
        bgp: list[TriplePattern] = []

        def flush() -> None:
            if bgp:
                g.elements.append(("bgp", list(bgp)))
                bgp.clear()

        while True:
            if self.at_op("}"):
                self.next()
                flush()
                return g
            if self.peek()[0] == "eof":
                raise ParseError("unterminated group (missing '}')")
            if self.at_keyword("filter"):
                self.next()
                g.elements.append(("filter", self.parse_filter_expr()))
            elif self.at_keyword("values"):
                self.next()
                flush()
                g.elements.append(self.parse_values())
            elif self.at_keyword("optional"):
                self.next()
                flush()
                g.elements.append(("optional", self.parse_group()))
            elif self.at_op("{"):
                flush()
                branches = [self.parse_group()]
                while self.at_keyword("union"):
                    self.next()
                    branches.append(self.parse_group())
                g.elements.append(("union", branches) if len(branches) > 1
                                  else ("group", branches[0]))
            elif self.at_op("."):
                self.next()         # triple separator (also allowed trailing)
            else:
                s = self._decode_triple_term("s")
                p = self._decode_triple_term("p")
                o = self._decode_triple_term("o")
                bgp.append(TriplePattern(s, p, o))

    def parse_values(self) -> tuple:
        """``VALUES ?v { term ... }`` or ``VALUES (?v ...) { (term ...) ... }``.

        Terms resolve to entity ids at parse time (a VALUES binding naming a
        term the dictionary has never seen can match nothing anywhere — same
        contract as triple constants, and it keeps the inline table in the
        engine's id space). ``UNDEF`` cells become ``None`` (compiled to
        :data:`repro_torch.sparql.algebra.UNBOUND`, so they are compatible with
        any binding in the join).
        """
        vars_: list[str] = []
        grouped = self.at_op("(")
        if grouped:
            self.next()
            while self.peek()[0] == "var":
                vars_.append(self.next()[1])
            self.expect_op(")")
        elif self.peek()[0] == "var":
            vars_.append(self.next()[1])
        if not vars_:
            raise ParseError("VALUES needs ?vars")
        if len(set(vars_)) != len(vars_):
            raise ParseError("duplicate variable in VALUES")
        self.expect_op("{")
        rows: list[tuple] = []
        while not self.at_op("}"):
            if self.peek()[0] == "eof":
                raise ParseError("unterminated VALUES block (missing '}')")
            if grouped:
                self.expect_op("(")
                row: list[int | None] = []
                while not self.at_op(")"):
                    if self.peek()[0] == "eof":
                        raise ParseError("unterminated VALUES row "
                                         "(missing ')')")
                    row.append(self._values_cell())
                self.next()
                if len(row) != len(vars_):
                    raise ParseError(
                        f"VALUES row has {len(row)} terms for "
                        f"{len(vars_)} variables")
                rows.append(tuple(row))
            else:
                rows.append((self._values_cell(),))
        self.next()
        return ("values", vars_, rows)

    def _values_cell(self) -> int | None:
        if self.at_keyword("undef"):
            self.next()
            return None
        kind, txt = self.next()
        term = self._expand(kind, txt)
        if not self.d.has_entity(term):
            raise ParseError(f"unknown entity {term!r} in VALUES")
        return self.d.entity_id(term)

    # -- UPDATE grammar -----------------------------------------------------
    def parse_update(self) -> ParsedUpdate:
        """``PREFIX* (INSERT DATA | DELETE DATA | DELETE WHERE) { ... }``."""
        self.parse_prologue()
        if self.at_keyword("insert"):
            self.next()
            self.expect_keyword("data")
            kind = "insert_data"
        elif self.at_keyword("delete"):
            self.next()
            if self.at_keyword("data"):
                self.next()
                kind = "delete_data"
            elif self.at_keyword("where"):
                self.next()
                kind = "delete_where"
            else:
                raise ParseError("DELETE needs DATA { ... } or WHERE { ... }")
        else:
            raise ParseError("not an update (INSERT DATA / DELETE DATA / "
                             "DELETE WHERE)")
        triples = self.parse_data_block(allow_vars=(kind == "delete_where"))
        if self.peek()[0] != "eof":
            raise ParseError(f"trailing tokens: {self.peek()[1]!r}")
        if kind == "delete_where" and not triples:
            raise ParseError("DELETE WHERE needs at least one triple pattern")
        return ParsedUpdate(kind=kind, triples=triples)

    def parse_data_block(self, allow_vars: bool) -> list[tuple]:
        """``{ (term term term .)* }`` — terms stay prefix-expanded strings
        (no dictionary resolution: INSERT DATA may mint new terms)."""
        self.expect_op("{")
        triples: list[tuple] = []
        while True:
            if self.at_op("}"):
                self.next()
                return triples
            if self.peek()[0] == "eof":
                raise ParseError("unterminated data block (missing '}')")
            if self.at_op("."):
                self.next()         # triple separator (also allowed trailing)
                continue
            trip = []
            for _ in ("s", "p", "o"):
                kind, txt = self.next()
                if kind == "var":
                    if not allow_vars:
                        raise ParseError(
                            f"variables not allowed in ground data: {txt!r}")
                    trip.append(("var", txt))
                else:
                    trip.append(("term", self._expand(kind, txt)))
            triples.append(tuple(trip))

    # -- FILTER expressions -------------------------------------------------
    def parse_filter_expr(self):
        """``FILTER`` body: parenthesized expression or bare function call."""
        if self.at_op("("):
            self.next()
            e = self.parse_or()
            self.expect_op(")")
            return e
        if self.at_keyword("bound", "regex"):
            return self.parse_primary()
        raise ParseError("FILTER needs (expr), BOUND(...), or REGEX(...)")

    def parse_or(self):
        args = [self.parse_and()]
        while self.at_op("||"):
            self.next()
            args.append(self.parse_and())
        return args[0] if len(args) == 1 else OrExpr(tuple(args))

    def parse_and(self):
        args = [self.parse_unary()]
        while self.at_op("&&"):
            self.next()
            args.append(self.parse_unary())
        return args[0] if len(args) == 1 else AndExpr(tuple(args))

    def parse_unary(self):
        if self.at_op("!"):
            self.next()
            return NotExpr(self.parse_unary())
        return self.parse_primary()

    def parse_primary(self):
        if self.at_op("("):
            self.next()
            e = self.parse_or()
            self.expect_op(")")
            return e
        if self.at_keyword("bound"):
            self.next()
            self.expect_op("(")
            kind, var = self.next()
            if kind != "var":
                raise ParseError("BOUND takes a ?var")
            self.expect_op(")")
            return BoundExpr(var)
        if self.at_keyword("regex"):
            self.next()
            self.expect_op("(")
            kind, var = self.next()
            if kind != "var":
                raise ParseError("REGEX takes a ?var first")
            self.expect_op(",")
            pkind, ptxt = self.next()
            if pkind != "string":
                raise ParseError("REGEX pattern must be a string literal")
            flags = ""
            if self.at_op(","):
                self.next()
                fkind, ftxt = self.next()
                if fkind != "string":
                    raise ParseError("REGEX flags must be a string literal")
                flags = _unquote(ftxt)
            self.expect_op(")")
            return RegexExpr(var, _unquote(ptxt), flags)
        lhs = self.parse_operand()
        if self.at_op("=", "!=", "<", "<=", ">", ">="):
            op = self.next()[1]
            rhs = self.parse_operand()
            return Comparison(op, lhs, rhs)
        raise ParseError("bare FILTER operand is not a boolean expression")

    def parse_operand(self) -> Operand:
        kind, txt = self.next()
        if kind == "var":
            return Operand("var", txt)
        if kind in ("iri", "string", "num", "pname"):
            term = self._expand(kind, txt)
            return Operand(
                "term", term,
                ent_id=(self.d.entity_id(term)
                        if self.d.has_entity(term) else None),
                pred_id=(self.d.predicate_id(term)
                         if self.d.has_predicate(term) else None))
        raise ParseError(f"bad FILTER operand {txt!r}")


def parse_query(text: str, dictionary: Dictionary) -> ParsedQuery:
    """Parse the full supported SPARQL grammar into a :class:`ParsedQuery`.

    Constants in *triple* positions must exist in the dictionary (a query
    mentioning an unknown entity has no matches anywhere; the system routes
    on encoded ids) — unknown constants raise :class:`ParseError`. FILTER
    constants may be unknown (they compare by decoded term).
    Compile the result with :func:`repro_torch.sparql.algebra.compile_query`, or
    use :class:`repro_torch.sparql.endpoint.SparqlEndpoint` for the whole
    parse -> compile -> execute pipeline.
    """
    parsed = _Parser(text, dictionary).parse()
    parsed.text = text
    return parsed


_UPDATE_HEAD_RE = re.compile(
    r"^\s*(?:prefix\s+[A-Za-z_]\w*:[\w\-.]*\s*<[^<>\s]*>\s*)*(insert|delete)"
    r"\b", re.IGNORECASE)


def is_update_text(text: str) -> bool:
    """Cheap syntactic router: does ``text`` start an UPDATE request
    (after an optional PREFIX prologue) rather than a query?"""
    return _UPDATE_HEAD_RE.match(text) is not None


def parse_update(text: str, dictionary: Dictionary) -> ParsedUpdate:
    """Parse ``INSERT DATA`` / ``DELETE DATA`` / ``DELETE WHERE`` into a
    :class:`ParsedUpdate`.

    Constants are kept as prefix-expanded term *strings* — unlike query
    parsing, no dictionary lookup happens here, because ``INSERT DATA``
    legitimately mentions terms the dictionary has never seen. Resolution
    (and version bumps for new terms) happens in
    :func:`repro_torch.sparql.update.compile_update`.
    """
    p = _Parser(text, dictionary)
    parsed = p.parse_update()
    parsed.text = text
    return parsed


def parse_sparql(text: str, dictionary: Dictionary) -> QueryGraph:
    """Parse a plain BGP SELECT query (paper Def. 2) into a `QueryGraph`.

    This is the stable entry point of the original BGP-only engine — kept as
    a thin shim over :func:`parse_query`. Algebra constructs (FILTER /
    OPTIONAL / UNION / DISTINCT / ORDER BY / LIMIT / OFFSET / ASK) raise
    :class:`ParseError` here; route those through
    :class:`repro_torch.sparql.endpoint.SparqlEndpoint` (or
    ``parse_query`` + ``repro_torch.sparql.algebra.compile_query``).
    """
    parsed = parse_query(text, dictionary)
    if parsed.form == "select" and not parsed.where.elements:
        raise ParseError("empty WHERE block")
    if not parsed.is_plain_bgp_select():
        raise ParseError(
            "not a plain BGP SELECT query — algebra features (FILTER/"
            "OPTIONAL/UNION/DISTINCT/ORDER BY/LIMIT/OFFSET/ASK) need "
            "parse_query + repro_torch.sparql.algebra, or SparqlEndpoint")
    # is_plain_bgp_select guarantees exactly one non-empty "bgp" element
    return QueryGraph(patterns=list(parsed.where.elements[0][1]),
                      projection=list(parsed.projection))
