"""Cypher-lite pattern parser.

Grammar (see README.md in this package for the prose version)::

    pattern := node (edge node)*
    node    := '(' [ident] [':' alts] [props] ')'
    edge    := '-' '[' body ']' '->'  |  '<-' '[' body ']' '-'
    body    := [ident] [':' alts] ['*' [bounds]] [props]
    bounds  := int | int '..' | int '..' int | '..' int
    alts    := value ('|' value)*
    props   := '{' pred (',' pred)* '}'
    pred    := ident op literal        ;  op ∈ {=, ==, !=, <, <=, >, >=}
    literal := number | quoted string | bareword

Hand-rolled recursive descent over a regex token stream — no parser
dependency, exact source positions in errors.  ``=`` normalizes to ``==``;
numeric literals become int/float so predicate masks compare natively
against the typed property columns.  ``*`` bounds mark variable-length
hops: ``*`` = 1..∞, ``*k`` = exactly k, ``*lo..hi``/``*lo..``/``*..hi``
with the missing end defaulting to 1 / ∞ (see README "Variable-length
hops").  Variable names must be unique across the whole pattern: a
repeated variable would read as an equality join, which the engine does
not implement — it is rejected here rather than silently mis-meaning.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple, Union

from repro_torch.query.ast import EdgePattern, NodePattern, Pattern, Predicate

__all__ = ["parse", "ParseError"]


class ParseError(ValueError):
    """Pattern syntax error, with position context."""


# NB ordering: arrows before comparison ops ('->' vs '>'), numbers before
# punct so a signed literal like '-3' beats the lone '-' edge dash.  A '<'
# immediately followed by '-' always reads as an incoming edge, so negative
# literals after '<' need a space: '{age < -3}'.
_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<arrow_in>\<\-)        # <-
      | (?P<arrow_out>\-\>)       # ->
      | (?P<dotdot>\.\.)          # range in '*lo..hi' (before number)
      | (?P<op>==|!=|<=|>=|=|<|>)
      | (?P<string>"[^"]*"|'[^']*')
      | (?P<number>[+-]?\d+\.(?!\.)\d*(?:[eE][+-]?\d+)?|[+-]?\.?\d+(?:[eE][+-]?\d+)?)
      | (?P<punct>[()\[\]{}:,|\-*])
      | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
    )""",
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Tuple[str, str, int]]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == m.start():
            rest = text[pos:].lstrip()
            if not rest:
                break
            raise ParseError(f"unexpected character {rest[0]!r} at position {pos} in {text!r}")
        kind = m.lastgroup
        toks.append((kind, m.group(kind), m.start(kind)))
        pos = m.end()
    return toks


class _Cursor:
    def __init__(self, text: str):
        self.text = text
        self.toks = _tokenize(text)
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str, int]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tuple[str, str, int]:
        tok = self.peek()
        if tok is None:
            raise ParseError(f"unexpected end of pattern in {self.text!r}")
        self.i += 1
        return tok

    def expect(self, value: str) -> None:
        kind, val, pos = self.next()
        if val != value:
            raise ParseError(
                f"expected {value!r} but found {val!r} at position {pos} in {self.text!r}"
            )

    def accept(self, value: str) -> bool:
        tok = self.peek()
        if tok is not None and tok[1] == value:
            self.i += 1
            return True
        return False


def _literal(cur: _Cursor) -> Union[int, float, str]:
    kind, val, pos = cur.next()
    if kind == "string":
        return val[1:-1]
    if kind == "number":
        return float(val) if any(c in val for c in ".eE") else int(val)
    if kind == "ident":
        return val
    raise ParseError(f"expected a literal, found {val!r} at position {pos} in {cur.text!r}")


def _alts(cur: _Cursor) -> Tuple[str, ...]:
    """``a|b|c`` after a ':' — attribute values, OR semantics (§VI)."""
    out = [str(_literal(cur))]
    while cur.accept("|"):
        out.append(str(_literal(cur)))
    return tuple(out)


def _props(cur: _Cursor) -> Tuple[Predicate, ...]:
    if not cur.accept("{"):
        return ()
    preds = []
    while True:
        kind, name, pos = cur.next()
        if kind != "ident":
            raise ParseError(
                f"expected property name, found {name!r} at position {pos} in {cur.text!r}"
            )
        kind, op, pos = cur.next()
        if kind != "op":
            raise ParseError(
                f"expected comparison operator, found {op!r} at position {pos} in {cur.text!r}"
            )
        preds.append(Predicate(name=name, op="==" if op == "=" else op, value=_literal(cur)))
        if cur.accept("}"):
            return tuple(preds)
        cur.expect(",")


def _entity_body(cur: _Cursor) -> Tuple[Optional[str], Tuple[str, ...]]:
    """Shared leading interior of node ``(...)`` and edge ``[...]``:
    optional variable, optional ``:alts``.  Props (and, for edges, the
    ``*`` bounds that precede them) are parsed by the callers."""
    var = None
    tok = cur.peek()
    if tok is not None and tok[0] == "ident":
        var = cur.next()[1]
    labels: Tuple[str, ...] = ()
    if cur.accept(":"):
        labels = _alts(cur)
    return var, labels


def _bound_int(cur: _Cursor) -> int:
    kind, val, pos = cur.next()
    if kind != "number" or not val.isdigit():
        raise ParseError(
            f"traversal bounds must be non-negative integers, found {val!r} "
            f"at position {pos} in {cur.text!r}"
        )
    return int(val)


def _star_bounds(cur: _Cursor) -> Tuple[int, Optional[int]]:
    """``*`` [bounds] after an edge's alts: (lo, hi), hi=None = unbounded."""
    if not cur.accept("*"):
        return 1, 1
    tok = cur.peek()
    if tok is not None and tok[0] == "number":
        lo = _bound_int(cur)
        if cur.accept(".."):
            tok = cur.peek()
            hi = _bound_int(cur) if tok is not None and tok[0] == "number" else None
        else:
            hi = lo  # '*k' — exactly k hops
    elif tok is not None and tok[0] == "dotdot":
        cur.next()
        lo, hi = 1, _bound_int(cur)  # '*..hi'
    else:
        lo, hi = 1, None  # bare '*'
    if hi is not None and hi < lo:
        raise ParseError(
            f"traversal upper bound below lower (*{lo}..{hi}) in {cur.text!r}"
        )
    return lo, hi


def _node(cur: _Cursor) -> NodePattern:
    cur.expect("(")
    var, labels = _entity_body(cur)
    preds = _props(cur)
    cur.expect(")")
    return NodePattern(var=var, labels=labels, predicates=preds)


def _edge(cur: _Cursor) -> EdgePattern:
    """``-[...]->`` or ``<-[...]-`` (the only two directed forms)."""
    kind, val, pos = cur.next()
    incoming = kind == "arrow_in"
    if not incoming and val != "-":
        raise ParseError(f"expected edge, found {val!r} at position {pos} in {cur.text!r}")
    cur.expect("[")
    var, rels = _entity_body(cur)
    lo, hi = _star_bounds(cur)
    preds = _props(cur)
    cur.expect("]")
    if incoming:
        cur.expect("-")
    else:
        kind, val, pos = cur.next()
        if kind != "arrow_out":
            raise ParseError(
                f"expected '->' closing an edge, found {val!r} at position {pos} "
                f"in {cur.text!r}"
            )
    return EdgePattern(var=var, rels=rels, predicates=preds,
                       direction=-1 if incoming else 1, lo=lo, hi=hi)


def parse(text: str) -> Pattern:
    """Parse a pattern string into a :class:`Pattern` AST.

    Raises ``ParseError`` on a repeated variable name: the engine does not
    implement equality joins, so ``(a)-[:r]->(a)`` would silently mean
    something different from what it reads as (see README).
    """
    cur = _Cursor(text)
    nodes = [_node(cur)]
    edges = []
    while cur.peek() is not None:
        edges.append(_edge(cur))
        nodes.append(_node(cur))
    seen = set()
    for ent in (*nodes, *edges):
        if ent.var is not None:
            if ent.var in seen:
                raise ParseError(
                    f"variable {ent.var!r} is bound more than once in {text!r}: "
                    "repeated variables would read as an equality join, which "
                    "this engine does not implement — use distinct names"
                )
            seen.add(ent.var)
    return Pattern(nodes=tuple(nodes), edges=tuple(edges))
