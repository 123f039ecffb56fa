"""A plain reader of the chain patterns the traffic sends.

    pattern := node (edge node)*
    node    := '(' [var] [':' name ('|' name)*] [props] ')'
    edge    := '-[' body ']->'  |  '<-[' body ']-'
    body    := [var] [':' name ('|' name)*] ['*' [lo] ['..' [hi]]] [props]
    props   := '{' prop op number (',' prop op number)* '}'

``*`` alone is 1..unbounded, ``*k`` exactly k.  Written for the benchmark's
reference; it shares no code with the program's parser.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_NODE = re.compile(r"\(\s*(?P<var>\w+)?\s*(?::(?P<alts>[\w|\s]+?))?\s*(?:\{(?P<props>[^}]*)\})?\s*\)")
_EDGE = re.compile(r"(?P<left><)?-\[\s*(?P<var>\w+)?\s*(?::(?P<alts>[\w|\s]+?))?\s*"
                   r"(?P<star>\*\s*(?P<lo>\d+)?\s*(?P<dots>\.\.)?\s*(?P<hi>\d+)?)?\s*"
                   r"(?:\{(?P<props>[^}]*)\})?\s*\]-(?P<right>>)?")
_PROP = re.compile(r"^\s*(\w+)\s*(==|!=|<=|>=|<|>)\s*([-+0-9.eE]+)\s*$")


@dataclass
class Part:
    var: str | None
    alts: tuple
    preds: tuple  # (name, op, value)


@dataclass
class Hop(Part):
    direction: int = 1  # +1 src→dst, -1 dst→src
    lo: int = 1
    hi: int | None = 1  # None: unbounded


@dataclass
class Chain:
    nodes: list = field(default_factory=list)
    hops: list = field(default_factory=list)


def _alts(text):
    return tuple(a.strip() for a in text.split("|")) if text else ()


def _preds(text):
    if not text:
        return ()
    out = []
    for item in text.split(","):
        m = _PROP.match(item)
        if m is None:
            raise ValueError(f"cannot read predicate {item!r}")
        num = m.group(3)
        out.append((m.group(1), m.group(2), float(num) if any(c in num for c in ".eE")
                    else int(num)))
    return tuple(out)


def parse(text: str) -> Chain:
    chain, pos = Chain(), 0
    while True:
        m = _NODE.match(text, pos)
        if m is None:
            raise ValueError(f"expected a node at {pos} in {text!r}")
        chain.nodes.append(Part(m.group("var"), _alts(m.group("alts")), _preds(m.group("props"))))
        pos = m.end()
        while pos < len(text) and text[pos].isspace():
            pos += 1
        if pos == len(text):
            return chain
        e = _EDGE.match(text, pos)
        if e is None or bool(e.group("left")) == bool(e.group("right")):
            raise ValueError(f"expected one directed edge at {pos} in {text!r}")
        lo, hi = 1, 1
        if e.group("star"):
            lo_t, hi_t = e.group("lo"), e.group("hi")
            if e.group("dots"):
                lo, hi = (int(lo_t) if lo_t else 1), (int(hi_t) if hi_t else None)
            elif lo_t:
                lo = hi = int(lo_t)
            else:
                lo, hi = 1, None
        chain.hops.append(Hop(e.group("var"), _alts(e.group("alts")), _preds(e.group("props")),
                              direction=-1 if e.group("left") else 1, lo=lo, hi=hi))
        pos = e.end()
