"""Pattern AST — the declarative layer above the §VI OR-mask queries.

A ``Pattern`` is a linear chain of ``NodePattern``s joined by
``EdgePattern``s (Cypher-lite paths).  Node labels and edge relationship
types keep the paper's OR semantics (``:a|b`` matches either attribute);
``Predicate``s are typed comparisons over the ``PropGraph`` property
columns.  Every node is AND-composed from its label mask and its predicate
masks; the chain itself is an AND across hops (conjunctive path query).

All AST classes are frozen dataclasses with a ``to_text()`` inverse of the
parser, so ``parse(p.to_text()) == p`` round-trips (property-tested).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

__all__ = ["Predicate", "NodePattern", "EdgePattern", "Pattern", "OPS"]

# comparison operators over typed property columns; "=" normalizes to "=="
OPS = ("==", "!=", "<=", ">=", "<", ">")


@dataclasses.dataclass(frozen=True)
class Predicate:
    """``name op value`` over a typed property column (e.g. ``age > 30``)."""

    name: str
    op: str  # one of OPS
    value: Union[int, float, str]

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {self.op!r}")

    def to_text(self) -> str:
        v = self.value
        v_txt = f'"{v}"' if isinstance(v, str) else repr(v)
        return f"{self.name} {self.op} {v_txt}"


@dataclasses.dataclass(frozen=True)
class NodePattern:
    """``(var:labelA|labelB {pred, ...})`` — labels OR'd, predicates AND'd."""

    var: Optional[str] = None
    labels: Tuple[str, ...] = ()
    predicates: Tuple[Predicate, ...] = ()

    def to_text(self) -> str:
        parts = [self.var or ""]
        if self.labels:
            parts.append(":" + "|".join(self.labels))
        if self.predicates:
            parts.append(" {" + ", ".join(p.to_text() for p in self.predicates) + "}")
        return "(" + "".join(parts) + ")"


@dataclasses.dataclass(frozen=True)
class EdgePattern:
    """``-[var:relA|relB {pred, ...}]->`` (direction=1) or ``<-[...]-`` (-1).

    ``direction`` is relative to the pattern's left-to-right reading:
    +1 means the DI edge points left→right, -1 right→left.

    ``lo``/``hi`` are the variable-length bounds (``-[:r*lo..hi]->``):
    the hop matches a walk of L ∈ [lo, hi] edges, every one holding the
    relationship/predicate constraints; intermediate vertices are
    unconstrained.  ``hi=None`` means unbounded (``*`` — executed to a
    fixed point).  The default (1, 1) is a plain fixed hop.
    """

    var: Optional[str] = None
    rels: Tuple[str, ...] = ()
    predicates: Tuple[Predicate, ...] = ()
    direction: int = 1
    lo: int = 1
    hi: Optional[int] = 1

    def __post_init__(self):
        if self.direction not in (1, -1):
            raise ValueError(f"direction must be ±1, got {self.direction}")
        if self.lo < 0:
            raise ValueError(f"traversal bounds must be ≥ 0, got lo={self.lo}")
        if self.hi is not None and self.hi < self.lo:
            raise ValueError(
                f"traversal upper bound below lower: *{self.lo}..{self.hi}")

    @property
    def is_fixed(self) -> bool:
        """True for a plain single hop (no ``*`` traversal)."""
        return self.lo == 1 and self.hi == 1

    def _star_text(self) -> str:
        if self.is_fixed:
            return ""
        if self.hi is None:
            return "*" if self.lo == 1 else f"*{self.lo}.."
        if self.lo == self.hi:
            return f"*{self.lo}"
        return f"*{self.lo}..{self.hi}"

    def to_text(self) -> str:
        parts = [self.var or ""]
        if self.rels:
            parts.append(":" + "|".join(self.rels))
        parts.append(self._star_text())
        if self.predicates:
            parts.append(" {" + ", ".join(p.to_text() for p in self.predicates) + "}")
        body = "[" + "".join(parts) + "]"
        return f"-{body}->" if self.direction == 1 else f"<-{body}-"


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A path pattern: ``nodes[0] edges[0] nodes[1] … edges[h-1] nodes[h]``."""

    nodes: Tuple[NodePattern, ...]
    edges: Tuple[EdgePattern, ...] = ()

    def __post_init__(self):
        if len(self.nodes) != len(self.edges) + 1:
            raise ValueError(
                f"path needs len(nodes) == len(edges)+1, got "
                f"{len(self.nodes)} nodes / {len(self.edges)} edges"
            )

    @property
    def hops(self) -> int:
        return len(self.edges)

    def to_text(self) -> str:
        out = [self.nodes[0].to_text()]
        for e, nd in zip(self.edges, self.nodes[1:]):
            out.append(e.to_text())
            out.append(nd.to_text())
        return "".join(out)

    def reversed(self) -> "Pattern":
        """The same pattern read right-to-left (edge directions flip).

        Semantically identical match set — the planner uses this to start
        constraint propagation from the more selective end.
        """
        nodes = tuple(reversed(self.nodes))
        edges = tuple(
            dataclasses.replace(e, direction=-e.direction) for e in reversed(self.edges)
        )
        return Pattern(nodes=nodes, edges=edges)
