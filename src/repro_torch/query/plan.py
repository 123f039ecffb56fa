"""Query plans — the bridge between the pattern AST and mask execution.

A ``Plan`` is a flat list of mask-producing steps plus chain metadata.  Each
``MaskStep`` records which DIP implementation the planner chose (`matvec`,
`scan`, `kernel`, `inverted`, `budget`, …) and the selectivity estimate that
drove the choice — ``Plan.describe()`` is what ``PropGraph.explain()``
prints, so the decisions are auditable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.query.ast import Pattern, Predicate

__all__ = ["MaskStep", "PredicateStep", "Plan"]


@dataclasses.dataclass(frozen=True)
class MaskStep:
    """One attribute-store OR-query: slot ``slot`` of the (reoriented) chain.

    ``kind`` is 'node' (label mask over n vertices) or 'edge' (relationship
    mask over m edges).  ``fused`` marks steps the executor batches into a
    single kernel launch instead of running standalone.
    """

    kind: str  # 'node' | 'edge'
    slot: int
    values: Tuple[str, ...]
    impl: str
    est_count: int  # estimated matching entities (Σ per-attribute counts)
    est_selectivity: float  # est_count / entity-universe size
    fused: bool = False

    def describe(self) -> str:
        tag = f"fused-batch[{self.impl}]" if self.fused else self.impl
        return (
            f"{self.kind}[{self.slot}] any{list(self.values)} "
            f"→ impl={tag} (est {self.est_count} hits, "
            f"sel={self.est_selectivity:.4f})"
        )


@dataclasses.dataclass(frozen=True)
class PredicateStep:
    """One typed-column comparison AND-ed into slot ``slot``'s mask."""

    kind: str  # 'node' | 'edge'
    slot: int
    predicate: Predicate

    def describe(self) -> str:
        return f"{self.kind}[{self.slot}] filter {self.predicate.to_text()}"


@dataclasses.dataclass(frozen=True)
class Plan:
    """Executable plan for one pattern.

    ``pattern`` is already reoriented: if ``reversed_chain`` is set the
    planner flipped the user's pattern so constraint propagation starts from
    the more selective end (the chain-join-order decision).
    """

    pattern: Pattern
    mask_steps: Tuple[MaskStep, ...]
    predicate_steps: Tuple[PredicateStep, ...]
    backend: str
    reversed_chain: bool = False
    fused_node_slots: Tuple[int, ...] = ()  # slots batched into one kernel call
    fused_edge_slots: Tuple[int, ...] = ()  # edge slots riding a batched launch

    @property
    def hops(self) -> int:
        return self.pattern.hops

    @property
    def has_traversal(self) -> bool:
        """True when any hop is variable-length (``*`` bounds).  The
        service's coalescer checks this: traversal plans run per-request
        (their propagation is a per-plan ``while_loop``/layer unroll, not
        a shareable batched mask launch)."""
        return any(not e.is_fixed for e in self.pattern.edges)

    def describe(self) -> str:
        lines = [
            f"Plan[{self.backend}] {self.pattern.to_text()}",
            f"  chain: {self.hops} hop(s), "
            + (
                "propagate right→left (reversed: right end more selective)"
                if self.reversed_chain
                else "propagate left→right"
            ),
        ]
        if self.fused_node_slots:
            lines.append(
                f"  fusion: label masks for node slots {list(self.fused_node_slots)} "
                "batched into one bitmap_query kernel launch"
            )
        if self.fused_edge_slots:
            lines.append(
                f"  fusion: relationship masks for edge slots "
                f"{list(self.fused_edge_slots)} batched into one "
                "bitmap_query kernel launch"
            )
        for slot, edge in enumerate(self.pattern.edges):
            if not edge.is_fixed:
                mode = (
                    "fixed-point frontier closure"
                    if edge.hi is None
                    else f"unrolled frontier layers (≤{edge.hi} steps)"
                )
                lines.append(
                    f"  edge[{slot}] traverse {edge._star_text()} → {mode}"
                )
        for s in self.mask_steps:
            lines.append("  " + s.describe())
        for s in self.predicate_steps:
            lines.append("  " + s.describe())
        return "\n".join(lines)
