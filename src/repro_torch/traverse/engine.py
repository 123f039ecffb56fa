"""Frontier engine — Boolean frontier expansion over DI.

The part of the semiring frontier engine the pattern executor runs: the
(OR, AND) :data:`BOOLEAN` relax, one frontier step, ≤k-hop expansion and
the fixed-point closure behind unbounded ``*`` hops.  The other semirings
and the analytics built on them are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.di import DIGraph
from repro_torch.core.queries import gather, scatter_or

__all__ = [
    "Semiring",
    "BOOLEAN",
    "semiring_relax",
    "frontier_step",
    "khop_mask",
    "reach_closure",
]


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One relax algebra: ⊕ combines messages at a vertex, ⊗ extends a
    vertex value along an edge; ``zero`` is the ⊕ identity and ⊗ absorber."""

    name: str
    zero: object
    scatter: str  # the ⊕ scatter combine: "max" | "min" | "add"
    extend: Callable  # ⊗: (tail value, edge value) → message


# (OR, AND) over bool — reachability.
BOOLEAN = Semiring("boolean", False, "max", lambda x, w: x & w)


def _ends(g: DIGraph, direction: int):
    """(tail, head) endpoint arrays: +1 follows src→dst, -1 walks dst→src."""
    return (g.src, g.dst) if direction == 1 else (g.dst, g.src)


def _all_edges(g: DIGraph, edge_allowed) -> torch.Tensor:
    if edge_allowed is None:
        return torch.ones(g.m, dtype=torch.bool, device=g.device)
    return edge_allowed


def semiring_relax(
    g: DIGraph,
    x: torch.Tensor,
    edge_vals: torch.Tensor,
    sr: Semiring,
    *,
    direction: int = 1,
    undirected: bool = False,
) -> torch.Tensor:
    """ONE edge-centric relax: ``out[v] = ⊕_{(u→v)} x[u] ⊗ w[e]``; vertices
    with no incoming message hold ``sr.zero``.  ``undirected`` relaxes every
    edge in reverse into the same output too.  Only :data:`BOOLEAN` is
    ported; its ⊕ (max over bool) is a scatter-OR."""
    if sr is not BOOLEAN:
        raise NotImplementedError(f"semiring {sr.name!r} is not ported yet")
    tail, head = _ends(g, direction)
    out = scatter_or(head, sr.extend(gather(x, tail), edge_vals), g.n)
    if undirected:
        out = out | scatter_or(tail, sr.extend(gather(x, head), edge_vals), g.n)
    return out


def frontier_step(
    g: DIGraph,
    frontier: torch.Tensor,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    direction: int = 1,
    undirected: bool = False,
) -> torch.Tensor:
    """ONE masked Boolean expansion: heads of allowed edges whose tail is in
    the frontier.  Exactly one step; the input frontier is not included."""
    return semiring_relax(g, frontier, _all_edges(g, edge_allowed), BOOLEAN,
                          direction=direction, undirected=undirected)


def khop_mask(
    g: DIGraph,
    seed_mask: torch.Tensor,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    k: int,
    direction: int = 1,
    undirected: bool = False,
) -> torch.Tensor:
    """Vertices within ≤k allowed hops of the seeds (seeds included), with
    early exit once the mask stops growing.  The exit test reads one flag
    back to the host per round (``any(new != mask)``): the price of a
    Python loop in place of a device-side while loop."""
    e_ok = _all_edges(g, edge_allowed)
    mask = seed_mask
    for _ in range(k):
        new = mask | frontier_step(g, mask, e_ok, direction=direction,
                                   undirected=undirected)
        changed = bool((new != mask).any())
        mask = new
        if not changed:
            break
    return mask


def reach_closure(
    g: DIGraph,
    seed_mask: torch.Tensor,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    direction: int = 1,
    undirected: bool = False,
    max_iters: Optional[int] = None,
) -> torch.Tensor:
    """Fixed point of frontier expansion: everything reachable from the
    seeds in ≥0 allowed hops.  The mask grows monotonically, so n rounds
    always suffice (``max_iters`` defaults to that bound)."""
    bound = (g.n + 1) if max_iters is None else max_iters
    return khop_mask(g, seed_mask, edge_allowed, k=bound,
                     direction=direction, undirected=undirected)
