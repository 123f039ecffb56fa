"""Property-graph queries and subgraph induction (§VI of the paper).

A query passes a set of attributes and receives the Boolean mask of entities
holding **any** of them.  Masks compose downstream: ``induce_edge_mask``
intersects them into a subgraph, ``filtered_bfs`` is the paper's motivating
"breadth-first search on specific vertices".
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.di import DIGraph, build_di

__all__ = [
    "induce_edge_mask",
    "induce_edge_mask_directed",
    "extract_subgraph",
    "filtered_bfs",
    "connected_entities",
    "gather",
    "scatter_or",
]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for an int32 index (``index_select`` takes int32 indices)."""
    return torch.index_select(x, 0, idx)


def scatter_or(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool: ``out[idx[e]] |= vals[e]`` — the bool scatter-OR.

    Counts arrivals with an int32 ``index_add_`` and tests ``> 0``: exact,
    free of host syncs (no ``nonzero``), and indifferent to the order in
    which duplicate indices land."""
    cnt = torch.zeros(n, dtype=torch.int32, device=vals.device)
    return cnt.index_add_(0, idx, vals.to(torch.int32)) > 0


def induce_edge_mask(g: DIGraph, vertex_mask: torch.Tensor,
                     edge_mask: torch.Tensor) -> torch.Tensor:
    """An edge survives iff its own mask is set AND both endpoints' masks
    are set.  (n,) bool × (m,) bool → (m,) bool."""
    return edge_mask & gather(vertex_mask, g.src) & gather(vertex_mask, g.dst)


def induce_edge_mask_directed(g: DIGraph, tail_mask: torch.Tensor, head_mask: torch.Tensor,
                              edge_mask: torch.Tensor, direction: int = 1) -> torch.Tensor:
    """Per-endpoint form of :func:`induce_edge_mask` for directed pattern
    hops: ``direction=1`` reads tail=src/head=dst, ``-1`` the reverse."""
    tail, head = (g.src, g.dst) if direction == 1 else (g.dst, g.src)
    return edge_mask & gather(tail_mask, tail) & gather(head_mask, head)


def extract_subgraph(g: DIGraph, edge_mask) -> Tuple[DIGraph, np.ndarray]:
    """Compact a masked edge set into a fresh DI graph on ``g``'s device.
    Returns (subgraph, kept edge indices).  Vertex ids are re-normalized;
    ``node_map`` chains through the parent's, so original ids survive."""
    keep = np.flatnonzero(torch.as_tensor(edge_mask).cpu().numpy())
    src = g.src.cpu().numpy()[keep]
    dst = g.dst.cpu().numpy()[keep]
    sub = build_di(src, dst, normalize=True, dedupe=False, device=g.device)
    parent_map = g.node_map.cpu().numpy()
    sub = DIGraph(src=sub.src, dst=sub.dst, seg=sub.seg,
                  node_map=torch.from_numpy(parent_map[sub.node_map.cpu().numpy()]).to(g.device),
                  n=sub.n, m=sub.m, max_deg=sub.max_deg)
    return sub, keep


def filtered_bfs(
    g: DIGraph,
    sources: torch.Tensor,
    *,
    edge_allowed: Optional[torch.Tensor] = None,
    vertex_allowed: Optional[torch.Tensor] = None,
    max_iters: int = 64,
) -> torch.Tensor:
    """Property-filtered BFS over DI, edge-centric frontier expansion.
    Returns (n,) int32 depths, -1 for unreached.  Rounds are bounded by
    ``max_iters`` with early exit; the exit test reads one flag back to the
    host per round."""
    n, dev = g.n, g.device
    e_ok = torch.ones(g.m, dtype=torch.bool, device=dev) if edge_allowed is None else edge_allowed
    v_ok = torch.ones(n, dtype=torch.bool, device=dev) if vertex_allowed is None else vertex_allowed
    sources = torch.as_tensor(sources, device=dev).long()

    src_ok = v_ok[sources]
    depth = torch.full((n,), -1, dtype=torch.int32, device=dev)
    depth[sources] = torch.where(src_ok, 0, -1).to(torch.int32)
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[sources] = src_ok
    it = 0
    while bool(frontier.any()) and it < max_iters:
        relax = gather(frontier, g.src) & e_ok & gather(v_ok, g.dst)
        new = scatter_or(g.dst, relax, n) & (depth < 0)
        depth = torch.where(new, it + 1, depth).to(torch.int32)
        frontier = new
        it += 1
    return depth


def connected_entities(
    g: DIGraph,
    seed_mask: torch.Tensor,
    *,
    edge_allowed: Optional[torch.Tensor] = None,
    max_iters: int = 64,
) -> torch.Tensor:
    """Closure of ``seed_mask`` under allowed edges, both directions (§VII-B
    generalized to reachability).  One host read per round."""
    e_ok = torch.ones(g.m, dtype=torch.bool, device=g.device) if edge_allowed is None \
        else edge_allowed
    mask = seed_mask
    for _ in range(max_iters):
        fwd = scatter_or(g.dst, gather(mask, g.src) & e_ok, g.n)
        bwd = scatter_or(g.src, gather(mask, g.dst) & e_ok, g.n)
        new_mask = mask | fwd | bwd
        changed = bool((new_mask != mask).any())
        mask = new_mask
        if not changed:
            break
    return mask
