"""Graph analytics over DI (the Arachne kernel suite, §I/§III).

Edge-centric, as the DI design intends.  ``connected_components`` and
``pagerank`` are aliases over the frontier engine's masked analytics;
``triangle_count`` and ``degree_histogram`` stand alone.  BFS lives in
``repro_torch.core.queries`` (property-filtered form).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.di import DIGraph
from repro_torch.core.queries import gather

__all__ = ["connected_components", "pagerank", "triangle_count", "degree_histogram"]


def connected_components(g: DIGraph, *, max_iters: int = 128) -> torch.Tensor:
    """Min-hook label propagation: (n,) component ids, edges undirected —
    ``traverse.components_masked`` with no masks."""
    from repro_torch.traverse import components_masked

    return components_masked(g, max_iters=max_iters)


def pagerank(g: DIGraph, *, damping: float = 0.85, iters: int = 20,
             edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Power iteration over the DI edge list; dangling mass redistributed.
    ``edge_mask`` composes with property queries for typed-edge PageRank —
    ``traverse.pagerank_masked`` with no vertex filter."""
    from repro_torch.traverse import pagerank_masked

    return pagerank_masked(g, None, edge_mask, damping=damping, iters=iters)


def triangle_count(g: DIGraph, *, max_deg: int) -> torch.Tensor:
    """Edge-centric triangle counting via sorted-adjacency intersection:
    for each edge (u, v), |N(u) ∩ N(v)| by a binary search of each of u's
    neighbors (padded to ``max_deg`` lanes) in v's sorted window.  Counts
    each triangle once per directed closing wedge; for the undirected count
    on a symmetrized graph divide by 6.  An int32 scalar."""
    last = max(g.m - 1, 0)
    lane = torch.arange(max_deg, dtype=torch.int64, device=g.device)
    start_u = gather(g.seg, g.src).long()
    deg_u = gather(g.seg, g.src + 1).long() - start_u
    nbr_u = gather(g.dst, (start_u[:, None] + lane).clamp(0, last).flatten()).view(
        len(start_u), max_deg)
    valid_u = lane < deg_u[:, None]
    end_v = gather(g.seg, g.dst + 1).long()[:, None].expand(-1, max_deg)
    lo = gather(g.seg, g.dst).long()[:, None].expand(-1, max_deg)
    hi = end_v
    for _ in range(max(1, int(math.ceil(math.log2(max(g.m, 2)))) + 1)):
        mid = (lo + hi) >> 1
        go_right = (gather(g.dst, mid.clamp(0, last).flatten()).view_as(mid) < nbr_u) & (lo < hi)
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    found = ((lo < end_v) & (gather(g.dst, lo.clamp(0, last).flatten()).view_as(lo) == nbr_u)
             & valid_u)
    return found.sum().to(torch.int32)


def degree_histogram(g: DIGraph, *, n_bins: int = 64) -> torch.Tensor:
    """Out-degree histogram (Tab. I statistics support): (n_bins,) int32,
    degrees past the last bin counted in it."""
    deg = g.seg[1:] - g.seg[:-1]
    return torch.bincount(deg.clamp(0, n_bins - 1), minlength=n_bins).to(torch.int32)
