"""DI (Double-Index) graph data structure (§III of the paper).

  * ``src[m]``, ``dst[m]``  -- the edge index arrays, sorted by (src, dst) so
    every vertex's adjacency list is a contiguous slice,
  * ``seg[n+1]``            -- the vertex index array (CSR offsets);
    ``seg[0] == 0`` and ``seg[n] == m``,
  * ``node_map[n]``         -- original (pre-normalization) vertex ids.

Neighborhood of ``u`` = ``dst[seg[u] : seg[u+1]]``.  All index arrays are
int32 tensors on the graph's device, ``node_map`` included: the reference
runs with 64-bit types off, so its ``unique`` of the endpoints is int32 too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = [
    "DIGraph",
    "build_di",
    "build_reverse_di",
    "degrees",
    "neighbors_padded",
    "edge_lookup",
    "max_degree",
]


@dataclasses.dataclass(frozen=True)
class DIGraph:
    """Double-Index graph. ``n`` vertices (normalized ids in [0, n)), ``m`` edges.

    Invariants: ``src`` non-decreasing, ``dst`` sorted within equal ``src``
    runs; ``seg[0] == 0``, ``seg[n] == m``, ``seg[u+1] - seg[u]`` is the out
    degree of ``u``; ``node_map`` strictly increasing.  ``max_deg`` caches
    the widest adjacency window (``-1`` = unknown: consumers fall back to
    the conservative bound).

    ``unsorted=True`` marks the overlay's combined view (sorted base edges
    followed by the delta edges, ``PropGraph._effective_graph``): ``seg``
    then covers only the sorted base prefix, so SEG-window consumers
    (``khop_csr``, ``edge_lookup``) must not be handed it; the edge-centric
    paths consume it unchanged.
    """

    src: torch.Tensor  # (m,) int32
    dst: torch.Tensor  # (m,) int32
    seg: torch.Tensor  # (n+1,) int32
    node_map: torch.Tensor  # (n,) original vertex ids
    n: int
    m: int
    max_deg: int = -1
    unsorted: bool = False

    @property
    def device(self) -> torch.device:
        return self.src.device

    def out_degree(self, u) -> torch.Tensor:
        return self.seg[u + 1] - self.seg[u]

    def edge_index(self) -> torch.Tensor:
        """(2, m) edge index in the conventional GNN layout."""
        return torch.stack([self.src, self.dst])


def _seg_from_sorted_src(src_s: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    counts = torch.bincount(src_s, minlength=n) if n else torch.zeros(0, dtype=torch.int64,
                                                                     device=src_s.device)
    seg = torch.cat([torch.zeros(1, dtype=torch.int32, device=src_s.device),
                     torch.cumsum(counts, 0).to(torch.int32)])
    max_deg = int(counts.max()) if n else 0
    return seg, max_deg


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Order by (primary, secondary) — two stable sorts, secondary first, so
    equal keys keep their input order exactly as a lexsort does."""
    o1 = torch.argsort(secondary, stable=True)
    return o1[torch.argsort(primary[o1], stable=True)]


def build_di(
    src,
    dst,
    *,
    n: Optional[int] = None,
    normalize: bool = True,
    dedupe: bool = True,
    device=None,
) -> DIGraph:
    """Construct a DI graph from raw endpoint arrays (§V ingestion path):
    (1) vertex-id normalization to [0, n), (2) lexicographic (src, dst)
    sort, (3) SEG offsets.  Runs on ``device``; by default a tensor ``src``
    keeps its device and host input (numpy, lists) goes to the CUDA card
    (``resolve_device``: with no card that raises rather than running on
    the CPU).  Endpoints are narrowed to int32 first, as the reference does.

    ``normalize`` remaps original ids to dense [0, n) via sorted-unique;
    ``dedupe`` collapses structural multi-edges ((u, v) repeated).
    """
    if device is None and torch.is_tensor(src):
        device = src.device
    device = resolve_device(device)
    src = src if torch.is_tensor(src) else torch.as_tensor(np.asarray(src))
    dst = dst if torch.is_tensor(dst) else torch.as_tensor(np.asarray(dst))
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError(f"src/dst must be equal-length 1-D, got {tuple(src.shape)} "
                         f"vs {tuple(dst.shape)}")
    src = src.to(device=device, dtype=torch.int32)
    dst = dst.to(device=device, dtype=torch.int32)

    if normalize:
        node_map = torch.unique(torch.cat([src, dst]))
        n_ = int(node_map.shape[0])
        if n is not None and n < n_:
            raise ValueError(f"n={n} smaller than distinct vertex count {n_}")
        src_n = torch.searchsorted(node_map, src, out_int32=True)
        dst_n = torch.searchsorted(node_map, dst, out_int32=True)
        n = n_ if n is None else int(n)
    else:
        if n is None:
            n = int(torch.cat([src, dst]).max()) + 1 if src.numel() else 0
        node_map = torch.arange(n, dtype=torch.int32, device=device)
        src_n, dst_n = src, dst

    order = _lexsort(src_n, dst_n)
    src_s, dst_s = src_n[order], dst_n[order]

    if dedupe and src_s.numel():
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                          (src_s[1:] != src_s[:-1]) | (dst_s[1:] != dst_s[:-1])])
        src_s, dst_s = src_s[keep], dst_s[keep]

    m = int(src_s.shape[0])
    seg, max_deg = _seg_from_sorted_src(src_s, n)
    return DIGraph(src=src_s, dst=dst_s, seg=seg, node_map=node_map, n=n, m=m,
                   max_deg=max_deg)


def build_reverse_di(g: DIGraph) -> DIGraph:
    """In-edge view: DI over (dst, src); shares ``node_map``."""
    order = _lexsort(g.dst, g.src)
    rsrc, rdst = g.dst[order], g.src[order]
    seg, max_deg = _seg_from_sorted_src(rsrc, g.n)
    return DIGraph(src=rsrc, dst=rdst, seg=seg, node_map=g.node_map, n=g.n, m=g.m,
                   max_deg=max_deg)


def degrees(g: DIGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out_degree[n], in_degree[n]) — Tab. I statistics."""
    out_deg = g.seg[1:] - g.seg[:-1]
    in_deg = torch.bincount(g.dst, minlength=g.n).to(torch.int32)
    return out_deg, in_deg


def max_degree(g: DIGraph) -> int:
    if not g.n:
        return 0
    out_deg, in_deg = degrees(g)
    return int(torch.maximum(out_deg.max(), in_deg.max()))


def neighbors_padded(g: DIGraph, u, *, max_deg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``DST[SEG[u]..SEG[u+1]-1]`` padded to ``max_deg`` lanes.

    Returns (neighbors (..., max_deg) int32 with -1 in unused lanes, valid
    mask)."""
    u = torch.as_tensor(u, device=g.device).long()
    start = g.seg[u]
    deg = g.seg[u + 1] - start
    lane = torch.arange(max_deg, dtype=torch.int32, device=g.device)
    idx = start[..., None] + lane
    valid = lane < deg[..., None]
    gathered = g.dst[idx.clamp(0, max(g.m - 1, 0)).long()] if g.m else torch.zeros_like(idx)
    nbrs = torch.where(valid, gathered, torch.full_like(gathered, -1))
    return nbrs, valid


def edge_lookup(g: DIGraph, eu, ev) -> torch.Tensor:
    """Map endpoint pairs (normalized ids) to edge indices in [0, m), -1
    where the edge does not exist.

    SEG narrows each query to its source's adjacency window, then a
    fixed-trip-count vectorized binary search finds ``ev`` in the sorted
    DST slice: ⌈log₂ max_deg⌉+1 rounds (⌈log₂ m⌉+1 when ``max_deg`` is
    unknown) — every window is an adjacency slice, so that pins the answer.
    """
    eu = torch.as_tensor(eu, device=g.device).to(torch.int32)
    ev = torch.as_tensor(ev, device=g.device).to(torch.int32)
    if g.m == 0:
        return torch.full(eu.shape, -1, dtype=torch.int32, device=g.device)
    eu_l = eu.long()
    lo = g.seg[eu_l]
    hi = g.seg[eu_l + 1]
    end = hi
    window = g.max_deg if g.max_deg >= 0 else g.m
    trips = max(1, int(math.ceil(math.log2(max(window, 2)))) + 1)
    for _ in range(trips):
        mid = (lo + hi) >> 1
        go_right = (g.dst[mid.clamp(0, g.m - 1).long()] < ev) & (lo < hi)
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    pos = lo.clamp(0, g.m - 1).long()
    found = (lo < end) & (g.dst[pos] == ev) & (g.src[pos] == eu)
    return torch.where(found, pos.to(torch.int32), torch.full_like(lo, -1))
