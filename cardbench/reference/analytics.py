"""Plain references for the Graphalytics kernels the port computes.

Each works from the harness's arrays (``graphdata.make``: vertices numbered
by sorted id, distinct directed edges ``esrc → edst``; an undirected
configuration holds both directions of each edge, so every walk below is
undirected there) in plain torch or SciPy, and imports nothing of the
program.  The semantics are the port's
documented ones:

* ``bfs``: depth of every vertex from one source along out-edges, -1 where
  unreached;
* ``components``: weakly connected components, each vertex labelled with
  the smallest vertex number of its component (SciPy's union-find);
* ``shortest_paths``: directed single-source distances over the weights,
  +inf where unreachable (Bellman–Ford in ``dtype``);
* ``pagerank``: power iteration from 1/n, dangling mass and teleport spread
  over all n vertices, ``iters`` rounds, in ``dtype``;
* ``communities``: synchronous label propagation over undirected edges
  (each directed edge counted from both ends), labels starting as vertex
  numbers, the most frequent neighbour label winning and the smallest
  among equals; a vertex with no edge keeps its label; it stops at the
  first round that changes nothing, or at ``max_iters`` rounds.
"""
from __future__ import annotations

import numpy as np
import torch


def bfs(src, dst, n: int, source: int) -> torch.Tensor:
    depth = torch.full((n,), -1, dtype=torch.int64, device=src.device)
    depth[source] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=src.device)
    frontier[source] = True
    level = 0
    while bool(frontier.any()):
        level += 1
        nxt = torch.zeros_like(frontier)
        nxt[dst[frontier[src]]] = True
        frontier = nxt & (depth < 0)
        depth[frontier] = level
    return depth


def components(src, dst, n: int) -> np.ndarray:
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    s, d = src.cpu().numpy(), dst.cpu().numpy()
    adj = coo_matrix((np.ones(len(s), dtype=np.int8), (s, d)), shape=(n, n)).tocsr()
    _, comp = connected_components(adj, directed=True, connection="weak")
    smallest = np.full(comp.max() + 1 if n else 0, n, dtype=np.int64)
    np.minimum.at(smallest, comp, np.arange(n))
    return smallest[comp]


def shortest_paths(src, dst, n: int, weights, source: int, dtype) -> torch.Tensor:
    w = weights.to(dtype)
    dist = torch.full((n,), float("inf"), dtype=dtype, device=src.device)
    dist[source] = 0
    while True:
        cand = torch.full_like(dist, float("inf"))
        cand.scatter_reduce_(0, dst, dist[src] + w, "amin")
        new = torch.minimum(dist, cand)
        if bool((new == dist).all()):
            return dist
        dist = new


def pagerank(src, dst, n: int, dtype, *, damping: float = 0.85, iters: int = 20):
    out_deg = torch.bincount(src, minlength=n).to(dtype)
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    has_out = out_deg > 0
    for _ in range(iters):
        share = torch.where(has_out, r / out_deg.clamp(min=1), 0)
        agg = torch.zeros_like(r).index_add_(0, dst, share[src])
        dangling = r[~has_out].sum()
        r = (1 - damping) / n + damping * (agg + dangling / n)
    return r


def communities(src, dst, n: int, *, max_iters: int = 64) -> torch.Tensor:
    heads = torch.cat([dst, src])
    tails = torch.cat([src, dst])
    labels = torch.arange(n, device=src.device)
    has_edge = torch.zeros(n, dtype=torch.bool, device=src.device)
    has_edge[heads] = True
    for _ in range(max_iters):
        # sort (head, neighbour label) pairs, count each run, then keep per
        # head the run with the highest count and, among those, the lowest label
        pair = heads * n + labels[tails]
        pair, counts = torch.unique_consecutive(torch.sort(pair).values, return_counts=True)
        h, lab = pair // n, pair % n
        top = int(counts.max()) + 1
        order = torch.sort(h * (top * n) + (top - 1 - counts) * n + lab).indices
        h, lab = h[order], lab[order]
        first = torch.ones_like(h, dtype=torch.bool)
        first[1:] = h[1:] != h[:-1]
        new = labels.clone()
        new[h[first]] = lab[first]
        new = torch.where(has_edge, new, labels)
        if bool((new == labels).all()):
            break
        labels = new
    return labels


def max_relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the finite reference entries, relative to
    the largest finite reference entry; inf where the two disagree on which
    entries are finite (reachability)."""
    got, want = got.to(torch.float64), want.to(got.device, torch.float64)
    fin = torch.isfinite(want)
    if not bool((torch.isfinite(got) == fin).all()):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    scale = float(want[fin].abs().max())
    return float((got[fin] - want[fin]).abs().max()) / max(scale, 1e-300)


def l1_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.to(torch.float64) - want.to(got.device, torch.float64)).abs().sum())
