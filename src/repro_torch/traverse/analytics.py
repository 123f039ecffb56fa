"""Property-aware analytics over the semiring frontier engine.

The paper's §I workloads are reachability-shaped ("which hosts are within
k ``flows``-hops of a flagged host", "components of the ``follows``
subgraph"); the weighted analytics extend the same shape to numeric
semirings.  Each is a client of the engine's relax that respects the
property layer: every function takes vertex/edge masks (derived from a
single-hop pattern by ``single_hop_filters``) and an optional numeric edge
weight, so labels, relationship types and typed-property predicates all
filter the traversal; no subgraph is materialized.

  * ``components_masked``       — (min, select) min-hook + pointer jumping.
  * ``shortest_paths_masked``   — (min, +) tropical Bellman–Ford.
  * ``pagerank_masked``         — (+, ×) power iteration.
  * ``label_propagation_masked``— synchronous label propagation (mode
    relax, smallest label breaks ties).

Each fixed point is a Python loop with one host read per round, counted
in ``engine.rounds`` under the function's name (see ``engine``).

``shortest_paths_sharded`` and ``pagerank_sharded`` run the same loops
with the relax sharded over an entity mesh (``engine``'s sharded path):
the min all-reduce is exact, so shortest paths stay bitwise; PageRank's
sum reassociates and agrees within tolerance.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch

from repro_torch.core.di import DIGraph
from repro_torch.core.queries import gather
from repro_torch.traverse import engine
from repro_torch.traverse.engine import (
    COUNTING,
    MINLABEL,
    TROPICAL,
    EdgeBlocks,
    _all_edges,
    _ends,
    _ends64,
    _fixed_point,
    _pad_edges,
    _relax,
    _shard_edge_vals,
    _sharded_relax_fn,
)

__all__ = [
    "components_masked",
    "shortest_paths_masked",
    "shortest_paths_sharded",
    "pagerank_masked",
    "pagerank_sharded",
    "label_propagation_masked",
    "single_hop_filters",
]


def _all_vertices(g: DIGraph, vertex_allowed) -> torch.Tensor:
    if vertex_allowed is None:
        return torch.ones(g.n, dtype=torch.bool, device=g.device)
    return vertex_allowed


def components_masked(
    g: DIGraph,
    vertex_allowed: Optional[torch.Tensor] = None,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    max_iters: int = 128,
) -> torch.Tensor:
    """Connected components of the masked subgraph: (n,) int32 labels
    (component id = smallest member vertex id), -1 for vertices outside
    ``vertex_allowed``.  Edges count as undirected; an edge participates
    iff its own mask AND both endpoint masks are set.  The hook step is
    the (min, select) :data:`MINLABEL` relax, iterated with pointer
    jumping."""
    n = g.n
    v_ok = _all_vertices(g, vertex_allowed)
    e_act = _all_edges(g, edge_allowed) & gather(v_ok, g.src) & gather(v_ok, g.dst)
    tail, head = _ends64(g, 1)
    # sentinel n: excluded vertices never hook anything
    labels0 = torch.where(v_ok, torch.arange(n, dtype=torch.int32, device=g.device), n)

    def step(labels):
        new = torch.minimum(labels, _relax(tail, head, n, labels, e_act, MINLABEL, True))
        # pointer jumping: only real labels (< n) chase
        jumped = gather(new, new.clamp(0, max(n - 1, 0)))
        return torch.where(new < n, jumped, new)

    labels = _fixed_point("components", step, labels0, max_iters)
    return torch.where(v_ok, labels, -1).to(torch.int32)


# ------------------------------------------------------- shortest paths (min,+)
def shortest_paths_masked(
    g: DIGraph,
    seed_mask: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    direction: int = 1,
    undirected: bool = False,
    max_iters: Optional[int] = None,
) -> torch.Tensor:
    """Multi-source shortest-path distances over the (min, +) tropical
    semiring: (n,) f32, 0.0 at the seeds, +inf where unreachable.

    Bellman–Ford as a frontier fixed point: each round relaxes every
    allowed edge (``dist' = min(dist, ⊕ dist[tail] + w)``) until no
    distance improves.  ``weights`` defaults to unit weights (hop counts);
    masked edges carry +inf, so they never relax.  With non-negative
    weights n-1 rounds always suffice; ``max_iters`` (default n+1) bounds
    the loop so a negative cycle cannot spin it forever.

    A NaN message (a NaN weight, or -inf meeting +inf) makes its head NaN
    as the reference's scatter-min does; only weights that are NaN or
    negative can make one, so only then (one host read a call) does each
    round scatter NaNs apart."""
    w = (torch.ones(g.m, dtype=torch.float32, device=g.device) if weights is None
         else weights.to(torch.float32))
    ew = torch.where(_all_edges(g, edge_allowed), w, float("inf"))
    dist0 = torch.where(seed_mask, 0.0, float("inf")).to(torch.float32)
    bound = (g.n + 1) if max_iters is None else max_iters
    tail, head = _ends64(g, direction)
    nan_exact = bool(((ew < 0) | torch.isnan(ew)).any())

    def step(dist):
        return torch.minimum(dist, _relax(tail, head, g.n, dist, ew, TROPICAL, undirected,
                                          nan_exact))

    return _fixed_point("shortest_paths", step, dist0, bound)


@lru_cache(maxsize=None)
def _sharded_bellman_fn(mesh, direction: int, undirected: bool):
    """Tropical Bellman–Ford whose relax runs sharded: per-shard partial
    (n,) distance vectors, ⊕-combined with ONE min all-reduce a round.  min
    over f32 is exact, so the result is bitwise the single-device path."""
    relax = _sharded_relax_fn(mesh, direction, undirected, TROPICAL)

    def fn(dist0: torch.Tensor, ew: torch.Tensor, *, max_iters: int, blocks: EdgeBlocks,
           nan_exact: bool) -> torch.Tensor:
        ew_parts = _shard_edge_vals(ew, blocks, mesh, TROPICAL.zero)
        return _fixed_point(
            "shortest_paths",
            lambda dist: torch.minimum(dist, relax(blocks, ew_parts, dist, nan_exact)),
            dist0, max_iters)

    return fn


def shortest_paths_sharded(
    g: DIGraph,
    seed_mask: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    mesh,
    direction: int = 1,
    undirected: bool = False,
    max_iters: Optional[int] = None,
    blocks: Optional[EdgeBlocks] = None,
) -> torch.Tensor:
    """``shortest_paths_masked`` with the sharded relax (``blocks``: the
    graph's cached ``_pad_edges``); bitwise the single-device path."""
    w = (torch.ones(g.m, dtype=torch.float32, device=g.device) if weights is None
         else weights.to(torch.float32))
    ew = torch.where(_all_edges(g, edge_allowed), w, float("inf"))
    dist0 = torch.where(seed_mask, 0.0, float("inf")).to(torch.float32)
    blocks = blocks if blocks is not None else _pad_edges(g, mesh, direction)
    fn = _sharded_bellman_fn(mesh, direction, undirected)
    bound = (g.n + 1) if max_iters is None else max_iters
    return fn(dist0, ew, max_iters=bound, blocks=blocks,
              nan_exact=bool(((ew < 0) | torch.isnan(ew)).any()))


# ------------------------------------------------------------ pagerank (+, ×)
def pagerank_masked(
    g: DIGraph,
    vertex_allowed: Optional[torch.Tensor] = None,
    edge_allowed: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    *,
    damping: float = 0.85,
    iters: int = 20,
    direction: int = 1,
) -> torch.Tensor:
    """PageRank on the property-filtered subgraph: (n,) f32 ranks, 0.0
    outside ``vertex_allowed``.

    Power iteration whose aggregation is the (+, ×) :data:`COUNTING`
    relax: contributions ``rank[tail] / out_deg[tail] · w[e]`` sum into the
    heads.  Out-degrees are (weight-)summed over allowed edges only; an
    edge participates iff its own mask AND both endpoint masks are set.
    Dangling mass and the teleport term redistribute over the allowed
    vertex count: with no vertex filter that is the host integer ``g.n``,
    with one an f32 sum of the filter (the two round differently)."""
    w = (torch.ones(g.m, dtype=torch.float32, device=g.device) if weights is None
         else weights.to(torch.float32))
    if edge_allowed is not None:
        w = torch.where(edge_allowed, w, 0.0)
    tail, head = _ends(g, direction)
    if vertex_allowed is not None:
        w = torch.where(gather(vertex_allowed, tail) & gather(vertex_allowed, head), w, 0.0)
        n_eff = vertex_allowed.to(torch.float32).sum().clamp(min=1.0)
        r = torch.where(vertex_allowed, 1.0 / n_eff, 0.0)
    else:
        n_eff = g.n
        r = torch.full((g.n,), 1.0 / max(g.n, 1), dtype=torch.float32, device=g.device)
    out_deg = torch.zeros(g.n, dtype=torch.float32, device=g.device).index_add_(0, tail, w)
    inv_deg = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1e-30), 0.0)
    teleport = (1 - damping) / n_eff
    for _ in range(iters):
        agg = _relax(tail, head, g.n, r * inv_deg, w, COUNTING, False)
        dangling = torch.where(out_deg > 0, 0.0, r).sum()
        r_new = teleport + damping * (agg + dangling / n_eff)
        r = r_new if vertex_allowed is None else torch.where(vertex_allowed, r_new, 0.0)
    engine.rounds["pagerank"] = engine.rounds.get("pagerank", 0) + iters
    return r


@lru_cache(maxsize=None)
def _sharded_pagerank_fn(mesh, direction: int):
    """Power iteration whose aggregation runs sharded: per-shard partial
    contribution sums, ⊕-combined with ONE sum all-reduce a step.  The
    float sums reassociate across shard blocks, so the ranks agree with
    the single-device path within tolerance, not bitwise."""
    relax = _sharded_relax_fn(mesh, direction, False, COUNTING)

    def fn(g: DIGraph, v_ok: torch.Tensor, w: torch.Tensor, damping: float, *, iters: int,
           blocks: EdgeBlocks) -> torch.Tensor:
        tail, _ = _ends(g, direction)
        w_parts = _shard_edge_vals(w, blocks, mesh, COUNTING.zero)
        n_eff = v_ok.to(torch.float32).sum().clamp(min=1.0)
        out_deg = torch.zeros(g.n, dtype=torch.float32, device=g.device).index_add_(0, tail, w)
        inv_deg = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1e-30), 0.0)
        r = torch.where(v_ok, 1.0 / n_eff, 0.0)
        for _ in range(iters):
            agg = relax(blocks, w_parts, r * inv_deg)
            dangling = torch.where(out_deg > 0, 0.0, r).sum()
            r_new = (1 - damping) / n_eff + damping * (agg + dangling / n_eff)
            r = torch.where(v_ok, r_new, 0.0)
        engine.rounds["pagerank"] = engine.rounds.get("pagerank", 0) + iters
        return r

    return fn


def pagerank_sharded(
    g: DIGraph,
    vertex_allowed: Optional[torch.Tensor] = None,
    edge_allowed: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    *,
    mesh,
    damping: float = 0.85,
    iters: int = 20,
    direction: int = 1,
    blocks: Optional[EdgeBlocks] = None,
) -> torch.Tensor:
    """``pagerank_masked`` with the sharded aggregation; equal to the
    single-device path within float tolerance."""
    w = (torch.ones(g.m, dtype=torch.float32, device=g.device) if weights is None
         else weights.to(torch.float32))
    if edge_allowed is not None:
        w = torch.where(edge_allowed, w, 0.0)
    tail, head = _ends(g, direction)
    v_ok = _all_vertices(g, vertex_allowed)
    if vertex_allowed is not None:
        w = torch.where(gather(v_ok, tail) & gather(v_ok, head), w, 0.0)
    blocks = blocks if blocks is not None else _pad_edges(g, mesh, direction)
    return _sharded_pagerank_fn(mesh, direction)(g, v_ok, w, damping, iters=iters,
                                                 blocks=blocks)


# ------------------------------------------------- label propagation (mode)
def label_propagation_masked(
    g: DIGraph,
    vertex_allowed: Optional[torch.Tensor] = None,
    edge_allowed: Optional[torch.Tensor] = None,
    *,
    max_iters: int = 64,
) -> torch.Tensor:
    """Community detection by synchronous label propagation: (n,) int32
    community labels, -1 outside ``vertex_allowed``.

    Every round, every allowed vertex adopts the most frequent label among
    its allowed neighbors (edges count as undirected, both endpoint masks
    and the edge mask gate participation); ties break toward the SMALLEST
    label; a vertex with no allowed incident edge keeps its label.  Labels
    start as vertex ids.  Synchronous updates can oscillate, so the loop
    stops at ``max_iters`` rounds: the cap is part of the answer.

    The mode: the active (head, neighbor label) pairs are taken once per
    call (so nothing needs the reference's out-of-range drop), and each
    round sorts them as one int64 key ``head·(n+1) + label``, counts each
    group (``torch.unique``), then scatter-max picks each head's best count
    and scatter-min the smallest label reaching it.  All integer: exact."""
    n = g.n
    v_ok = _all_vertices(g, vertex_allowed)
    labels0 = torch.where(v_ok, torch.arange(n, device=g.device), 0)
    if g.m == 0 or n == 0:
        return torch.where(v_ok, labels0, -1).to(torch.int32)
    e_act = _all_edges(g, edge_allowed) & gather(v_ok, g.src) & gather(v_ok, g.dst)
    ok2 = torch.cat([e_act, e_act])
    heads = torch.cat([g.dst, g.src]).long()[ok2]
    tails = torch.cat([g.src, g.dst]).long()[ok2]

    def step(labels):
        keys, counts = torch.unique(heads * (n + 1) + labels[tails], return_counts=True)
        h, lab = keys // (n + 1), keys % (n + 1)
        best_cnt = torch.zeros_like(labels).scatter_reduce_(0, h, counts, "amax")
        best = torch.where(counts == best_cnt[h], lab, n)
        best_lab = torch.full_like(labels, n).scatter_reduce_(0, h, best, "amin")
        return torch.where(best_lab < n, best_lab, labels)

    labels = _fixed_point("communities", step, labels0, max_iters)
    return torch.where(v_ok, labels, -1).to(torch.int32)


def single_hop_filters(
    pg, pattern
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor], int]:
    """Derive traversal filters from a node-only or single-hop pattern.

    Returns ``(tail_mask, head_mask, edge_mask, direction)`` — each mask
    ``None`` when unconstrained.  For ``(a:x {p})-[:r {q}]->(b:y)``: an
    edge is traversable iff it holds ``r`` and satisfies ``q``, its tail
    (in traversal order — ``<-[...]-`` flips it) matches ``a`` and its
    head matches ``b``.  A node-only pattern constrains BOTH endpoints
    (traversal confined to matching vertices).  Multi-hop and
    variable-length patterns are rejected: a traversal takes its step
    structure from its own depth, not from the pattern.
    """
    from repro_torch.query import parse
    from repro_torch.query.planner import validate_pattern

    if pattern is None:
        return None, None, None, 1
    pat = parse(pattern) if isinstance(pattern, str) else pattern
    if pat.hops > 1:
        raise ValueError(
            f"khop/components take a node-only or single-hop filter pattern, "
            f"got {pat.hops} hops in {pat.to_text()!r}")
    validate_pattern(pat)  # plan-time contract: string predicates etc.

    def node_mask(node):
        mask = None
        if node.labels:
            mask = pg.query_labels(list(node.labels))
        for p in node.predicates:
            pm = pg.vertex_predicate_mask(p.name, p.op, p.value)
            mask = pm if mask is None else mask & pm
        return mask

    if pat.hops == 0:
        vm = node_mask(pat.nodes[0])
        return vm, vm, None, 1

    edge = pat.edges[0]
    if not edge.is_fixed:
        raise ValueError(
            f"variable-length hop {edge.to_text()!r} in a khop/components "
            "filter: the traversal depth comes from k / the fixed point, "
            "use a plain single-hop filter")
    em = None
    if edge.rels:
        em = pg.query_relationships(list(edge.rels))
    for p in edge.predicates:
        pm = pg.edge_predicate_mask(p.name, p.op, p.value)
        em = pm if em is None else em & pm
    return node_mask(pat.nodes[0]), node_mask(pat.nodes[1]), em, edge.direction
