"""Property-aware analytics over the frontier engine.

Ported so far: ``single_hop_filters``, the pattern→masks front door that
``PropGraph.sample`` uses for its edge filter (and that ``khop`` /
``components`` / ``shortest_paths`` / ``pagerank`` / ``communities`` will
use once the semiring analytics are ported).  A node-only or single-hop
pattern (``"(a:host)-[:flows {bytes > 0}]->(b)"``) becomes (tail mask,
head mask, edge mask, direction), the same §VI masks the query engine
composes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["single_hop_filters"]


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
