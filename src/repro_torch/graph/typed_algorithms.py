"""Typed-graph analytics: the paper's §VI queries composed with §I's
algorithms.  Every algorithm takes attribute masks and runs on the typed
subgraph without materializing it."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.di import DIGraph
from repro_torch.core.dip_list import mark, scatter_ids
from repro_torch.core.property_graph import PropGraph
from repro_torch.core.queries import gather

__all__ = ["khop_typed", "label_histogram", "typed_components", "attribute_assortativity"]


def khop_typed(g: DIGraph, seeds: torch.Tensor, edge_allowed: torch.Tensor, *,
               k: int) -> torch.Tensor:
    """Vertices within k typed hops of the seeds: (n,) bool, through the
    frontier engine (``traverse.khop_mask``).  Seed ids in [-n, -1] wrap
    and any other id outside [0, n) is dropped, as the reference's scatter
    takes them."""
    from repro_torch.traverse import khop_mask

    seeds = torch.as_tensor(seeds, device=g.device)
    return khop_mask(g, mark(scatter_ids(seeds, g.n), g.n, g.device), edge_allowed, k=k)


def label_histogram(pg: PropGraph) -> Tuple[np.ndarray, list]:
    """Counts per vertex label (the attribute statistics the pattern
    planner reads for selectivity) and the labels they count."""
    return pg._vstore.attr_counts(), pg.label_set()


def typed_components(pg: PropGraph, relationships: Sequence[str], *,
                     max_iters: int = 64) -> torch.Tensor:
    """Connected components of the subgraph the given relationship types
    induce: every vertex participates (singletons where the typed edges do
    not reach); ``PropGraph.components(pattern=...)`` is the richer form."""
    from repro_torch.traverse import components_masked

    g = pg._require_graph()
    return components_masked(g, None, pg.query_relationships(relationships),
                             max_iters=max_iters)


def attribute_assortativity(pg: PropGraph, labels: Sequence[str]) -> float:
    """Fraction of edges whose endpoints share membership of the queried
    label set — a one-number mixing statistic over the property graph."""
    g = pg._require_graph()
    vm = pg.query_labels(labels)
    vs, vd = gather(vm, g.src), gather(vm, g.dst)
    same = (vs & vd).sum().to(torch.float32)
    either = (vs | vd).sum().clamp(min=1).to(torch.float32)
    return float(same / either)
