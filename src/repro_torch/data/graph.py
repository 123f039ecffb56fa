"""Graph data pipeline: GraphBatch builders for the GNN shapes.

Both builders draw from numpy's seeded generator in the reference's order,
so the same arguments give the same arrays in both packages; tensors are
placed on ``device`` (None: the CUDA card).  Ported so far:
``synthetic_graph_batch`` and ``build_triplets`` (DimeNet triplet lists,
built from DI adjacency, capped at 8×E).  The GraphCast batch
(``synthetic_gc_batch``, ``graphcast_sizes``) waits for the science models.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.property_graph import resolve_device
from repro_torch.models.gnn_common import GraphBatch

__all__ = ["synthetic_graph_batch", "build_triplets", "TRIPLET_CAP_FACTOR"]

TRIPLET_CAP_FACTOR = 8


def build_triplets(src: np.ndarray, dst: np.ndarray, cap: int) -> np.ndarray:
    """(kj_edge, ji_edge, valid) triplet list: edges (k→j), (j→i), k≠i.

    Built from the DI reverse index: for each edge e2=(j→i), its partners are
    the in-edges of j.  Capped/padded to ``cap`` rows."""
    e = len(src)
    by_dst = {}
    for i, d in enumerate(dst):
        by_dst.setdefault(int(d), []).append(i)
    rows = []
    for e2 in range(e):
        j, i = int(src[e2]), int(dst[e2])
        for e1 in by_dst.get(j, ()):
            if int(src[e1]) != i:
                rows.append((e1, e2, 1))
                if len(rows) >= cap:
                    break
        if len(rows) >= cap:
            break
    while len(rows) < cap:
        rows.append((0, 0, 0))
    return np.asarray(rows, np.int32)


def synthetic_graph_batch(
    *, n_nodes: int, n_edges: int, d_feat: Optional[int] = None, n_classes: int = 7,
    n_graphs: int = 1, with_pos: bool = False, n_species: int = 16,
    with_triplets: bool = False, seed: int = 0, device=None,
) -> GraphBatch:
    device = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n_nodes, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    x = t(rng.standard_normal((n_nodes, d_feat), np.float32)) if d_feat else None
    pos = t(rng.standard_normal((n_nodes, 3), np.float32)) if with_pos else None
    species = t(rng.integers(0, n_species, n_nodes, dtype=np.int32)) if with_pos else None
    tri = None
    if with_triplets:
        tri = t(build_triplets(src, dst, TRIPLET_CAP_FACTOR * n_edges))
    if n_graphs > 1:
        gid = np.sort(rng.integers(0, n_graphs, n_nodes)).astype(np.int32)
        labels = t(rng.standard_normal(n_graphs, np.float32))
    else:
        gid = np.zeros(n_nodes, np.int32)
        labels = (t(rng.standard_normal(1, np.float32)) if with_pos
                  else t(rng.integers(0, n_classes, n_nodes, dtype=np.int32)))
    return GraphBatch(
        x=x, pos=pos, species=species,
        edge_src=t(src), edge_dst=t(dst), edge_attr=tri,
        edge_mask=torch.ones(n_edges, dtype=torch.bool, device=device),
        node_mask=torch.ones(n_nodes, dtype=torch.bool, device=device),
        labels=labels, graph_ids=t(gid),
        n_nodes=n_nodes, n_edges=n_edges, n_graphs=n_graphs,
    )
