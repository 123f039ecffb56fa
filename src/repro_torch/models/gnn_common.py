"""Shared containers/utilities for the GNN model family.

``GraphBatch`` is the uniform graph on one device: DI-ordered edge arrays +
node features + masks.  Batched small graphs (the ``molecule`` shape) are
flattened with ``graph_ids`` for segment readout; sampled minibatches arrive
as one compacted subgraph of the blocks ``PropGraph.sample`` returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.nn.layers import init_linear, linear

__all__ = ["GraphBatch", "init_mlp_stack", "mlp_stack", "params_from_numpy"]

_TENSOR_FIELDS = ("x", "pos", "species", "edge_src", "edge_dst", "edge_attr", "edge_mask",
                  "node_mask", "labels", "graph_ids")


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """One (possibly batched/flattened) graph.

    x:         (N, F) float features, or None (equivariant models use species+pos)
    pos:       (N, 3) positions or None
    species:   (N,) int atomic types or None
    edge_src/edge_dst: (E,) int32 — DI order (sorted by src)
    edge_attr: (E, Fe) or None
    edge_mask: (E,) bool — padding slots False
    node_mask: (N,) bool
    labels:    (N,) node labels / (G,) graph targets / (N, F) regression targets
    graph_ids: (N,) int32 graph membership for readout (zeros if single graph)
    """

    x: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]
    species: Optional[torch.Tensor]
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_attr: Optional[torch.Tensor]
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    labels: torch.Tensor
    graph_ids: torch.Tensor
    n_nodes: int
    n_edges: int
    n_graphs: int

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else getattr(self, f).to(device)
            for f in _TENSOR_FIELDS})


def params_from_numpy(tree: Any, device) -> Any:
    """A nested dict/list tree of numpy arrays → the same tree of tensors
    on ``device`` (each array copied, dtype kept)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def init_mlp_stack(generator: torch.Generator, dims: Sequence[int], *,
                   bias: bool = True) -> List[dict]:
    """[d0→d1→…] MLP params (SiLU between), on the generator's device."""
    return [init_linear(generator, dims[i], dims[i + 1], bias=bias)
            for i in range(len(dims) - 1)]


def mlp_stack(params, x, *, act: Callable = torch.nn.functional.silu,
              final_act: bool = False):
    for i, p in enumerate(params):
        x = linear(p, x)
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x
