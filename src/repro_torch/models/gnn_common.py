"""Shared containers/utilities for the GNN model family.

``GraphBatch`` is the uniform graph on one device: DI-ordered edge arrays +
node features + masks.  Batched small graphs (the ``molecule`` shape) are
flattened with ``graph_ids`` for segment readout; sampled minibatches arrive
as one compacted subgraph of the blocks ``PropGraph.sample`` returns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.nn.layers import init_linear, linear

__all__ = ["GraphBatch", "init_mlp_stack", "mlp_stack", "params_from_numpy", "mlp_shapes",
           "init_shaped", "load_shaped", "remat_call"]

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


def mlp_shapes(dims: Sequence[int]) -> List[dict]:
    """The shapes of ``init_mlp_stack(dims)``'s params."""
    return [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)} for i in range(len(dims) - 1)]


def init_shaped(generator: torch.Generator, shapes: Any, device, *,
                embed_scale: float = 0.5) -> Any:
    """Random f32 params for a tree (dicts and lists) of shapes, as the
    reference's inits draw them: ``"w"`` normal·d_in^-0.5 (d_in =
    shape[-2]; a leading axis is a stack of layers), ``"embed"``
    normal·``embed_scale``, ``"b"`` and ``"bias"`` zeros, ``"scale"`` ones;
    drawn from ``generator`` in tree order, placed on ``device``."""
    def build(tree, key=None):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, key) for v in tree]
        if key in ("b", "bias"):
            return torch.zeros(tree, device=device)
        if key == "scale":
            return torch.ones(tree, device=device)
        scale = embed_scale if key == "embed" else 1.0 / math.sqrt(tree[-2])
        draw = torch.randn(tree, generator=generator, device=generator.device) * scale
        return draw.to(device)

    return build(shapes)


def load_shaped(tree: Any, shapes: Any, device, *,
                dtype: Callable[[str], torch.dtype] = lambda key: torch.float32,
                path: str = "") -> Any:
    """The reference's param tree as numpy → tensors on ``device`` (each
    leaf in ``dtype(its key)``), every key, list length and shape checked
    against ``shapes``."""
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'params'}: keys {got}, config wants {sorted(shapes)}")
        return {k: load_shaped(tree[k], shapes[k], device, dtype=dtype,
                               path=f"{path}.{k}" if path else k) for k in shapes}
    if isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            raise ValueError(f"{path}: want {len(shapes)} entries")
        return [load_shaped(t, w, device, dtype=dtype, path=f"{path}[{i}]")
                for i, (t, w) in enumerate(zip(tree, shapes))]
    a = np.asarray(tree)
    if tuple(a.shape) != tuple(shapes):
        raise ValueError(f"{path}: shape {tuple(a.shape)}, config wants {tuple(shapes)}")
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype(path.rsplit(".", 1)[-1]))


def remat_call(fn: Callable, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    autograd records it, as the reference checkpoints a block: only the
    inputs are kept and ``fn`` runs again in the backward."""
    tensors = [t for t in _leaves(args) if torch.is_tensor(t)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
