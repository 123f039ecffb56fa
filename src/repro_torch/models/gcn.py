"""GCN (Kipf & Welling, arXiv:1609.02907) over DI edge arrays.

The ``gcn-cora`` config: 2 layers, d_hidden=16, sym normalization.
Message passing is the paper's DI aggregation — ``spmm_di``: the CUDA
kernel B5 ``seg_mm`` on the card for either ``spmm_impl``; on the CPU a
plain torch segment sum (``'segment'``) or B5's plain version
(``'kernel'``).

``forward`` computes what the reference's ``forward`` computes, including
two details kept on purpose: the in-degree of the self-loop term counts
padded edges too, and the edge weights are masked after ``degree_norm``
(so padded edges still count in every degree).

Params are a dict ``{"layers": [{"w", "b"}, ...]}``; ``GCN`` wraps them in
an ``nn.Module``.  ``params_from_reference`` loads the reference's param
tree (nested dicts and lists of numpy arrays) so that both packages compute
the same function.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.core.device import resolve_device
from repro_torch.graph.segment_ops import degree_norm, segment_count, spmm_di
from repro_torch.models.gnn_common import GraphBatch, params_from_numpy
from repro_torch.nn.layers import init_linear, label_logits, linear

__all__ = ["GCNConfig", "GCN", "init_params", "params_from_reference", "forward", "loss_fn",
           "node_nll"]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"          # 'sym' | 'rw'
    aggregator: str = "mean"   # kept for config fidelity; norm implies weighting
    dropout: float = 0.0
    spmm_impl: str = "segment"  # 'segment' | 'kernel': both run B5 on the card
    dtype: torch.dtype = torch.float32


def _dims(cfg: GCNConfig) -> List[int]:
    return [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


def init_params(generator: torch.Generator, cfg: GCNConfig, *, device=None) -> Dict:
    """Random params drawn from ``generator``, placed on ``device`` (None:
    the CUDA card)."""
    dims = _dims(cfg)
    device = resolve_device(device)
    layers = [init_linear(generator, dims[i], dims[i + 1], bias=True)
              for i in range(cfg.n_layers)]
    return {"layers": [{k: v.to(device) for k, v in lp.items()} for lp in layers]}


def params_from_reference(params: Dict, cfg: GCNConfig, device=None) -> Dict:
    """The reference's GCN params as numpy (``{"layers": [{"w", "b"}]}``)
    → the port's, on ``device`` (None: the CUDA card); shapes are checked
    against ``cfg``."""
    dims = _dims(cfg)
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
    for i, lp in enumerate(layers):
        if tuple(lp["w"].shape) != (dims[i], dims[i + 1]) or tuple(lp["b"].shape) != (dims[i + 1],):
            raise ValueError(f"layer {i}: w {tuple(lp['w'].shape)}, b {tuple(lp['b'].shape)} "
                             f"do not fit {dims[i]}→{dims[i + 1]}")
    return params_from_numpy({"layers": [{"w": lp["w"], "b": lp["b"]} for lp in layers]},
                             resolve_device(device))


def forward(params: Dict, batch: GraphBatch, cfg: GCNConfig) -> torch.Tensor:
    """Logits (N, n_classes).  Both layers pass the same ``edge_src`` and
    ``edge_dst`` tensors to ``spmm_di``, so on the card B5's layout (the
    dst sort, ``edge_src`` in dst order) is built once per batch and found
    in its cache by the second layer; each layer permutes ``w`` into dst
    order again (one gather of E floats).  Over DTensors (one rank's
    program on a mesh) ``spmm_di`` hands B5 the edges' local tensors
    themselves, so the layout is built once a step there too."""
    x = batch.x.to(cfg.dtype)
    w = degree_norm(batch.edge_src, batch.edge_dst, batch.n_nodes, mode=cfg.norm)
    w = w * batch.edge_mask.to(w.dtype)
    # self loop with 1/(1+deg) weight; deg counts every edge, padded or not
    deg = segment_count(batch.edge_dst, batch.n_nodes, cfg.dtype) + 1.0
    for i, lp in enumerate(params["layers"]):
        x = linear(lp, x)
        # Ã·X·W with self loops: aggregate + self-term (sym-normalized)
        agg = spmm_di(x, batch.edge_src, batch.edge_dst, batch.n_nodes,
                      edge_weight=w, impl=cfg.spmm_impl)
        x = agg + x / deg[:, None]
        if i < len(params["layers"]) - 1:
            x = torch.relu(x)
    return x


def node_nll(logits: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Mean cross-entropy over the nodes of ``batch.node_mask``.  A label
    outside [-C, C) of a node in the mask makes the loss NaN, as in the
    reference (``label_logits``); a node outside the mask adds 0 even then,
    as the reference's product with the bool mask does."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    true = label_logits(logits, batch.labels)
    nll = torch.where(batch.node_mask, lse - true, 0.0)
    return torch.sum(nll) / torch.clamp(torch.sum(batch.node_mask.to(torch.float32)), min=1)


def loss_fn(params: Dict, batch: GraphBatch, cfg: GCNConfig) -> torch.Tensor:
    return node_nll(forward(params, batch, cfg), batch)


class GCN(torch.nn.Module):
    """The GCN as an ``nn.Module`` over a params dict: ``GCN(cfg, params)(batch)``
    gives the logits of :func:`forward`."""

    def __init__(self, cfg: GCNConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        self.layers = torch.nn.ModuleList(
            torch.nn.ParameterDict({k: torch.nn.Parameter(v) for k, v in lp.items()})
            for lp in params["layers"])

    def params(self) -> Dict:
        return {"layers": [dict(lp.items()) for lp in self.layers]}

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        return forward(self.params(), batch, self.cfg)
