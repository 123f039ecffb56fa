"""GAT (arXiv:1710.10903) and GraphSAGE (arXiv:1706.02216) over DI edges:
the SDDMM → segment-softmax → SpMM regime.

Both run on the plain segment ops of ``graph/segment_ops.py`` (``index_add_``
and ``scatter_reduce``); neither reaches a CUDA kernel of this package.
``params_from_reference`` loads the reference's GAT or GraphSAGE param tree
(nested dicts and lists of numpy arrays), chosen by the config's type.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.graph.segment_ops import (gather_rows, gather_scatter, segment_softmax,
                                          segment_sum)
from repro_torch.models.gcn import node_nll
from repro_torch.models.gnn_common import GraphBatch, params_from_numpy
from repro_torch.nn.layers import init_linear, linear

__all__ = ["GATConfig", "SAGEConfig", "init_gat", "gat_forward", "gat_loss", "init_sage",
           "sage_forward", "sage_loss", "params_from_reference"]


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: torch.dtype = torch.float32


def _gat_shapes(cfg: GATConfig):
    dims_in = [cfg.d_in] + [cfg.d_hidden * cfg.n_heads] * (cfg.n_layers - 1)
    dims_out = [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    heads = [cfg.n_heads] * (cfg.n_layers - 1) + [1]
    return dims_in, dims_out, heads


def init_gat(generator: torch.Generator, cfg: GATConfig, *, device=None) -> Dict:
    """Random params drawn from ``generator``, placed on ``device`` (None:
    the CUDA card)."""
    dims_in, dims_out, heads = _gat_shapes(cfg)
    device = resolve_device(device)
    g = generator.device
    layers = []
    for i in range(cfg.n_layers):
        layers.append({
            "w": {k: v.to(device) for k, v in
                  init_linear(generator, dims_in[i], heads[i] * dims_out[i]).items()},
            "a_src": (torch.randn((heads[i], dims_out[i]), generator=generator, device=g)
                      * 0.1).to(device),
            "a_dst": (torch.randn((heads[i], dims_out[i]), generator=generator, device=g)
                      * 0.1).to(device),
        })
    return {"layers": layers}


def _gat_from_reference(params: Dict, cfg: GATConfig, device) -> Dict:
    dims_in, dims_out, heads = _gat_shapes(cfg)
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
    for i, lp in enumerate(layers):
        want = {"w": (dims_in[i], heads[i] * dims_out[i]), "a_src": (heads[i], dims_out[i]),
                "a_dst": (heads[i], dims_out[i])}
        got = {"w": tuple(lp["w"]["w"].shape), "a_src": tuple(lp["a_src"].shape),
               "a_dst": tuple(lp["a_dst"].shape)}
        if got != want:
            raise ValueError(f"layer {i}: shapes {got} do not fit the config's {want}")
    return params_from_numpy(
        {"layers": [{"w": {"w": lp["w"]["w"]}, "a_src": lp["a_src"], "a_dst": lp["a_dst"]}
                    for lp in layers]}, resolve_device(device))


def gat_forward(params: Dict, batch: GraphBatch, cfg: GATConfig) -> torch.Tensor:
    x = batch.x.to(cfg.dtype)
    n = batch.n_nodes
    # ids outside [0, n) read the rows the reference's gathers read, and pass a
    # gradient back only from [-n, n) (gather_rows)
    src, dst = batch.edge_src, batch.edge_dst
    _, dims_out, heads = _gat_shapes(cfg)
    emask = batch.edge_mask[:, None]
    for i, lp in enumerate(params["layers"]):
        h = linear(lp["w"], x).reshape(n, heads[i], dims_out[i])  # (N, H, D)
        # SDDMM: per-edge attention logits from endpoint projections
        e_src = gather_rows(torch.einsum("nhd,hd->nh", h, lp["a_src"]), src)  # (E, H)
        e_dst = gather_rows(torch.einsum("nhd,hd->nh", h, lp["a_dst"]), dst)
        logits = F.leaky_relu(e_src + e_dst, cfg.negative_slope)
        logits = torch.where(emask, logits, torch.full_like(logits, -1e30))
        # segment softmax per destination, per head
        alpha = segment_softmax(logits, batch.edge_dst, n)
        alpha = alpha * emask.to(alpha.dtype)
        # SpMM: attention-weighted aggregation
        msgs = gather_rows(h, src) * alpha[:, :, None]
        agg = segment_sum(msgs, batch.edge_dst, n)  # (N, H, D)
        x = agg.reshape(n, heads[i] * dims_out[i])
        if i < cfg.n_layers - 1:
            x = F.elu(x)
    return x  # (N, n_classes)


def gat_loss(params: Dict, batch: GraphBatch, cfg: GATConfig) -> torch.Tensor:
    return node_nll(gat_forward(params, batch, cfg), batch)


# ------------------------------------------------------------------ GraphSAGE
@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 64
    n_classes: int = 41
    aggregator: str = "mean"   # 'mean' | 'max'
    dtype: torch.dtype = torch.float32


def _sage_dims(cfg: SAGEConfig) -> List[int]:
    return [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


def init_sage(generator: torch.Generator, cfg: SAGEConfig, *, device=None) -> Dict:
    """Random params drawn from ``generator``, placed on ``device`` (None:
    the CUDA card)."""
    dims = _sage_dims(cfg)
    device = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        w_self = init_linear(generator, dims[i], dims[i + 1], bias=True)
        w_nbr = init_linear(generator, dims[i], dims[i + 1])
        layers.append({"w_self": {k: v.to(device) for k, v in w_self.items()},
                       "w_nbr": {k: v.to(device) for k, v in w_nbr.items()}})
    return {"layers": layers}


def _sage_from_reference(params: Dict, cfg: SAGEConfig, device) -> Dict:
    dims = _sage_dims(cfg)
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
    for i, lp in enumerate(layers):
        want = {"self_w": (dims[i], dims[i + 1]), "self_b": (dims[i + 1],),
                "nbr_w": (dims[i], dims[i + 1])}
        got = {"self_w": tuple(lp["w_self"]["w"].shape), "self_b": tuple(lp["w_self"]["b"].shape),
               "nbr_w": tuple(lp["w_nbr"]["w"].shape)}
        if got != want:
            raise ValueError(f"layer {i}: shapes {got} do not fit the config's {want}")
    return params_from_numpy(
        {"layers": [{"w_self": {"w": lp["w_self"]["w"], "b": lp["w_self"]["b"]},
                     "w_nbr": {"w": lp["w_nbr"]["w"]}} for lp in layers]},
        resolve_device(device))


def sage_forward(params: Dict, batch: GraphBatch, cfg: SAGEConfig) -> torch.Tensor:
    x = batch.x.to(cfg.dtype)
    for i, lp in enumerate(params["layers"]):
        agg = gather_scatter(x, batch.edge_src, batch.edge_dst, batch.n_nodes,
                             agg=cfg.aggregator,
                             edge_weight=batch.edge_mask.to(cfg.dtype))
        x = linear(lp["w_self"], x) + linear(lp["w_nbr"], agg)
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
            # L2 normalize (SAGE §3.1)
            x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)
    return x


def sage_loss(params: Dict, batch: GraphBatch, cfg: SAGEConfig) -> torch.Tensor:
    return node_nll(sage_forward(params, batch, cfg), batch)


def params_from_reference(params: Dict, cfg, device=None) -> Dict:
    """The reference's GAT (``cfg`` a ``GATConfig``) or GraphSAGE (a
    ``SAGEConfig``) params as numpy → the port's, on ``device`` (None: the
    CUDA card); shapes are checked against ``cfg``."""
    if isinstance(cfg, GATConfig):
        return _gat_from_reference(params, cfg, device)
    if isinstance(cfg, SAGEConfig):
        return _sage_from_reference(params, cfg, device)
    raise TypeError(f"no GAT or GraphSAGE config: {type(cfg).__name__}")
