"""GraphCast (arXiv:2212.12794) — encoder-processor-decoder mesh GNN.

The port of the reference's ``models/graphcast.py``.  Config: 16 processor
layers, d_hidden=512, 227 variables, sum aggregation, bf16 activations.

Structure: a grid→mesh encoder (a bipartite interaction network), the mesh
processor (``n_layers`` interaction networks whose params are stacked on a
leading layer axis), a mesh→grid decoder.  The generic GNN shapes map as
the reference maps them: grid nodes = n_nodes, mesh nodes ≈ n_nodes/4,
g2m/m2g edges = n_edges, mesh edges = n_edges/2 (``data/graph.py``'s
``graphcast_sizes``); edge features (4-d displacement stand-ins) and all
index arrays are inputs.

Each interaction network: e' = MLP([e, h_src, h_dst]); h' = MLP([h, Σ e'])
with residuals and LayerNorm.  As in the reference, the first layers of
both MLPs are split by input (``e@We + (h_src@Ws)[src] + (h_dst@Wd)[dst]``),
so the node projections run at node rows and only their results are
gathered: the same function.  Gathers go through
``graph/segment_ops.gather_rows`` and aggregation through
``segment_sum`` (ids outside [0, n) dropped; over DTensors their sharded
forms); torch ops throughout, as the reference leaves the model to XLA.
Under ``cfg.remat`` each processor layer runs under
``torch.utils.checkpoint`` when a gradient is taken, as the reference
checkpoints its scan body.

The config's sharding axes (``dp_axes``, ``tp_axis``; set by the dry run's
cell builder, ``launch/steps.py``) are the reference's ``_constrain``
hints: over DTensors the mesh node table after the encoder, and the node
and edge tables after each processor step, are placed ``P(dp_axes, tp)``
(rows over the data-parallel axes, the last dim over ``tp_axis`` when it
divides by 16) by ``nn/partition.constrain``, inside the checkpointed
step.  Under them the MLPs run as GSPMD splits them around such tables
(``_tp_params``): the products that read a split table row-parallel over
``tp_axis``, the next column-parallel, each on a local chunk of a weight
the param specs leave whole there.  On plain tensors, or with no axes set,
none of this changes anything.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.device import resolve_device
from repro_torch.graph.segment_ops import gather_rows, segment_sum
from repro_torch.models.gnn_common import (init_shaped, load_shaped, mlp_shapes, mlp_stack,
                                           remat_call)
from repro_torch.nn.layers import layernorm, matmul
from repro_torch.nn.partition import P, constrain

__all__ = ["GraphCastConfig", "GCBatch", "init_params", "params_from_reference", "forward",
           "loss_fn"]


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    d_edge: int = 4
    mesh_refinement: int = 6
    aggregator: str = "sum"
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # the reference's sharding hints (``_constrain``): the data-parallel axes, the TP axis
    dp_axes: Any = None
    tp_axis: Any = None


_GC_TENSORS = ("grid_x", "g2m_src", "g2m_dst", "g2m_attr", "mesh_src", "mesh_dst", "mesh_attr",
               "m2g_src", "m2g_dst", "m2g_attr", "targets")


@dataclasses.dataclass(frozen=True)
class GCBatch:
    grid_x: torch.Tensor      # (Ng, n_vars)
    g2m_src: torch.Tensor     # (Eg2m,) grid ids
    g2m_dst: torch.Tensor     # (Eg2m,) mesh ids
    g2m_attr: torch.Tensor    # (Eg2m, d_edge)
    mesh_src: torch.Tensor
    mesh_dst: torch.Tensor
    mesh_attr: torch.Tensor   # (Em, d_edge)
    m2g_src: torch.Tensor     # mesh ids
    m2g_dst: torch.Tensor     # grid ids
    m2g_attr: torch.Tensor
    targets: torch.Tensor     # (Ng, n_vars)
    n_grid: int
    n_mesh: int
    n_g2m: int
    n_mesh_e: int
    n_m2g: int

    def to(self, device) -> "GCBatch":
        """The same batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{f: getattr(self, f).to(device) for f in _GC_TENSORS})


def _interaction_shapes(d: int, d_edge_in: int) -> Dict:
    return {"edge_mlp": mlp_shapes([2 * d + d_edge_in, d, d]),
            "node_mlp": mlp_shapes([2 * d, d, d]),
            "ln_e": {"scale": (d,), "bias": (d,)},
            "ln_n": {"scale": (d,), "bias": (d,)}}


def _stacked(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stacked(v, n) for v in tree]
    return (n,) + tuple(tree)


def _shapes(cfg: GraphCastConfig) -> Dict:
    d = cfg.d_hidden
    return {"grid_embed": mlp_shapes([cfg.n_vars, d, d]),
            "mesh_embed": mlp_shapes([cfg.d_edge, d, d]),
            "edge_embed_g2m": mlp_shapes([cfg.d_edge, d, d]),
            "edge_embed_mesh": mlp_shapes([cfg.d_edge, d, d]),
            "edge_embed_m2g": mlp_shapes([cfg.d_edge, d, d]),
            "encoder": _interaction_shapes(d, d),
            "processor": _stacked(_interaction_shapes(d, d), cfg.n_layers),
            "decoder": _interaction_shapes(d, d),
            "out_mlp": mlp_shapes([d, d, cfg.n_vars])}


def init_params(generator: torch.Generator, cfg: GraphCastConfig, *, device=None) -> Dict:
    """Random f32 params drawn from ``generator`` as the reference draws
    them (linears normal·d_in^-0.5, zero biases, unit LayerNorm scales; the
    processor's stacked on a leading layer axis), placed on ``device``
    (None: the CUDA card).  Activations run in ``cfg.dtype``."""
    return init_shaped(generator, _shapes(cfg), resolve_device(device))


def params_from_reference(params: Dict, cfg: GraphCastConfig, device=None) -> Dict:
    """The reference's param tree as numpy → the port's, on ``device``
    (None: the CUDA card); every shape is checked against ``cfg``."""
    return load_shaped(params, _shapes(cfg), resolve_device(device))


def _interaction(p: Dict, h_src, h_dst, e, src, dst, n_dst: int, tp=None):
    """One bipartite interaction step → (h_dst', e').  ``tp``: the axis
    the first layers' per-input weights are split over by rows (row-parallel
    on the hinted tables' split features, ``_tp_params``)."""
    w, b = p["edge_mlp"][0]["w"], p["edge_mlp"][0].get("b")
    d_e, d = e.shape[-1], h_src.shape[-1]
    we, ws, wd = (_tp_split(t, 0, tp) for t in (w[:d_e], w[d_e:d_e + d], w[d_e + d:]))
    z = (matmul(e, we.to(e.dtype))
         + gather_rows(matmul(h_src, ws.to(h_src.dtype)), src)
         + gather_rows(matmul(h_dst, wd.to(h_dst.dtype)), dst))
    if b is not None:
        z = z + b.to(z.dtype)
    z = F.silu(z)
    e_new = layernorm(p["ln_e"], mlp_stack(p["edge_mlp"][1:], z))
    agg = segment_sum(e_new, dst, n_dst)

    wn, bn = p["node_mlp"][0]["w"], p["node_mlp"][0].get("b")
    wh, wa = _tp_split(wn[:d], 0, tp), _tp_split(wn[d:], 0, tp)
    zn = matmul(h_dst, wh.to(h_dst.dtype)) + matmul(agg, wa.to(agg.dtype))
    if bn is not None:
        zn = zn + bn.to(zn.dtype)
    zn = F.silu(zn)
    h_new = layernorm(p["ln_n"], mlp_stack(p["node_mlp"][1:], zn))
    return h_dst + h_new, e_new


def _layer_params(tree, i: int):
    """Processor layer ``i``'s params (views of the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layer_params(v, i) for v in tree]
    return tree[i]


def _constrain(x: torch.Tensor, cfg: GraphCastConfig) -> torch.Tensor:
    """The reference's ``_constrain``: rows over ``dp_axes``, the last dim
    of a 2-D table over ``tp_axis`` when it divides by 16; nothing without
    ``dp_axes`` or on a plain tensor."""
    if cfg.dp_axes is None:
        return x
    tp = cfg.tp_axis if (x.dim() == 2 and x.shape[-1] % 16 == 0) else None
    return constrain(x, P(cfg.dp_axes, *([tp] + [None] * (x.dim() - 2))))


def _tp_split(t, dim: int, tp_axis):
    """``t`` split on ``dim`` over ``tp_axis`` where the specs leave it
    whole and the split divides (a local chunk: no collective); else as it
    is (a plain tensor, no axis, a split weight)."""
    if not isinstance(t, DTensor) or tp_axis is None:
        return t
    mesh = t.device_mesh
    m = mesh.mesh_dim_names.index(tp_axis)
    if t.placements[m] != Replicate() or t.shape[dim] % mesh.size(m):
        return t
    want = list(t.placements)
    want[m] = Shard(dim % t.dim())
    return t.redistribute(mesh, want)


def _tp_params(params: Dict, cfg: GraphCastConfig) -> Dict:
    """The MLP weights split over ``tp_axis`` as GSPMD splits them around
    the hinted tables (module docstring): an embedding MLP's second layer
    column-parallel (its first, on 4 or ``n_vars`` inputs, whole); each
    interaction's first layers (split by input, ``_interaction``) and the
    output MLP's first row-parallel, their second column-parallel."""
    tp = cfg.tp_axis

    def col(lp):
        return {"w": _tp_split(lp["w"], -1, tp), "b": _tp_split(lp["b"], -1, tp)}

    def interaction(p):
        return {**p, "edge_mlp": [p["edge_mlp"][0], col(p["edge_mlp"][1])],
                "node_mlp": [p["node_mlp"][0], col(p["node_mlp"][1])]}

    out = {k: [v[0], col(v[1])] if k.endswith("_embed") or k.startswith("edge_embed") else v
           for k, v in params.items()}
    for k in ("encoder", "processor", "decoder"):
        out[k] = interaction(params[k])
    first, second = params["out_mlp"]
    out["out_mlp"] = [{"w": _tp_split(first["w"], -2, tp), "b": first["b"]}, col(second)]
    return out


def forward(params: Dict, b: GCBatch, cfg: GraphCastConfig) -> torch.Tensor:
    """Predicted grid variables (Ng, n_vars), f32."""
    dt = cfg.dtype
    if cfg.dp_axes is not None:
        params = _tp_params(params, cfg)
    hg = mlp_stack(params["grid_embed"], b.grid_x.to(dt))
    # mesh nodes initialized from aggregated static g2m attrs (positional proxy)
    hm = segment_sum(mlp_stack(params["mesh_embed"], b.g2m_attr.to(dt)), b.g2m_dst, b.n_mesh)

    # encode grid → mesh
    e_g2m = mlp_stack(params["edge_embed_g2m"], b.g2m_attr.to(dt))
    tp = cfg.tp_axis if cfg.dp_axes is not None else None
    hm, _ = _interaction(params["encoder"], hg, hm, e_g2m, b.g2m_src, b.g2m_dst, b.n_mesh, tp)
    hm = _constrain(hm, cfg)

    # process on the mesh, one layer of the stacked params at a time
    e = mlp_stack(params["edge_embed_mesh"], b.mesh_attr.to(dt))

    def body(hm, e, lp):
        hm, e = _interaction(lp, hm, hm, e, b.mesh_src, b.mesh_dst, b.n_mesh, tp)
        return _constrain(hm, cfg), _constrain(e, cfg)

    for i in range(cfg.n_layers):
        lp = _layer_params(params["processor"], i)
        hm, e = remat_call(body, hm, e, lp) if cfg.remat else body(hm, e, lp)

    # decode mesh → grid
    e_m2g = mlp_stack(params["edge_embed_m2g"], b.m2g_attr.to(dt))
    hg, _ = _interaction(params["decoder"], hm, hg, e_m2g, b.m2g_src, b.m2g_dst, b.n_grid, tp)
    return mlp_stack(params["out_mlp"], hg).to(torch.float32)


def loss_fn(params: Dict, b: GCBatch, cfg: GraphCastConfig) -> torch.Tensor:
    pred = forward(params, b, cfg)
    return torch.mean((pred - b.targets.to(pred.dtype)) ** 2)
