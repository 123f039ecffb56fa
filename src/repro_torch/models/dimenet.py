"""DimeNet (arXiv:2003.03123) — directional message passing with triplet gather.

The port of the reference's ``models/dimenet.py``.  Config: 6 interaction
blocks, d_hidden=128, 8 bilinear units, 7 spherical × 6 radial basis
functions.

Messages live on directed edges; each interaction refines m_ji from all
m_kj (k ∈ N(j)\\{i}) weighted by a (distance, angle) basis.  The triplet
lists (kj_edge, ji_edge, valid) are inputs built by the data pipeline
(``data/graph.build_triplets``) and arrive as ``batch.edge_attr`` (T, 3).

The reference's basis simplification is kept: spherical Bessel j_l is
replaced by its sin(nπd/c)/d radial family and Y_l0 by Legendre P_l(cos α);
the bilinear interaction uses the DimeNet++ down-projected form.

Gathers go through ``graph/segment_ops.gather_rows`` and aggregation
through ``segment_sum`` (over DTensors their sharded forms): ids outside
[0, n) are dropped from a sum, as the reference's ``segment_sum`` drops
them, and gradients follow the reference's transpose.  The reference runs
this model through XLA (no Pallas kernel), so the port runs torch ops.  Each block runs under
``torch.utils.checkpoint`` when a gradient is taken, as the reference
checkpoints each block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.core.device import resolve_device
from repro_torch.graph.segment_ops import gather_rows, segment_sum
from repro_torch.models.gnn_common import (GraphBatch, init_shaped, load_shaped, mlp_shapes,
                                           mlp_stack, remat_call)
from repro_torch.nn.layers import linear

__all__ = ["DimeNetConfig", "init_params", "params_from_reference", "forward", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    n_species: int = 16
    r_cut: float = 5.0
    dtype: torch.dtype = torch.float32


def _rbf(d: torch.Tensor, n: int, c: float) -> torch.Tensor:
    d = torch.clamp(d, min=1e-6)
    k = torch.arange(1, n + 1, dtype=torch.float32, device=d.device)
    return torch.sin(k * math.pi * d[:, None] / c) / d[:, None]


def _legendre(cos_a: torch.Tensor, l_max: int) -> torch.Tensor:
    """P_0..P_{l_max-1}(cos α) via recurrence. (T,) → (T, l_max)."""
    ps = [torch.ones_like(cos_a)]
    if l_max > 1:
        ps.append(cos_a)
    for l in range(2, l_max):  # noqa: E741
        ps.append(((2 * l - 1) * cos_a * ps[-1] - (l - 1) * ps[-2]) / l)
    # dim 1, the last: torch 2.11's DTensor places a stack on -1 of row-split rows as Shard(1)
    return torch.stack(ps, dim=1)


def _sbf(d_kj: torch.Tensor, cos_a: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    """(T, n_spherical·n_radial) separable distance×angle basis."""
    rad = _rbf(d_kj, cfg.n_radial, cfg.r_cut)  # (T, n_radial)
    ang = _legendre(cos_a, cfg.n_spherical)     # (T, n_spherical)
    return (rad[:, None, :] * ang[:, :, None]).reshape(d_kj.shape[0], -1)


def _shapes(cfg: DimeNetConfig) -> Dict:
    d, b = cfg.d_hidden, cfg.n_bilinear
    lin = lambda d_in, d_out: {"w": (d_in, d_out)}  # noqa: E731
    block = {"msg_mlp": mlp_shapes([d, d, d]), "w_down": lin(d, b),
             "w_sbf": lin(cfg.n_spherical * cfg.n_radial, b), "w_up": lin(b, d),
             "rbf_gate": lin(cfg.n_radial, d), "out_mlp": mlp_shapes([d, d])}
    return {"embed": (cfg.n_species, d),
            "edge_embed": mlp_shapes([2 * d + cfg.n_radial, d, d]),
            "out_rbf": lin(cfg.n_radial, d),
            "readout": mlp_shapes([d, d // 2, 1]),
            "blocks": [block for _ in range(cfg.n_blocks)]}


def init_params(generator: torch.Generator, cfg: DimeNetConfig, *, device=None) -> Dict:
    """Random params drawn from ``generator`` as the reference draws them
    (species embedding normal·0.5, linears normal·d_in^-0.5, zero biases),
    placed on ``device`` (None: the CUDA card)."""
    return init_shaped(generator, _shapes(cfg), resolve_device(device))


def params_from_reference(params: Dict, cfg: DimeNetConfig, device=None) -> Dict:
    """The reference's param tree as numpy → the port's, on ``device``
    (None: the CUDA card); every shape is checked against ``cfg``."""
    return load_shaped(params, _shapes(cfg), resolve_device(device))


def forward(params: Dict, batch: GraphBatch, cfg: DimeNetConfig) -> torch.Tensor:
    """Per-graph energies (n_graphs,).  ``batch.edge_attr`` holds the
    triplets (T, 3): [kj_edge, ji_edge, valid]."""
    src, dst, emask = batch.edge_src, batch.edge_dst, batch.edge_mask
    n_e = batch.n_edges
    r = gather_rows(batch.pos, dst) - gather_rows(batch.pos, src)
    d = torch.linalg.norm(r, dim=-1)
    rbf = _rbf(d, cfg.n_radial, cfg.r_cut) * emask[:, None]

    t_kj = batch.edge_attr[:, 0].to(torch.int32)
    t_ji = batch.edge_attr[:, 1].to(torch.int32)
    t_mask = batch.edge_attr[:, 2].to(cfg.dtype)

    # the angle at the shared vertex j between edges (k→j) and (j→i):
    # r of (k→j) is pos[j] - pos[k], so j→k is -r; r of (j→i) is j→i
    v_kj = -gather_rows(r, t_kj)
    v_ji = gather_rows(r, t_ji)
    n_kj = torch.linalg.norm(v_kj, dim=-1)
    cos_a = torch.sum(v_kj * v_ji, -1) / torch.clamp(n_kj * torch.linalg.norm(v_ji, dim=-1),
                                                      min=1e-6)
    sbf = _sbf(n_kj, cos_a, cfg) * t_mask[:, None]

    h = gather_rows(params["embed"], batch.species)
    m = mlp_stack(params["edge_embed"],
                  torch.cat([gather_rows(h, src), gather_rows(h, dst), rbf], -1))

    def block(m, bp):
        m2 = mlp_stack(bp["msg_mlp"], m)
        t = linear(bp["w_down"], gather_rows(m2, t_kj))  # (T, B)
        s = linear(bp["w_sbf"], sbf)                     # (T, B)
        inter = linear(bp["w_up"], t * s) * t_mask[:, None]
        agg = segment_sum(inter, t_ji, n_e)              # sum over k → edge ji
        gate = torch.sigmoid(linear(bp["rbf_gate"], rbf))
        return m + mlp_stack(bp["out_mlp"], (m2 + agg) * gate)

    for bp in params["blocks"]:
        m = remat_call(block, m, bp)

    # per-atom readout: sum incoming messages, gated by the rbf projection
    per_edge = m * linear(params["out_rbf"], rbf)
    h_atom = segment_sum(per_edge * emask[:, None], dst, batch.n_nodes)
    e_atom = mlp_stack(params["readout"], h_atom)[:, 0] * batch.node_mask
    return segment_sum(e_atom, batch.graph_ids, batch.n_graphs)


def loss_fn(params: Dict, batch: GraphBatch, cfg: DimeNetConfig) -> torch.Tensor:
    e = forward(params, batch, cfg)
    return torch.mean((e - batch.labels.to(e.dtype)) ** 2)
