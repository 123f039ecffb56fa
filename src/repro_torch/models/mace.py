"""MACE (arXiv:2206.07697) — higher-order E(3)-equivariant message passing.

The port of the reference's ``models/mace.py``.  Config: 2 layers, 128
channels, l_max=2, correlation order 3, 8 radial Bessel functions.

Irreps are carried in Cartesian form, as in the reference: l=0 scalars
(N, C), l=1 vectors (N, C, 3), l=2 traceless-symmetric matrices (N, C, 3,
3), so every tensor product is an isotropic ``einsum``.  The Cartesian maps
are the Clebsch-Gordan couplings for l ≤ 2:

    1⊗1→0: v·w        1⊗1→1: v×w        1⊗1→2: sym-traceless(v⊗w)
    2⊗1→1: M·v        2⊗2→0: tr(M·N)    2⊗2→2: sym-traceless(M·N)

The ACE product basis (correlation order 3) is built from symmetric
products of the per-atom A-features by that table, channel-mixed by
learnable weights (the reference's simplification of full MACE).

Gathers go through ``graph/segment_ops.gather_rows`` and aggregation
through ``segment_sum`` (ids outside [0, n) dropped, the reference's
gradient rule; over DTensors their sharded forms, the radial weights made
whole on their last dim before the per-l reshape); torch ops throughout, as the reference leaves
the model to XLA.  Each layer runs under ``torch.utils.checkpoint`` when a
gradient is taken, as the reference checkpoints each layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.device import resolve_device
from repro_torch.graph.segment_ops import gather_rows, segment_sum
from repro_torch.models.gnn_common import (GraphBatch, init_shaped, load_shaped, mlp_shapes,
                                           mlp_stack, remat_call)
from repro_torch.nn.layers import linear
from repro_torch.nn.partition import unsplit

__all__ = ["MACEConfig", "init_params", "params_from_reference", "forward", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    channels: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    n_species: int = 16
    r_cut: float = 5.0
    dtype: torch.dtype = torch.float32


def _bessel(d: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Radial Bessel basis sin(nπd/rc)/d with a smooth cutoff envelope."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    rbf = torch.sin(n * math.pi * d[:, None] / r_cut) / d[:, None]
    u = torch.clamp(d / r_cut, 0, 1)
    env = 1 - 10 * u**3 + 15 * u**4 - 6 * u**5  # polynomial cutoff
    return rbf * env[:, None]


def _sym_traceless(t: torch.Tensor) -> torch.Tensor:
    """Project (…, 3, 3) onto the l=2 (traceless symmetric) component."""
    s = 0.5 * (t + t.transpose(-1, -2))
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    # over DTensors a masked sum: torch 2.11's DTensor has no rule for diagonal's backward
    if isinstance(s, DTensor):
        tr = (s * eye).sum((-2, -1))[..., None, None]
    else:
        tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return s - tr * eye / 3.0


def _shapes(cfg: MACEConfig) -> Dict:
    c = cfg.channels
    layer = {"radial": mlp_shapes([cfg.n_rbf, 64, 3 * c]),  # per-l weights
             "mix0": {"w": (7 * c, c), "b": (c,)},
             "mix1": {"w": (5 * c, c)},
             "mix2": {"w": (4 * c, c)},
             "update0": mlp_shapes([2 * c, c, c])}
    return {"embed": (cfg.n_species, c),
            "layers": [layer for _ in range(cfg.n_layers)],
            "readout": mlp_shapes([c, c // 2, 1])}


def init_params(generator: torch.Generator, cfg: MACEConfig, *, device=None) -> Dict:
    """Random params drawn from ``generator`` as the reference draws them
    (species embedding normal·0.5, linears normal·d_in^-0.5, zero biases),
    placed on ``device`` (None: the CUDA card)."""
    return init_shaped(generator, _shapes(cfg), resolve_device(device))


def params_from_reference(params: Dict, cfg: MACEConfig, device=None) -> Dict:
    """The reference's param tree as numpy → the port's, on ``device``
    (None: the CUDA card); every shape is checked against ``cfg``."""
    return load_shaped(params, _shapes(cfg), resolve_device(device))


def _layer(lp: Dict, h0, h1, h2, batch: GraphBatch, cfg: MACEConfig):
    """One MACE interaction: A-features (density), then the order-3
    product basis."""
    c = cfg.channels
    src, dst, emask = batch.edge_src, batch.edge_dst, batch.edge_mask
    r = gather_rows(batch.pos, dst) - gather_rows(batch.pos, src)  # (E, 3)
    d = torch.linalg.norm(r, dim=-1)
    rhat = r / torch.clamp(d, min=1e-6)[:, None]
    y1 = rhat                                                       # (E, 3) l=1
    y2 = _sym_traceless(rhat[:, :, None] * rhat[:, None, :])        # (E, 3, 3) l=2

    rbf = _bessel(d, cfg.n_rbf, cfg.r_cut) * emask[:, None]
    rw = unsplit(mlp_stack(lp["radial"], rbf), -1).reshape(-1, 3, c)  # (E, l, C)

    hsrc = gather_rows(h0, src)  # (E, C) scalar neighbour features
    w0, w1, w2 = rw[:, 0] * hsrc, rw[:, 1] * hsrc, rw[:, 2] * hsrc
    n = batch.n_nodes
    a0 = segment_sum(w0, dst, n)                                   # (N, C)
    a1 = segment_sum(w1[:, :, None] * y1[:, None, :], dst, n)      # (N, C, 3)
    a2 = segment_sum(w2[:, :, None, None] * y2[:, None], dst, n)   # (N, C, 3, 3)

    # ACE product basis, correlation ≤ 3 (Cartesian CG table)
    n11_0 = torch.einsum("ncd,ncd->nc", a1, a1)                  # |A1|²        (ν=2)
    n22_0 = torch.einsum("ncde,ncde->nc", a2, a2)                # tr(A2²)      (ν=2)
    a2v_1 = torch.einsum("ncde,nce->ncd", a2, a1)                # A2·A1  l=1   (ν=2)
    c121_0 = torch.einsum("ncd,ncd->nc", a2v_1, a1)              # A1·A2·A1     (ν=3)
    t11_2 = _sym_traceless(a1[..., :, None] * a1[..., None, :])  # A1⊗A1 l=2    (ν=2)
    c112_0 = torch.einsum("ncde,ncde->nc", t11_2, a2)            # (A1⊗A1)·A2   (ν=3)

    b0 = torch.cat([a0, a0 * a0, a0 * a0 * a0, n11_0, n22_0, c121_0, c112_0],
                   dim=-1)  # (N, 7C) invariants up to ν=3
    b1 = torch.cat([a1, a0[..., None] * a1, a2v_1, n11_0[..., None] * a1,
                    (a0 * a0)[..., None] * a1], dim=1)  # (N, 5C, 3) l=1, ν≤3
    m22_2 = _sym_traceless(torch.einsum("ncde,ncef->ncdf", a2, a2))
    b2 = torch.cat([a2, a0[..., None, None] * a2, t11_2, m22_2], dim=1)  # (N, 4C, 3, 3)

    msg0 = linear(lp["mix0"], b0)
    msg1 = torch.einsum("nkd,kc->ncd", b1, lp["mix1"]["w"])
    msg2 = torch.einsum("nkde,kc->ncde", b2, lp["mix2"]["w"])

    h0_new = h0 + mlp_stack(lp["update0"], torch.cat([h0, msg0], -1))
    return h0_new, h1 + msg1, h2 + msg2


def forward(params: Dict, batch: GraphBatch, cfg: MACEConfig) -> torch.Tensor:
    """Per-graph energies (n_graphs,)."""
    c, n = cfg.channels, batch.n_nodes
    h0 = gather_rows(params["embed"], batch.species)
    h1 = torch.zeros((n, c, 3), dtype=cfg.dtype, device=h0.device)
    h2 = torch.zeros((n, c, 3, 3), dtype=cfg.dtype, device=h0.device)
    for lp in params["layers"]:
        h0, h1, h2 = remat_call(lambda lp, h0, h1, h2: _layer(lp, h0, h1, h2, batch, cfg),
                                lp, h0, h1, h2)
    e_atom = mlp_stack(params["readout"], h0)[:, 0] * batch.node_mask
    return segment_sum(e_atom, batch.graph_ids, batch.n_graphs)


def loss_fn(params: Dict, batch: GraphBatch, cfg: MACEConfig) -> torch.Tensor:
    e = forward(params, batch, cfg)
    return torch.mean((e - batch.labels.to(e.dtype)) ** 2)
