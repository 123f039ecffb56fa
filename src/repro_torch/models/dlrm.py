"""DLRM RM2 (arXiv:1906.00091) — sparse embedding tables + dot interaction.

Assigned config: 13 dense features, 26 sparse fields, embed_dim=64,
bottom MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction.

The embedding lookup is the hot path: on the card it is always the CUDA
kernel B4 (``kernels/embedding_bag``: mean-pooled multi-hot gather, the
DIP-LIST query generalized from OR-mask to a sum), on the CPU its plain
PyTorch version.  ``embed_impl`` ('take' | 'kernel') is kept and checked
for parity with the reference's config; both values take that one route.
Both keep the reference's index semantics (wrap in [-V, -1], NaN beyond).  The MLPs are the reference's, SiLU
between layers; float32 matmuls run without TF32 on the card.

``retrieval_cand`` scores one query against 10⁶ candidates: one matvec
against the candidate matrix (``torch.matmul``, as the reference leaves it
to XLA) + a stable descending sort (``lax.top_k``'s order of ties).

Over DTensors (one rank's program on the production mesh,
``launch/dryrun.py``) the tables' rows are split over ``model``: each rank
runs B4 on its own slice as a row window (``embedding_bag_fields(...,
window=(V, row_lo))``: a row outside it adds nothing, an id outside [-V, V)
still makes its bag NaN, the divisor stays MH) on its own batch rows, so
its bags are a ``Partial`` sum over ``model``, and B4's backward writes the
slice's rows.  ``_interact`` runs on each rank's whole bags
(``nn/partition.local_call``: the partial bags all-reduced first).
``retrieval_scores`` scores each rank's candidates, keeps its own top-k
(global ids), all-gathers the (value, id) pairs and selects the top-k of
those by one stable descending sort of the id-ordered pairs, so ties go to
the lower global id as on one device.

Params are a dict ``{"tables", "bot", "top"}``; ``params_from_reference``
loads the reference's param tree (numpy) so both packages compute the same
function.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.device import resolve_device
from repro_torch.kernels.embedding_bag import ops as _ops
from repro_torch.models.gnn_common import init_mlp_stack, mlp_stack, params_from_numpy
from repro_torch.nn.partition import as_dtensor, local_call, local_shard, mesh_of

__all__ = ["DLRMConfig", "init_params", "params_from_reference", "forward", "loss_fn",
           "retrieval_scores"]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_size: int = 1_000_000       # rows per table
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    interaction: str = "dot"
    multi_hot: int = 1                # indices per bag (1 ⇒ one-hot lookup)
    dtype: Any = torch.float32
    embed_impl: str = "take"          # 'take' | 'kernel': both run B4 on the card

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def top_in(self) -> int:
        return self.n_interact + self.embed_dim


def _top_dims(cfg: DLRMConfig) -> Tuple[int, ...]:
    return (cfg.top_in,) + tuple(cfg.top_mlp[1:])


def init_params(generator: torch.Generator, cfg: DLRMConfig, *, device=None) -> Dict:
    """Random params drawn from ``generator`` (tables ``randn · D^-0.5``),
    placed on ``device`` (None: the CUDA card).  Draw on the card with a
    CUDA generator: RM2's tables are 6.66 GB."""
    device = resolve_device(device)
    tables = torch.randn((cfg.n_sparse, cfg.vocab_size, cfg.embed_dim), generator=generator,
                         device=generator.device).mul_(cfg.embed_dim ** -0.5)
    mlps = {"bot": init_mlp_stack(generator, list(cfg.bot_mlp)),
            "top": init_mlp_stack(generator, list(_top_dims(cfg)))}
    return {"tables": tables.to(device),
            **{k: [{n: t.to(device) for n, t in lp.items()} for lp in v]
               for k, v in mlps.items()}}


def _check_stack(layers: Sequence[Dict], dims: Sequence[int], what: str) -> None:
    if len(layers) != len(dims) - 1:
        raise ValueError(f"{what}: {len(layers)} layers for dims {tuple(dims)}")
    for i, lp in enumerate(layers):
        if tuple(lp["w"].shape) != (dims[i], dims[i + 1]) or tuple(lp["b"].shape) != (dims[i + 1],):
            raise ValueError(f"{what} layer {i}: w {tuple(lp['w'].shape)}, "
                             f"b {tuple(lp['b'].shape)} do not fit {dims[i]}→{dims[i + 1]}")


def params_from_reference(params: Dict, cfg: DLRMConfig, device=None) -> Dict:
    """The reference's DLRM params as numpy (``{"tables", "bot", "top"}``)
    → the port's, on ``device`` (None: the CUDA card); shapes are checked
    against ``cfg``."""
    want = (cfg.n_sparse, cfg.vocab_size, cfg.embed_dim)
    if tuple(params["tables"].shape) != want:
        raise ValueError(f"tables {tuple(params['tables'].shape)}, config wants {want}")
    _check_stack(params["bot"], cfg.bot_mlp, "bot")
    _check_stack(params["top"], _top_dims(cfg), "top")
    return params_from_numpy({k: params[k] for k in ("tables", "bot", "top")},
                             resolve_device(device))


def _embedding_bag(tables: torch.Tensor, idx: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """idx: (B, n_sparse, multi_hot) → (B, n_sparse, embed_dim) mean bags:
    B4 on CUDA tensors, its plain version on CPU ones."""
    if cfg.embed_impl not in ("take", "kernel"):
        raise ValueError(f"embed_impl must be 'take' or 'kernel', got {cfg.embed_impl!r}")
    if isinstance(tables, DTensor):
        return _windowed_bags(tables, idx)
    return _ops.embedding_bag_fields(tables, idx)


def _windowed_bags(tables: DTensor, idx) -> DTensor:
    """B4 on this rank's row slice of the tables as a row window, on its
    batch rows (module docstring): the (B, F, D) bags, a ``Partial`` sum on
    each mesh dim that splits the rows, split as ``idx`` elsewhere.  The
    slice's gradient is a ``Partial`` sum where the batch is split."""
    mesh = tables.device_mesh
    idx = as_dtensor(idx, mesh)
    out, grad = [], []
    for tp, ip in zip(tables.placements, idx.placements):
        if tp == Shard(1):
            if ip != Replicate():
                raise ValueError(f"a rank's ids {idx.placements} must be whole on the mesh dim "
                                 f"that splits the tables' rows {tables.placements}")
            out.append(Partial())
            grad.append(tp)
        elif isinstance(tp, Shard):
            raise ValueError(f"tables placed {tables.placements}: only their rows may be split")
        else:
            out.append(ip if ip == Shard(0) else Replicate())
            grad.append(Partial() if ip == Shard(0) else Replicate())
    _, offsets = local_shard(tables.shape, tables.placements, mesh)
    window = (tables.shape[1], offsets[1])
    b, f, _ = idx.shape
    return local_call(lambda t, i: _ops.embedding_bag_fields(t, i, window=window), (tables, idx),
                      (tables.placements, idx.placements), (grad, None), tuple(out),
                      (b, f, tables.shape[2]))


def _interact(dense_emb: torch.Tensor, sparse_emb: torch.Tensor) -> torch.Tensor:
    """Dot interaction: pairwise dots of the 27 embedding vectors, the
    upper triangle in row-major order (``jnp.triu_indices(f, k=1)``'s).
    Over DTensors each rank runs it on its batch rows' whole vectors."""
    if isinstance(dense_emb, DTensor) or isinstance(sparse_emb, DTensor):
        mesh = mesh_of(dense_emb, sparse_emb)
        dense_emb, sparse_emb = as_dtensor(dense_emb, mesh), as_dtensor(sparse_emb, mesh)
        rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in dense_emb.placements)
        f = sparse_emb.shape[1] + 1
        return local_call(_interact, (dense_emb, sparse_emb), (rows, rows), (rows, rows), rows,
                          (dense_emb.shape[0], f * (f - 1) // 2))
    z = torch.cat([dense_emb[:, None, :], sparse_emb], dim=1)  # (B, F, D)
    zz = torch.bmm(z, z.transpose(1, 2))
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=z.device)
    return zz[:, iu, ju]  # (B, F(F-1)/2)


def forward(params: Dict, dense: torch.Tensor, sparse_idx: torch.Tensor,
            cfg: DLRMConfig) -> torch.Tensor:
    """dense: (B, 13) f32; sparse_idx: (B, 26, multi_hot) int32 → (B,) logits."""
    d = mlp_stack(params["bot"], dense.to(cfg.dtype), final_act=True)  # (B, 64)
    s = _embedding_bag(params["tables"], sparse_idx, cfg).to(cfg.dtype)
    inter = _interact(d, s)
    top_in = torch.cat([d, inter], dim=-1)
    return mlp_stack(params["top"], top_in)[:, 0]


def loss_fn(params: Dict, dense, sparse_idx, labels, cfg: DLRMConfig) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in the reference's stable form."""
    logit = forward(params, dense, sparse_idx, cfg).to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def retrieval_scores(params: Dict, dense: torch.Tensor, sparse_idx: torch.Tensor,
                     candidates: torch.Tensor, cfg: DLRMConfig, *, top_k: int = 100):
    """Score one query against (n_cand, embed_dim) candidates: matvec +
    top-k.  dense: (1, 13); sparse_idx: (1, 26, mh).  Returns (values (k,)
    f32, indices (k,) int64), best first and, among equal scores, the lower
    index first, as ``lax.top_k`` orders them (a stable descending sort)."""
    d = mlp_stack(params["bot"], dense.to(cfg.dtype), final_act=True)
    s = _embedding_bag(params["tables"], sparse_idx, cfg).to(cfg.dtype)
    q = d + torch.sum(s, dim=1)  # (1, D) pooled query embedding
    if isinstance(q, DTensor):  # whole on every rank, beside its own candidates
        q = q.redistribute(q.device_mesh, [Replicate()] * q.device_mesh.ndim)
    scores = (candidates.to(cfg.dtype) @ q[0]).to(torch.float32)  # (n_cand,)
    if not 0 <= top_k <= scores.shape[0]:
        raise ValueError(f"top_k must lie in [0, {scores.shape[0]}], got {top_k}")
    if isinstance(scores, DTensor):
        return _sharded_top_k(scores, top_k)
    vals, ids = torch.sort(scores, descending=True, stable=True)
    return vals[:top_k], ids[:top_k]


def _sharded_top_k(scores: DTensor, top_k: int):
    """The top-k of scores split over the mesh (module docstring): each
    rank's own k best (ids made global) all-gathered, then ordered by id
    and stably by value, descending: ties to the lower global id.  The
    values and ids come back whole on every rank (plain tensors)."""
    mesh = scores.device_mesh
    n = scores.shape[0]
    split = tuple(scores.placements)
    if any(p not in (Shard(0), Replicate()) for p in split):
        raise ValueError(f"scores placed {split}: top-k takes them split on their one dim")
    shape, (offset,) = local_shard((n,), split, mesh)
    parts = math.prod(mesh.size(m) for m, p in enumerate(split) if p == Shard(0))
    k = min(top_k, -(-n // parts))  # each rank's share, padded alike on every rank
    local = scores.to_local()
    vals, ids = torch.sort(local, descending=True, stable=True)
    pad = k - min(k, shape[0])
    vals = torch.cat([vals[:k], vals.new_full((pad,), float("-inf"))])
    ids = torch.cat([ids[:k] + offset, ids.new_full((pad,), n)])  # pads: after every real id
    gathered = [DTensor.from_local(t, mesh, split, run_check=False,
                                   shape=torch.Size((k * parts,)), stride=(1,))
                .redistribute(mesh, [Replicate()] * mesh.ndim).to_local() for t in (vals, ids)]
    by_id = torch.argsort(gathered[1], stable=True)
    vals, ids = gathered[0][by_id], gathered[1][by_id]
    order = torch.argsort(vals, descending=True, stable=True)[:top_k]
    return vals[order], ids[order]
