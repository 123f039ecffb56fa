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

Params are a dict ``{"tables", "bot", "top"}``; ``params_from_reference``
loads the reference's param tree (numpy) so both packages compute the same
function.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.embedding_bag import ops as _ops
from repro_torch.models.gnn_common import init_mlp_stack, mlp_stack, params_from_numpy

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
    return _ops.embedding_bag_fields(tables, idx)


def _interact(dense_emb: torch.Tensor, sparse_emb: torch.Tensor) -> torch.Tensor:
    """Dot interaction: pairwise dots of the 27 embedding vectors, the
    upper triangle in row-major order (``jnp.triu_indices(f, k=1)``'s)."""
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
    scores = (candidates.to(cfg.dtype) @ q[0]).to(torch.float32)  # (n_cand,)
    if not 0 <= top_k <= scores.shape[0]:
        raise ValueError(f"top_k must lie in [0, {scores.shape[0]}], got {top_k}")
    vals, ids = torch.sort(scores, descending=True, stable=True)
    return vals[:top_k], ids[:top_k]
