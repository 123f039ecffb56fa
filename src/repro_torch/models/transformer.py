"""Decoder-only transformer — the reference's LM family.

One implementation, config-selected features:
  * GQA (n_kv_heads < n_heads), RoPE, optional QKV bias (Qwen2)
  * sliding-window attention + local/global layer alternation (Gemma-2)
  * attention and final logit softcaps, post-norms, GeGLU (Gemma-2)
  * mixture-of-experts FFNs (Mixtral, DBRX): ``n_experts`` set gives each
    layer a ``"moe"`` subtree in place of ``"mlp"`` and runs
    ``nn/moe.py``'s ``moe_ffn`` over the layer's B·S tokens (decode: its B
    tokens); the layers' Switch aux losses, summed and divided by
    ``n_layers``, are ``forward``'s second output and add 0.01·aux to the
    loss.  Routing is decided by deterministic ops (a stable sort), so a
    rematerialized group routes as it did in the forward.

Layers are grouped into a repeating *pattern* (``("local", "global")`` for
Gemma-2).  Params keep the reference's layout: ``groups`` holds one dict per
pattern position whose tensors carry a leading ``n_groups`` axis, and the
reference's ``scan`` over groups is a Python loop: layer ``g·len(pattern)
+ i`` is group ``g`` at position ``i``.  Prefill attention goes through
``nn/attention.py``, which on the card runs the CUDA kernel B6
(``flash_attention``) whatever ``cfg.attn_impl`` says; decode attends in
plain torch (``_decode_attend``) against ring-buffer KV caches for windowed
layers (cache length = window) and linear caches for global layers.
Decode writes the new K/V into the cache tensors in place (the reference's
``dynamic_update_slice`` returns new arrays): the caches are the largest
tensors of a long decode.

Token ids are read as the reference's ``embed[tokens]`` reads them: ids in
[-V, -1] wrap, ids past V-1 read row V-1 and ids below -V read row 0.

Training: with ``cfg.remat`` (the reference's default) each pattern group
of ``forward`` runs under ``torch.utils.checkpoint`` (non-reentrant) when a
gradient is being taken, as the reference checkpoints its scan body:
``remat_policy="full"`` keeps only the group's input and recomputes
the group in the backward; ``"dots"`` keeps the outputs of the matrix
products without batch dims (the projections, the dense FFN and the MoE
router, ``aten.mm``; not the experts' batched products) and recomputes the
rest, as ``dots_with_no_batch_dims_saveable``.  A recomputed
layer launches B6's forward again on the card.

Partitioned (DTensor params and tokens, one rank's program on a device
mesh: ``launch/dryrun.py``): the reference's sharding hints are honoured
by ``nn/partition.constrain``, a ``redistribute`` of a DTensor and a
no-op on a plain tensor — ``forward``'s sequence-parallel carry,
``P(batch_shard_axes, seq_shard_axis, None)`` after each layer, and the
MoE's dispatch specs (``nn/moe.py``).  Where DTensor has no sharding rule
the rank's shard runs under ``local_map``: the embedding gather from the
vocab-sharded table (each rank reads the rows it holds, a partial sum over
``model``), the true-label logit of the vocab-sharded logits (likewise),
decode's cache write on a sequence split over ``model`` (the rank holding
the slot writes it, its split softmax reduced over the shards), the
loss's log-sum-exp (each rank's max and sum of exp, all-reduced) and
attention (``nn/attention.py``).  Products are Megatron's
(``nn/layers.matmul``), each block's input gathered off the carry and its
output put back on it (``_gathered``, ``_reduced``).  Plain tensors take
none of these paths.

Params are plain dicts of tensors; ``Transformer`` wraps them in an
``nn.Module``.  Matrices are held in ``cfg.dtype`` and norm scales in f32
(``init_params``, ``params_from_reference``): the same function as the
reference's f32 params, which it casts to the activations' dtype at every
use and reads norm scales from in f32.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils import checkpoint as _ckpt

from repro_torch.core.device import resolve_device
from repro_torch.kernels.seg_mm.ref import gather_ids, gather_rows, in_range
from repro_torch.models.gnn_common import load_shaped
from repro_torch.nn.attention import attention
from repro_torch.nn.layers import label_logits, linear, matmul, mlp, rmsnorm, rope, softcap
from repro_torch.nn.moe import moe_ffn
from repro_torch.nn.partition import P, constrain, local_shard, mesh_placements

__all__ = ["TransformerConfig", "Transformer", "init_params", "params_from_reference",
           "forward", "loss_fn", "prefill", "decode_step", "init_cache"]


REMAT_POLICIES = ("full", "dots")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # attention features
    rope_theta: float = 10000.0
    window: Optional[int] = None            # sliding-window width for local layers
    pattern: Tuple[str, ...] = ("global",)  # repeating layer pattern
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    post_norms: bool = False                # gemma-2 post-attn/post-ffn norms
    # ffn
    act: str = "silu"
    gated: bool = True
    # moe (None ⇒ dense); the sharding axes are hints (``nn/moe.py``)
    n_experts: Optional[int] = None
    top_k: int = 2
    moe_renorm: str = "topk"
    capacity_factor: float = 1.25
    moe_groups: int = 1
    moe_dp_axes: Optional[Tuple[str, ...]] = None
    moe_expert_axis: Optional[str] = None
    moe_tp_axis: Optional[str] = None
    moe_virtual_split: int = 1
    # sequence and batch sharding: the sequence-parallel carry's hint
    seq_shard_axis: Optional[str] = None
    batch_shard_axes: Optional[Tuple[str, ...]] = None
    # embedding
    scale_embed: bool = False               # gemma multiplies by sqrt(d)
    tie_embeddings: bool = False
    # numerics / runtime
    dtype: Any = torch.bfloat16
    attn_impl: str = "auto"
    attn_chunk: int = 1024
    loss_chunk: int = 1024                  # sequence chunking for lm-head+loss
    remat: bool = True                      # recompute each pattern group in the backward
    remat_policy: str = "full"              # "full", or "dots": keep the matmul outputs

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"{self.name}: remat_policy {self.remat_policy!r} is not one of "
                             f"{REMAT_POLICIES}")

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (self.n_layers, self.pattern)
        return self.n_layers // len(self.pattern)

    def layer_window(self, kind: str) -> Optional[int]:
        return self.window if kind == "local" else None

    def _counts(self, experts_used: Optional[int]) -> int:
        c = self
        attn = (c.d_model * c.d_head * (c.n_heads + 2 * c.n_kv_heads)
                + c.n_heads * c.d_head * c.d_model)
        mats = 3 if c.gated else 2
        if c.n_experts:
            ffn = experts_used * c.d_model * c.d_ff * mats + c.d_model * c.n_experts
        else:
            ffn = c.d_model * c.d_ff * mats
        per_layer = attn + ffn + 2 * c.d_model
        embed = c.vocab * c.d_model * (1 if c.tie_embeddings else 2)
        return c.n_layers * per_layer + embed

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6·N·D roofline accounting)."""
        return self._counts(self.n_experts)

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        return self._counts(self.top_k)


# --------------------------------------------------------------------------- init
def _layer_shapes(cfg: TransformerConfig) -> Dict:
    """One layer's param shapes (without the leading n_groups axis)."""
    d, hq, hkv, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff

    def lin(d_in, d_out, bias=False):
        return {"w": (d_in, d_out), **({"b": (d_out,)} if bias else {})}

    s = {"ln1": {"scale": (d,)},
         "wq": lin(d, hq * dh, cfg.qkv_bias),
         "wk": lin(d, hkv * dh, cfg.qkv_bias),
         "wv": lin(d, hkv * dh, cfg.qkv_bias),
         "wo": lin(hq * dh, d),
         "ln2": {"scale": (d,)}}
    if cfg.n_experts:
        ev, ffv = cfg.n_experts * cfg.moe_virtual_split, ff // cfg.moe_virtual_split
        s["moe"] = {"router": lin(d, cfg.n_experts), "up": (ev, d, ffv), "down": (ev, ffv, d),
                    **({"gate": (ev, d, ffv)} if cfg.gated else {})}
    else:
        s["mlp"] = {"up": lin(d, ff), "down": lin(ff, d), **({"gate": lin(d, ff)} if cfg.gated
                                                            else {})}
    if cfg.post_norms:
        s["ln1b"] = {"scale": (d,)}
        s["ln2b"] = {"scale": (d,)}
    return s


def _shapes(cfg: TransformerConfig) -> Dict:
    """The whole param tree's shapes, the reference's layout."""
    def stack(tree):
        return {k: stack(v) if isinstance(v, dict) else (cfg.n_groups,) + v
                for k, v in tree.items()}

    s = {"embed": (cfg.vocab, cfg.d_model),
         "groups": [stack(_layer_shapes(cfg)) for _ in cfg.pattern],
         "final_norm": {"scale": (cfg.d_model,)}}
    if not cfg.tie_embeddings:
        s["lm_head"] = {"w": (cfg.d_model, cfg.vocab)}
    return s


def _leaf_dtype(key: str, cfg: TransformerConfig) -> torch.dtype:
    return torch.float32 if key == "scale" else cfg.dtype


def init_params(generator: torch.Generator, cfg: TransformerConfig, device=None) -> Dict:
    """Random params drawn from ``generator`` (on its device), placed on
    ``device`` (None: the CUDA card): the reference's init (embed
    normal·0.02, linears and experts' up/gate normal·d_in^-0.5, experts'
    down normal·d_ff^-0.5, zero biases, unit norm scales).  Matrices are
    drawn in f32 one group slice at a time and held in ``cfg.dtype``; draw
    on the card with a CUDA generator at full size."""
    device = resolve_device(device)

    def leaf(key: str, shape: Tuple[int, ...]) -> torch.Tensor:
        out = torch.empty(shape, dtype=_leaf_dtype(key, cfg), device=device)
        if key == "scale":
            return out.fill_(1.0)
        if key == "b":
            return out.zero_()
        scale = (0.02 if key == "embed" else cfg.d_ff ** -0.5 if key == "down"
                 else 1.0 / math.sqrt(shape[-2]))
        grouped = len(shape) >= 3  # every leaf under "groups" has the n_groups axis
        for g in range(shape[0] if grouped else 1):
            draw = torch.randn(shape[1:] if grouped else shape, generator=generator,
                               dtype=torch.float32, device=generator.device).mul_(scale)
            (out[g] if grouped else out).copy_(draw)
        return out

    def build(tree, key=None):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, key) for v in tree]
        return leaf(key, tree)

    return build(_shapes(cfg))


def params_from_reference(params: Dict, cfg: TransformerConfig, device=None) -> Dict:
    """The reference's param tree as numpy (``embed``, ``groups`` — one dict
    per pattern position with a leading n_groups axis — ``final_norm`` and
    ``lm_head`` unless tied) → the port's, on ``device`` (None: the CUDA
    card).  Every shape is checked against ``cfg``; matrices and biases are
    held in ``cfg.dtype``, norm scales in f32 (module docstring)."""
    return load_shaped(params, _shapes(cfg), resolve_device(device),
                       dtype=lambda key: _leaf_dtype(key, cfg))


def _layer(params: Dict, i: int, g: int) -> Dict:
    """Group ``g``'s params at pattern position ``i`` (views)."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[g] for k, v in tree.items()}

    return take(params["groups"][i])


# ----------------------------------------------------------------------- forward
def _embed(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """``params["embed"][tokens]`` with the reference's index semantics
    (wrap in [-V, -1], clamp elsewhere; a gradient reaches the table only
    from ids in [-V, V), ``gather_rows``), cast to ``cfg.dtype`` and scaled
    by sqrt(d) where the config says so."""
    b, s = tokens.shape
    if isinstance(params["embed"], DTensor):
        x = _embed_partitioned(params["embed"], tokens).to(cfg.dtype)
    else:
        x = gather_rows(params["embed"], tokens.reshape(-1)).reshape(b, s, -1).to(cfg.dtype)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    return x


def _rank_slice(t, placements, dim: int):
    """(start, length) along ``dim`` of this rank's shard of DTensor ``t``
    placed by ``placements``."""
    local, offsets = local_shard(t.shape, placements, t.device_mesh)
    return offsets[dim], local[dim]


def _vocab_pick(src, ids, dim: int, *, src_pl, src_grad, like, index, pick, finish):
    """Entries of the DTensor ``src``, whose dim ``dim`` (the vocabulary)
    is split over ``model``, at the vocabulary ids ``index(ids)``: each
    rank picks (``pick(shard, ids within it)``) those its shard holds and
    gives zeros for the rest, a partial sum over ``model``; ``finish(x,
    ids)`` then marks what the plain path marks.  The embedding gather and
    the true-label logit of the vocab-sharded table and logits."""
    mesh = src.device_mesh
    start, n = _rank_slice(src, src_pl, dim)
    ids_pl = mesh_placements(mesh, dp=Shard(0), like=like)

    def local(s_l, ids_l):
        idx = index(ids_l) - start
        hit = (idx >= 0) & (idx < n)
        x = pick(s_l, torch.where(hit, idx, 0))
        hit = hit.reshape(hit.shape + (1,) * (x.dim() - hit.dim()))
        return finish(torch.where(hit, x, torch.zeros((), dtype=x.dtype, device=x.device)), ids_l)

    return local_map(local, out_placements=(mesh_placements(mesh, dp=Shard(0), model=Partial(),
                                                            like=like),),
                     in_placements=(src_pl, ids_pl), in_grad_placements=(src_grad, ids_pl),
                     device_mesh=mesh, redistribute_inputs=True)(src, ids)


def _embed_partitioned(table, tokens: torch.Tensor):
    """``_embed``'s gather from a DTensor table whose rows are split over
    ``model`` (``_vocab_pick``; the table's other dim gathered over the
    data-parallel axes).  The gradient reaches the rows as ``gather_rows``
    passes it."""
    mesh, n = table.device_mesh, table.shape[0]

    def finish(x, ids):
        if torch.is_grad_enabled() and x.requires_grad:
            x = torch.where(in_range(ids, n)[..., None], x, x.detach())
        return x

    return _vocab_pick(
        table, tokens, 0, src_pl=mesh_placements(mesh, model=Shard(0)),
        src_grad=mesh_placements(mesh, dp=Partial(), model=Shard(0), like=tokens), like=tokens,
        index=lambda ids: gather_ids(ids, n),
        pick=lambda t, idx: gather_rows(t, idx.reshape(-1)).reshape(idx.shape + (-1,)),
        finish=finish)


def _gathered(h, cfg: TransformerConfig):
    """A block's normed input off the sequence-parallel carry: whole
    sequences, the batch still split (Megatron's sequence parallelism; a
    no-op without the carry's hint or on a plain tensor)."""
    if cfg.seq_shard_axis is None:
        return h
    return constrain(h, P(cfg.batch_shard_axes, None, None))


def _reduced(t, cfg: TransformerConfig):
    """A block's output (a DTensor) placed as the residual stream: on the
    sequence-parallel carry where it is hinted (a partial sum over
    ``model`` reduce-scattered, a whole one split, so that its gradient
    comes back whole), else with any partial sum reduced (an all-reduce).
    Anything else as it is."""
    if not isinstance(t, DTensor):
        return t
    if cfg.seq_shard_axis is not None:
        return constrain(t, P(cfg.batch_shard_axes, cfg.seq_shard_axis, None))
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def _heads(t, n: int, dh: int, *, merge: bool = False):
    """(B, S, n·dh) → (B, S, n, dh), or back with ``merge``.  A DTensor
    whose n heads do not divide over ``model`` is first gathered there:
    its shards split heads, or split them unevenly."""
    b, s = t.shape[:2]
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        if n % mesh.size(mesh.mesh_dim_names.index("model")):
            t = t.redistribute(mesh, [Replicate() if a == "model" else p
                                      for a, p in zip(mesh.mesh_dim_names, t.placements)])
    return t.reshape(b, s, n * dh) if merge else t.reshape(b, s, n, dh)


def _attn_block(lp: Dict, x: torch.Tensor, cfg: TransformerConfig, kind: str, *,
                positions: torch.Tensor, cache=None):
    """Pre-norm attention with an optional cache write and read.  Returns
    (y, new_kv); with a cache, ``new_kv`` is the cache's own tensors,
    updated in place."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = _gathered(rmsnorm(lp["ln1"], x, plus_one=cfg.post_norms), cfg)
    q = _heads(linear(lp["wq"], h), hq, dh)
    k = _heads(linear(lp["wk"], h), hkv, dh)
    v = _heads(linear(lp["wv"], h), hkv, dh)
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    window = cfg.layer_window(kind)

    if cache is None:
        o = attention(q, k, v, causal=True, window=window, cap=cfg.attn_softcap,
                      impl=cfg.attn_impl, chunk=cfg.attn_chunk)
        new_kv = (k, v)
    else:
        ck, cv, cur = cache  # ck: (B, Scache, hkv, dh); cur: absolute position (int)
        sc = ck.shape[1]
        ring = window is not None and sc == window
        slot = cur % window if ring else cur
        slot = min(max(slot, 0), sc - s)  # dynamic_update_slice clamps its start
        if isinstance(ck, DTensor):
            o = _decode_partitioned(q, k, v, ck, cv, cur, slot, window if ring else None, cfg)
        else:
            ck[:, slot:slot + s] = k.to(ck.dtype)
            cv[:, slot:slot + s] = v.to(cv.dtype)
            k_pos, valid = _slot_positions(torch.arange(sc, device=x.device), cur,
                                           window if ring else None)
            o = _decode_attend(q, ck, cv, k_pos, valid, cur, cfg)
        new_kv = (ck, cv)

    o = _reduced(linear(lp["wo"], _heads(o, hq, dh, merge=True)), cfg)
    if cfg.post_norms:
        o = rmsnorm(lp["ln1b"], o, plus_one=True)
    return o, new_kv


def _slot_positions(i: torch.Tensor, cur: int, ring_window: Optional[int]):
    """(absolute position, holds a written position) of cache slots ``i``:
    in a ring buffer of ``ring_window`` slots, slot i holds position
    cur - ((cur - i) mod W); in a linear cache, position i."""
    if ring_window is not None:
        k_pos = cur - torch.remainder(cur - i, ring_window)
        return k_pos, k_pos >= 0
    return i, i <= cur


def _decode_scores(q: torch.Tensor, ck: torch.Tensor, k_pos: torch.Tensor,
                   valid: torch.Tensor, cur: int, cfg: TransformerConfig) -> torch.Tensor:
    """Decode's scores (B, Hkv, G, 1, Sc) against a (possibly
    ring-buffered) cache with explicit per-slot absolute positions, -1e30
    where a slot holds no position up to ``cur``.  Products in the cache's
    dtype, sums in f32, as the reference's ``preferred_element_type``."""
    b, sq, hq, dh = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh).to(ck.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     ck.to(torch.float32)) * (dh ** -0.5)
    s = softcap(s, cfg.attn_softcap)
    ok = valid & (k_pos <= cur)
    return torch.where(ok, s, -1e30)


def _decode_values(p: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """The softmax weights ``p`` (B, Hkv, G, 1, Sc) applied to the cache's
    values: (B, 1, Hkv, G, D) in f32."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(cv.dtype).to(torch.float32),
                        cv.to(torch.float32))


def _decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, k_pos: torch.Tensor,
                   valid: torch.Tensor, cur: int, cfg: TransformerConfig) -> torch.Tensor:
    """Direct attention against a (possibly ring-buffered) cache with
    explicit per-slot absolute positions.  q: (B, 1, Hq, D).  Plain torch,
    as the reference leaves it to XLA."""
    p = torch.softmax(_decode_scores(q, ck, k_pos, valid, cur, cfg), dim=-1)
    return _decode_values(p, cv).reshape(q.shape).to(q.dtype)


def _decode_partitioned(q, k, v, ck, cv, cur: int, slot: int, ring_window: Optional[int],
                        cfg: TransformerConfig):
    """Decode's cache write and attention on DTensors, rank by rank: each
    rank holds the cache's batch, sequence and KV-head shards its
    placements give (``launch/sharding.lm_cache_specs``), the rank whose
    sequence shard holds ``slot`` writes the new K/V there, and where the
    sequence is split the softmax is reduced over its shards (a max and
    two sums: all-reduces of (B, H, 1) rows and of the output)."""
    mesh = ck.device_mesh
    c_pl = tuple(ck.placements)
    q_pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in c_pl)
    seq_dims = [d for d, p in enumerate(c_pl) if p == Shard(1)]
    start, n = _rank_slice(ck, c_pl, 1)

    def reduce(t, op):
        for d in seq_dims:
            t = funcol.all_reduce(t, op, (mesh, d))
        return t

    def local(q_l, k_l, v_l, ck_l, cv_l):
        if start <= slot < start + n:
            ck_l[:, slot - start:slot - start + 1] = k_l.to(ck_l.dtype)
            cv_l[:, slot - start:slot - start + 1] = v_l.to(cv_l.dtype)
        k_pos, valid = _slot_positions(start + torch.arange(n, device=q_l.device), cur,
                                       ring_window)
        if not seq_dims:
            return _decode_attend(q_l, ck_l, cv_l, k_pos, valid, cur, cfg)
        # the softmax over the sequence's shards: their max, then their sums
        s = _decode_scores(q_l, ck_l, k_pos, valid, cur, cfg)
        p = torch.exp(s - reduce(s.amax(dim=-1, keepdim=True), "max"))
        o = _decode_values(p / reduce(p.sum(dim=-1, keepdim=True), "sum"), cv_l)
        return reduce(o, "sum").reshape(q_l.shape).to(q_l.dtype)

    return local_map(local, out_placements=(q_pl,), in_placements=(q_pl, q_pl, q_pl, c_pl, c_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v, ck, cv)


def _ffn_block(lp: Dict, x: torch.Tensor, cfg: TransformerConfig):
    h = _gathered(rmsnorm(lp["ln2"], x, plus_one=cfg.post_norms), cfg)
    if cfg.n_experts:  # as the reference, the experts' activation is moe_ffn's silu
        b, s, d = h.shape
        shard_axes = None
        if cfg.moe_dp_axes is not None:
            shard_axes = {"dp": cfg.moe_dp_axes, "expert": cfg.moe_expert_axis,
                          "tp": cfg.moe_tp_axis}
        y, aux = moe_ffn(lp["moe"], h.reshape(b * s, d), top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, renorm=cfg.moe_renorm,
                         n_groups=cfg.moe_groups, virtual_split=cfg.moe_virtual_split,
                         shard_axes=shard_axes)
        y = y.reshape(b, s, d)
    else:
        y, aux = mlp(lp["mlp"], h, act=cfg.act), 0.0
    y = _reduced(y, cfg)
    if cfg.post_norms:
        y = rmsnorm(lp["ln2b"], y, plus_one=True)
    return y, aux


def _group(params: Dict, g: int, x: torch.Tensor, positions: torch.Tensor,
           cfg: TransformerConfig):
    """Pattern group ``g`` (the reference's scan body): (x, its aux losses).
    Each layer's output takes the sequence-parallel carry's hint."""
    sp = (None if cfg.seq_shard_axis is None
          else P(cfg.batch_shard_axes, cfg.seq_shard_axis, None))
    aux = 0.0
    for i, kind in enumerate(cfg.pattern):
        lp = _layer(params, i, g)
        a, _ = _attn_block(lp, x, cfg, kind, positions=positions)
        x = x + a
        f, a_aux = _ffn_block(lp, x, cfg)
        x = constrain(x + f, sp)
        aux = aux + a_aux
    return x, aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)  # matmuls with no batch dims


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig):
    """A group checkpointed per ``cfg.remat_policy``."""
    if cfg.remat_policy == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(_ckpt.checkpoint, _group, use_reentrant=False, context_fn=ctx)
    return functools.partial(_ckpt.checkpoint, _group, use_reentrant=False)


def forward(params: Dict, tokens: torch.Tensor,
            cfg: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward.  tokens: (B, S) → (hidden (B, S, D), aux_loss).
    Under autograd each pattern group is rematerialized per ``cfg.remat``
    (module docstring)."""
    _, s = tokens.shape
    x = _reduced(_embed(params, tokens, cfg), cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    aux = 0.0
    records = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for _, t in _flatten(params["groups"], "")))
    group = _remat(cfg) if cfg.remat and records else _group
    for g in range(cfg.n_groups):
        x, g_aux = group(params, g, x, positions, cfg)
        aux = aux + g_aux
    x = rmsnorm(params["final_norm"], x, plus_one=cfg.post_norms)
    if torch.is_tensor(aux):  # the MoE layers' losses, with their gradient
        return x, (aux / cfg.n_layers).to(torch.float32)
    # a fill, not torch.tensor: no host-to-device copy waits on the card here
    return x, torch.full((), aux / cfg.n_layers, dtype=torch.float32, device=x.device)


def _logits(params: Dict, h: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    lg = matmul(h, w.to(h.dtype))
    return softcap(lg, cfg.final_softcap)


def loss_fn(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Chunked LM loss: the (B, S, V) logits are never materialized; the
    head and softmax run per sequence chunk.  As the reference, the tail
    past the last whole chunk is left out, and a label outside [-V, V)
    makes the loss NaN (``label_logits``)."""
    h, aux = forward(params, tokens, cfg)
    b, s, _ = h.shape
    chunk = min(cfg.loss_chunk, s)
    n_chunks = s // chunk
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        hb = h[:, c * chunk:(c + 1) * chunk]
        lb = labels[:, c * chunk:(c + 1) * chunk].to(torch.int64)
        lg = _logits(params, hb, cfg).to(torch.float32)
        if isinstance(lg, DTensor):
            lse, true = _lse_partitioned(lg), _label_logits_partitioned(lg, lb)
        else:
            lse, true = torch.logsumexp(lg, dim=-1), label_logits(lg, lb)
        tot = tot + torch.sum(lse - true)
    loss = tot / (b * n_chunks * chunk)
    return loss + 0.01 * aux


def _lse_partitioned(lg):
    """Log-sum-exp over the last dim of DTensor logits whose vocab dim is
    split over ``model``: each rank's max (an all-reduce of the max, held
    constant, which leaves the value and its gradient those of
    ``logsumexp``), then each rank's sum of exp (an all-reduce of the sum).
    The rank's shard stays local in the backward too."""
    mesh = lg.device_mesh
    lg_pl = mesh_placements(mesh, dp=Shard(0), model=Shard(lg.dim() - 1), like=lg)
    row = mesh_placements(mesh, dp=Shard(0), like=lg)
    m = local_map(lambda x: x.amax(dim=-1, keepdim=True),
                  out_placements=(mesh_placements(mesh, dp=Shard(0), model=Partial("max"),
                                                  like=lg),),
                  in_placements=(lg_pl,), device_mesh=mesh,
                  redistribute_inputs=True)(lg.detach())
    m = m.redistribute(mesh, row)
    e = local_map(lambda x, mx: torch.sum(torch.exp(x - mx), dim=-1, keepdim=True),
                  out_placements=(mesh_placements(mesh, dp=Shard(0), model=Partial(),
                                                  like=lg),),
                  in_placements=(lg_pl, row), device_mesh=mesh,
                  redistribute_inputs=True)(lg, m)
    return (m + torch.log(e.redistribute(mesh, row)))[..., 0]


def _label_logits_partitioned(lg, labels: torch.Tensor):
    """``label_logits`` of DTensor logits whose vocab dim is split over
    ``model`` (``_vocab_pick``; NaN for a label outside [-V, V) as
    ``label_logits`` gives it)."""
    c = lg.shape[-1]
    lg_pl = mesh_placements(lg.device_mesh, dp=Shard(0), model=Shard(lg.dim() - 1), like=lg)
    return _vocab_pick(
        lg, labels, lg.dim() - 1, src_pl=lg_pl, src_grad=lg_pl, like=lg,
        index=lambda lb: torch.where(lb < 0, lb + c, lb),
        pick=lambda t, idx: torch.gather(t, -1, idx[..., None])[..., 0],
        finish=lambda x, lb: x.masked_fill(~in_range(lb, c), float("nan")))


# ------------------------------------------------------------------------ decode
def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """Stacked caches per pattern position, on ``device`` (None: the CUDA
    card).  Windowed layers get ring buffers of length min(window,
    max_len); global layers full max_len.  ``cur`` (the next position) is
    a Python int."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    caches: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.pattern):
        w = cfg.layer_window(kind)
        length = min(w, max_len) if w is not None else max_len
        shape = (cfg.n_groups, batch, length, cfg.n_kv_heads, cfg.d_head)
        caches[f"pos{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                             "v": torch.zeros(shape, dtype=dtype, device=device)}
    caches["cur"] = 0
    return caches


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """One decode step.  tokens: (B, 1) → (logits (B, 1, V), new cache).
    The new cache holds the old one's K/V tensors, written in place, and
    ``cur + 1``."""
    b, s = tokens.shape
    assert s == 1
    cur = int(cache["cur"])
    if isinstance(tokens, DTensor):  # the batch split as the cache splits it
        c_pl = cache["pos0"]["k"].placements
        tokens = tokens.redistribute(tokens.device_mesh,
                                     [Shard(0) if p == Shard(1) else Replicate() for p in c_pl])
    x = _reduced(_embed(params, tokens, cfg), cfg)
    positions = torch.full((b, 1), cur, dtype=torch.int32, device=x.device)
    for g in range(cfg.n_groups):
        for i, kind in enumerate(cfg.pattern):
            lp = _layer(params, i, g)
            c = cache[f"pos{i}"]
            a, _ = _attn_block(lp, x, cfg, kind, positions=positions,
                               cache=(c["k"][g], c["v"][g], cur))
            x = x + a
            f, _ = _ffn_block(lp, x, cfg)
            x = x + f
    x = rmsnorm(params["final_norm"], x, plus_one=cfg.post_norms)
    logits = _logits(params, x, cfg)
    new_cache = {k: v for k, v in cache.items() if k != "cur"}
    new_cache["cur"] = cur + 1
    return logits, new_cache


def prefill(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Prefill forward: the last position's logits (B, 1, V).  As in the
    reference, the cache write-back is left out."""
    h, _ = forward(params, tokens, cfg)
    return _logits(params, h[:, -1:, :], cfg)


class Transformer(torch.nn.Module):
    """The model as an ``nn.Module`` over a params dict:
    ``Transformer(cfg, params)(tokens)`` gives :func:`forward`'s hidden
    states; ``prefill``, ``init_cache`` and ``decode_step`` are the
    module-level functions on the module's params."""

    def __init__(self, cfg: TransformerConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        self.weights = torch.nn.ParameterDict(
            {name: torch.nn.Parameter(t, requires_grad=False)
             for name, t in _flatten(params, "")})

    def params(self) -> Dict:
        return _unflatten({k: v for k, v in self.weights.items()},
                          len(self.cfg.pattern))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg)[0]

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        return prefill(self.params(), tokens, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return init_cache(self.cfg, batch, max_len, device=self.weights["embed"].device)

    def decode_step(self, cache: Dict, tokens: torch.Tensor):
        return decode_step(self.params(), cache, tokens, self.cfg)


def _flatten(tree, prefix: str):
    """(name, tensor) pairs of a params tree; names join keys with '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _unflatten(flat: Dict[str, torch.Tensor], n_pattern: int) -> Dict:
    tree: Dict[str, Any] = {"groups": [{} for _ in range(n_pattern)]}
    for name, t in flat.items():
        parts = name.split("/")
        node = tree["groups"][int(parts[1])] if parts[0] == "groups" else tree
        keys = parts[2:] if parts[0] == "groups" else parts
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return tree
