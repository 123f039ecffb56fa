"""Decoder-only transformer — the dense part of the reference's LM family.

One implementation, config-selected features:
  * GQA (n_kv_heads < n_heads), RoPE, optional QKV bias (Qwen2)
  * sliding-window attention + local/global layer alternation (Gemma-2)
  * attention and final logit softcaps, post-norms, GeGLU (Gemma-2)

Mixture-of-experts FFNs (Mixtral, DBRX) wait for ROADMAP A13b: a config
with ``n_experts`` set raises ``NotImplementedError``.

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
products without batch dims (the projections and the FFN, ``aten.mm``) and
recomputes the rest, as ``dots_with_no_batch_dims_saveable``.  A recomputed
layer launches B6's forward again on the card.

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

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.core.device import resolve_device
from repro_torch.kernels.seg_mm.ref import gather_rows
from repro_torch.nn.attention import attention
from repro_torch.nn.layers import label_logits, linear, mlp, rmsnorm, rope, softcap

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
    # moe (None ⇒ dense; the experts wait for ROADMAP A13b)
    n_experts: Optional[int] = None
    top_k: int = 2
    moe_renorm: str = "topk"
    capacity_factor: float = 1.25
    moe_groups: int = 1
    moe_dp_axes: Optional[Tuple[str, ...]] = None
    moe_expert_axis: Optional[str] = None
    moe_tp_axis: Optional[str] = None
    moe_virtual_split: int = 1
    # sequence and batch sharding (multi-device training, ROADMAP A15): kept, unused
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


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts FFNs are not ported yet (ROADMAP A13b)")


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
         "ln2": {"scale": (d,)},
         "mlp": {"up": lin(d, ff), "down": lin(ff, d), **({"gate": lin(d, ff)} if cfg.gated
                                                        else {})}}
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
    normal·0.02, linears normal·d_in^-0.5, zero biases, unit norm scales).
    Matrices are drawn in f32 one group slice at a time and held in
    ``cfg.dtype``; draw on the card with a CUDA generator at full size."""
    _dense_only(cfg)
    device = resolve_device(device)

    def leaf(key: str, shape: Tuple[int, ...]) -> torch.Tensor:
        out = torch.empty(shape, dtype=_leaf_dtype(key, cfg), device=device)
        if key == "scale":
            return out.fill_(1.0)
        if key == "b":
            return out.zero_()
        d_in = shape[-2]
        scale = 0.02 if key == "embed" else 1.0 / math.sqrt(d_in)
        for g in range(shape[0] if len(shape) == 3 else 1):
            draw = torch.randn(shape[-2:], generator=generator, dtype=torch.float32,
                               device=generator.device).mul_(scale)
            (out[g] if len(shape) == 3 else out).copy_(draw)
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
    _dense_only(cfg)
    device = resolve_device(device)

    def load(tree, want, path):
        if isinstance(want, dict):
            if not isinstance(tree, dict) or set(tree) != set(want):
                got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, config wants {sorted(want)}")
            return {k: load(tree[k], want[k], f"{path}.{k}" if path else k) for k in want}
        if isinstance(want, list):
            if not isinstance(tree, (list, tuple)) or len(tree) != len(want):
                raise ValueError(f"{path}: want {len(want)} pattern positions")
            return [load(t, w, f"{path}[{i}]") for i, (t, w) in enumerate(zip(tree, want))]
        a = np.asarray(tree)
        if tuple(a.shape) != tuple(want):
            raise ValueError(f"{path}: shape {tuple(a.shape)}, config wants {tuple(want)}")
        key = path.rsplit(".", 1)[-1]
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=_leaf_dtype(key, cfg))

    return load(params, _shapes(cfg), "")


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
    x = gather_rows(params["embed"], tokens.reshape(-1)).reshape(b, s, -1).to(cfg.dtype)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    return x


def _attn_block(lp: Dict, x: torch.Tensor, cfg: TransformerConfig, kind: str, *,
                positions: torch.Tensor, cache=None):
    """Pre-norm attention with an optional cache write and read.  Returns
    (y, new_kv); with a cache, ``new_kv`` is the cache's own tensors,
    updated in place."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rmsnorm(lp["ln1"], x, plus_one=cfg.post_norms)
    q = linear(lp["wq"], h).reshape(b, s, hq, dh)
    k = linear(lp["wk"], h).reshape(b, s, hkv, dh)
    v = linear(lp["wv"], h).reshape(b, s, hkv, dh)
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
        ck[:, slot:slot + s] = k.to(ck.dtype)
        cv[:, slot:slot + s] = v.to(cv.dtype)
        i = torch.arange(sc, device=x.device)
        if ring:
            # ring buffer: slot i holds absolute position cur - ((cur - i) mod W)
            k_pos = cur - torch.remainder(cur - i, window)
            valid = k_pos >= 0
        else:
            k_pos = i
            valid = i <= cur
        o = _decode_attend(q, ck, cv, k_pos, valid, cur, cfg)
        new_kv = (ck, cv)

    o = linear(lp["wo"], o.reshape(b, s, hq * dh))
    if cfg.post_norms:
        o = rmsnorm(lp["ln1b"], o, plus_one=True)
    return o, new_kv


def _decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, k_pos: torch.Tensor,
                   valid: torch.Tensor, cur: int, cfg: TransformerConfig) -> torch.Tensor:
    """Direct attention against a (possibly ring-buffered) cache with
    explicit per-slot absolute positions.  q: (B, 1, Hq, D).  Products in
    the cache's dtype, sums in f32, as the reference's
    ``preferred_element_type``; plain torch, as the reference leaves it to
    XLA."""
    b, sq, hq, dh = q.shape
    hkv = ck.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh).to(ck.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     ck.to(torch.float32)) * (dh ** -0.5)
    s = softcap(s, cfg.attn_softcap)
    ok = valid & (k_pos <= cur)
    s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cv.dtype).to(torch.float32),
                     cv.to(torch.float32))
    return o.reshape(b, sq, hq, dh).to(q.dtype)


def _ffn_block(lp: Dict, x: torch.Tensor, cfg: TransformerConfig):
    _dense_only(cfg)
    h = rmsnorm(lp["ln2"], x, plus_one=cfg.post_norms)
    y = mlp(lp["mlp"], h, act=cfg.act)
    if cfg.post_norms:
        y = rmsnorm(lp["ln2b"], y, plus_one=True)
    return y, 0.0


def _group(params: Dict, g: int, x: torch.Tensor, positions: torch.Tensor,
           cfg: TransformerConfig):
    """Pattern group ``g`` (the reference's scan body): (x, its aux losses)."""
    aux = 0.0
    for i, kind in enumerate(cfg.pattern):
        lp = _layer(params, i, g)
        a, _ = _attn_block(lp, x, cfg, kind, positions=positions)
        x = x + a
        f, a_aux = _ffn_block(lp, x, cfg)
        x = x + f
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
    _dense_only(cfg)
    _, s = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    aux = 0.0
    records = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for _, t in _flatten(params["groups"], "")))
    group = _remat(cfg) if cfg.remat and records else _group
    for g in range(cfg.n_groups):
        x, g_aux = group(params, g, x, positions, cfg)
        aux = aux + g_aux
    x = rmsnorm(params["final_norm"], x, plus_one=cfg.post_norms)
    # a fill, not torch.tensor: no host-to-device copy waits on the card here
    return x, torch.full((), aux / cfg.n_layers, dtype=torch.float32, device=x.device)


def _logits(params: Dict, h: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    lg = h @ w.to(h.dtype)
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
        lse = torch.logsumexp(lg, dim=-1)
        true = label_logits(lg, lb)
        tot = tot + torch.sum(lse - true)
    loss = tot / (b * n_chunks * chunk)
    return loss + 0.01 * aux


# ------------------------------------------------------------------------ decode
def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """Stacked caches per pattern position, on ``device`` (None: the CUDA
    card).  Windowed layers get ring buffers of length min(window,
    max_len); global layers full max_len.  ``cur`` (the next position) is
    a Python int."""
    _dense_only(cfg)
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
    _dense_only(cfg)
    b, s = tokens.shape
    assert s == 1
    cur = int(cache["cur"])
    x = _embed(params, tokens, cfg)
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
        _dense_only(cfg)
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
