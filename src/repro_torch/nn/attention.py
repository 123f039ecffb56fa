"""Attention — the reference's plain paths (direct and KV-chunked online
softmax) and the CUDA kernel B6 (``kernels/flash_attention``).

Supports causal masking, sliding windows, Gemma-2's logit softcap, GQA
(n_kv_heads < n_heads) and a query offset.

Routing:
  * CUDA tensors with ``kv_len is None`` run B6 whatever ``impl`` says:
    the card's prefill and training always go through the kernel, and a
    gradient through B6's backward kernels (``kernels/flash_attention``),
    which give the reference's ``_direct`` gradient.
  * CPU tensors take the reference's branch: ``auto`` is ``direct`` when
    Sq·Skv ≤ 1024·2048 and ``chunked`` otherwise; ``direct`` materializes
    the (Sq, Skv) scores; ``chunked`` is FlashAttention's algorithm over KV
    chunks of ``min(chunk, Skv)`` (Skv padded to a multiple); ``flash`` is
    B6's plain version.
  * ``kv_len`` given (masking keys at or past it) takes ``direct`` or
    ``chunked`` on either device, ``flash`` as ``auto`` picks: the kernel
    has no ``kv_len``, as the reference's Pallas kernel has none (the
    reference's ``flash`` drops ``kv_len``; ROADMAP C.11).  No caller on
    the main path passes it; decode attends through
    ``models/transformer.py::_decode_attend``.

As in the reference, dots run in k's dtype with f32 accumulation, and the
softmax weights are cast to v's dtype before the second product.

DTensor inputs (the partitioned program, ``launch/dryrun.py``) run each
rank's shard through ``local_map`` (``nn/partition.local_call``, which
takes the global shape of a split that may be uneven): the batch over the
data-parallel axes, the query heads over ``model``.  K and V heads that do not divide over
``model`` are replicated there (the head reshape has redistributed them)
and each rank attends with the KV heads its query heads read; their
gradient comes back as a partial sum over ``model``.  The local call routes
as above, so each rank's launch of B6 runs (or is charged) on its local
shapes.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.kernels import _cost
from repro_torch.kernels.flash_attention import ops as _ops
from repro_torch.nn.layers import softcap as _softcap
from repro_torch.nn.partition import local_call, local_shard, mesh_placements

__all__ = ["attention"]

NEG_INF = -1e30
IMPLS = ("auto", "direct", "chunked", "flash")


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(…, Sq, Skv) additive mask bias (0 or -1e30, f32) from position grids."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, Sq, Hkv, G, D) × (B, Skv, Hkv, D) → (B, Hkv, G, Sq, Skv) f32:
    products in k's dtype, summed in f32 (the reference's
    ``preferred_element_type=float32``)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32))
    return s * scale


def _direct(q, k, v, *, causal, window, cap, q_offset, kv_len=None):
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).to(k.dtype)
    s = _scores(qg, k, d ** -0.5)
    s = _softcap(s, cap)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)
    if kv_len is not None:  # decode: mask beyond the current cache fill
        s = torch.where(k_pos < kv_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _chunked(q, k, v, *, causal, window, cap, q_offset, kv_len=None, chunk: int = 1024):
    """Online softmax over KV chunks (the flash algorithm in plain torch)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).to(k.dtype)
    scale = d ** -0.5
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = q_offset + torch.arange(sq, device=q.device)
    valid_len = skv if kv_len is None else kv_len
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        s = _scores(qg, kb, scale)
        s = _softcap(s, cap)
        k_pos = ci * chunk + torch.arange(chunk, device=q.device)
        s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)
        s = torch.where(k_pos < valid_len, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vb.dtype).to(torch.float32), vb.to(torch.float32))
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None, cap: Optional[float] = None, q_offset: int = 0,
              kv_len=None, impl: str = "auto", chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) → (B, Sq, Hq, D)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if isinstance(q, DTensor):
        return _partitioned(q, k, v, causal=causal, window=window, cap=cap, q_offset=q_offset,
                            kv_len=kv_len, impl=impl, chunk=chunk)
    skv = k.shape[1]
    if kv_len is None and (impl == "flash" or q.device.type == "cuda"
                           or _cost.counter is not None):
        return _ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                                    q_offset=q_offset)
    if impl in ("auto", "flash"):
        impl = "direct" if (q.shape[1] * skv <= 1024 * 2048) else "chunked"
    if impl == "direct":
        return _direct(q, k, v, causal=causal, window=window, cap=cap, q_offset=q_offset,
                       kv_len=kv_len)
    return _chunked(q, k, v, causal=causal, window=window, cap=cap, q_offset=q_offset,
                    kv_len=kv_len, chunk=min(chunk, skv))


def _partitioned(q, k, v, **kw):
    """``attention`` on DTensors, rank by rank (module docstring)."""
    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    q_pl = mesh_placements(mesh, dp=Shard(0), model=Shard(2), like=q)
    split_kv = hkv % m == 0 and hq % m == 0
    kv_pl = q_pl if split_kv else mesh_placements(mesh, dp=Shard(0), like=q)
    kv_grad = kv_pl if split_kv else mesh_placements(mesh, dp=Shard(0), model=Partial(), like=q)
    local_shape, offsets = local_shard(q.shape, q_pl, mesh)
    start, n_local = offsets[2], local_shape[2]

    def local(q_l, k_l, v_l):
        if not split_kv:  # the KV heads this rank's query heads read
            heads = [h // (hq // hkv) for h in range(start, start + n_local)] or [0]
            first, n_kv = heads[0], heads[-1] - heads[0] + 1
            if len(heads) % n_kv == 0 and heads == [first + i * n_kv // len(heads)
                                                     for i in range(len(heads))]:
                k_l, v_l = k_l[:, :, first:first + n_kv], v_l[:, :, first:first + n_kv]
            else:  # no grouping a GQA call takes: one KV head per query head
                ids = torch.tensor(heads, device=k_l.device)
                k_l, v_l = k_l.index_select(2, ids), v_l.index_select(2, ids)
        return attention(q_l, k_l, v_l, **kw)

    return local_call(local, (q, k, v), (q_pl, kv_pl, kv_pl), (q_pl, kv_grad, kv_grad), q_pl,
                      q.shape)
