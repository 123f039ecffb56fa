"""Plain version of the flash_attention kernel (B6): direct softmax attention,
and the plain version of its backward.

The CPU path of ``ops.py`` runs ``flash_attention_ref`` (differentiated by
torch autograd), the tests hold it to the reference's ``flash_attention_ref``,
Pallas kernel and trainable paths, and ``chip_smoke.py`` holds the CUDA
kernels to both functions here on the card.  They materialize the (Sq, Skv)
scores per head, so they are no measure of speed.

Semantics are the reference's: scores ``(q·k)·D^-0.5`` in f32, then
``cap·tanh(s/cap)``, then the mask as an additive -1e30 bias (not -inf),
as the reference's ``_mask_bias``: a query row with no valid key gets
uniform weights and returns the mean of all V rows, and its gradient still
reaches q and k through the bias (ROADMAP C.23).  Every forward answer is
what a ``where`` to -1e30 gives: in f32 and f64, -1e30 + s rounds to -1e30
for any score below ~1e22.  float64 inputs are computed in float64:
``chip_smoke.py`` holds the f32 kernels to that where f32 rounding of large
scores in this version alone would use up the tolerance.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "NEG_INF"]

NEG_INF = -1e30


def _valid(sq: int, skv: int, *, causal: bool, window: Optional[int], q_offset: int,
           device) -> torch.Tensor:
    """(Sq, Skv) bool: the keys each query row may see."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= q_pos >= k_pos
    if window is not None:
        ok &= (q_pos - k_pos) < window
    return ok


def _capped_scores(q: torch.Tensor, k: torch.Tensor, cap: Optional[float]):
    """(B, Hkv, G, Sq, Skv) scores before the mask, in f32 (f64 for f64
    inputs), and the promoted type."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, hkv, hq // hkv, d).to(acc)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(acc)) * (d ** -0.5)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    return s, acc


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None, q_offset: int = 0,
                        return_lse: bool = False):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) → (B, Sq, Hq, D) in q.dtype.
    With ``return_lse`` also the row log-sum-exp of the masked scores,
    (B, Hq, Sq) in f32 (f64 for f64 inputs), natural log: what the kernels
    write for their backward (-1e30 on a row with no valid key)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    s, acc = _capped_scores(q, k, cap)
    ok = _valid(sq, skv, causal=causal, window=window, q_offset=q_offset, device=q.device)
    s = s + torch.where(ok, 0.0, NEG_INF).to(acc)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(acc))
    o = o.reshape(b, sq, hq, d).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None, cap: Optional[float] = None,
                            q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FlashAttention-2's backward written out: the gradients (dq, dk, dv)
    of ``flash_attention_ref`` for the output cotangent ``do``, from the
    forward's output ``o`` and row log-sum-exp ``lse`` (B, Hq, Sq), in f32
    (f64 for f64 inputs), cast to the inputs' dtypes.

    Dᵢ = rowsum(dO∘O); P = exp(S − lse) on the masked capped scores S;
    dV = Pᵀ·dO; dP = dO·Vᵀ; dS = P∘(dP − Dᵢ)∘(1 − tanh²(s/cap))·D^-0.5;
    dQ = dS·K; dK = dSᵀ·Q; dK and dV summed over the G query heads of each
    KV head.  A row with no valid key has P = 1/Skv on every key (its lse,
    -1e30 + log Skv, rounds to -1e30, so it is known from the positions)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s, acc = _capped_scores(q, k, cap)
    ok = _valid(sq, skv, causal=causal, window=window, q_offset=q_offset, device=q.device)
    none = ~ok.any(dim=-1)
    lse5 = lse.to(acc).reshape(b, hkv, g, sq, 1)
    p = torch.where(ok, torch.exp(s - lse5), 0.0)
    p = torch.where(none[:, None], 1.0 / skv, p)
    og = o.to(acc).reshape(b, sq, hkv, g, d)
    dog = do.to(acc).reshape(b, sq, hkv, g, d)
    di = (og * dog).sum(-1).permute(0, 2, 3, 1)  # (B, Hkv, G, Sq)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.to(acc))
    ds = p * (dp - di[..., None])
    if cap is not None:
        ds = ds * (1 - (s / cap) ** 2)
    ds = ds * (d ** -0.5)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(acc)).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.to(acc).reshape(b, sq, hkv, g, d))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
