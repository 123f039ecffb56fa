"""Plain version of the flash_attention kernel (B6): direct softmax attention.

The CPU path of ``ops.py`` runs it, the tests hold it to the reference's
``flash_attention_ref`` and Pallas kernel, and ``chip_smoke.py`` holds the
CUDA kernel to it on the card.  It materializes the (Sq, Skv) scores per
head, so it is no measure of speed.

Semantics are the reference's: scores ``(q·k)·D^-0.5`` in f32, then
``cap·tanh(s/cap)``; masked scores become -1e30 (not -inf), so a query row
with no valid key gets uniform weights and returns the mean of all V rows.
float64 inputs are computed in float64: ``chip_smoke.py`` holds the f32
kernel to that where f32 rounding of large scores in this version alone
would use up the tolerance.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_ref", "NEG_INF"]

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) → (B, Sq, Hq, D) in q.dtype."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, hkv, g, d).to(acc)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(acc)) * (d ** -0.5)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= k_pos
    if window is not None:
        ok &= (q_pos - k_pos) < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(acc))
    return o.reshape(b, sq, hq, d).to(q.dtype)
