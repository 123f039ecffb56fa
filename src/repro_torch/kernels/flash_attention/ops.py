"""Public wrapper for the flash_attention kernel (B6): blockwise attention.

``flash_attention(q, k, v, *, causal, window, cap, q_offset)`` computes
softmax attention of q (B, Sq, Hq, D) over k and v (B, Skv, Hkv, D) with
GQA (query head h reads KV head h // (Hq / Hkv)), a causal mask, a sliding
window (q_pos - k_pos < window, q_pos = q_offset + i), Gemma-2's softcap
``cap·tanh(s/cap)`` and scale D^-0.5, in the reference's semantics (a row
with no valid key returns the mean of all V rows; ``ref.py``).  It checks
its inputs, sends CPU tensors to the plain version
(``ref.flash_attention_ref``) and launches a CUDA kernel (``kernel.py``) on
CUDA tensors: the one ``kernel.variant`` names from dtype, D, strides and
alignment (``sm90``: wgmma and TMA; ``mma``: mma.sync, other bf16 inputs;
``simt``: f32).  There is no fallback from one kernel to another or from
the card to the plain version: a refused launch raises.
``launches`` counts kernel launches (never plain-version calls): the total
under ``FLASH_ATTENTION`` and each kernel under ``COUNTERS[variant]``;
``reset_launches()`` zeroes them.

B6 has no backward kernel yet (ROADMAP A15b): on CUDA tensors, a call
with grad mode on and q, k or v requiring a gradient raises
``NotImplementedError`` rather than returning an output autograd cannot
see through.  Serving runs under ``torch.inference_mode()`` or on weights
that need no gradient, and the CPU's plain path keeps autograd.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention import kernel, ref

__all__ = ["flash_attention", "launches", "reset_launches"]

FLASH_ATTENTION = "flash_attention"  # B6, every kernel
COUNTERS = {v: f"{FLASH_ATTENTION}_{v}" for v in kernel.VARIANTS}  # B6 by kernel
launches: Dict[str, int] = {FLASH_ATTENTION: 0, **{c: 0 for c in COUNTERS.values()}}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
    name = FLASH_ATTENTION
    if q.dtype not in kernel.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: want q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not fit q {tuple(q.shape)} "
                         "(batch and D equal, Hq a multiple of Hkv)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: inputs on several devices {[q.device, k.device, v.device]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.device.type == "cuda":
        if d > kernel.MAX_D:
            raise ValueError(f"{name}: the kernel takes D <= {kernel.MAX_D}, got {d}")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError(f"{name}: inputs must be contiguous along D")
        if abs(int(q_offset)) + q.shape[1] + k.shape[1] >= kernel.POS_LIMIT:
            raise ValueError(f"{name}: |q_offset| + Sq + Skv must lie below 2**30")
        if b >= 2**16 or hq >= 2**16:
            raise ValueError(f"{name}: B and Hq must lie below 2**16")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, cap: Optional[float] = None,
                    q_offset: int = 0, bq: int = 128, bkv: int = 128) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) → (B, Sq, Hq, D) in q.dtype.
    ``bq`` and ``bkv`` (the reference's tile sizes) are accepted and
    ignored: the kernel has its own tiles and takes any Sq and Skv."""
    del bq, bkv
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap,
                                       q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            f"{FLASH_ATTENTION}: B6 has no backward kernel on the card yet (ROADMAP A15b); "
            "call it under torch.no_grad() or on tensors that need no gradient")
    if q.numel() == 0 or k.shape[1] == 0:  # no keys: every output row sums nothing
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    which = kernel.variant(q, k, v)
    kernel.launch_flash_attention(q, k, v, o, causal=causal, window=window, cap=cap,
                                  q_offset=q_offset, variant=which)
    launches[FLASH_ATTENTION] += 1
    launches[COUNTERS[which]] += 1
    return o
