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
the backward's launches (one a backward call: its three kernels Dᵢ, dK/dV
and dQ) under ``FLASH_ATTENTION_BWD`` and ``BWD_COUNTERS[variant]``;
``reset_launches()`` zeroes them all.

Gradients: on CUDA tensors, with grad mode on and q, k or v requiring a
gradient, the call goes through ``_FlashAttention``, a
``torch.autograd.Function`` whose forward launches the forward kernel with
its row log-sum-exp output and whose backward launches the backward kernel
``kernel.bwd_variant`` names from the saved forward's: after ``sm90``
``flash_attention_bwd_sm90.cu`` (``bwd_sm90``: wgmma and TMA, the whole LM
training path), else ``flash_attention_bwd.cu`` (``bwd_mma``: bf16 on
mma.sync; ``bwd_simt``: f32); bf16 recomputes the scores as the forward
kernel did.  A cotangent TMA would refuse (a view whose base is not 16-byte
aligned) is copied for ``bwd_sm90``.  Its gradient is the reference's
trainable one (XLA's autodiff of ``_direct``), rows with no valid key
included (ROADMAP C.23).  CPU tensors differentiate the plain version by
torch autograd.  The card tests: ``python -m pytest -m cuda
tests/test_torch_train_cuda.py -k b6``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _cost
from repro_torch.kernels.flash_attention import kernel, ref

__all__ = ["flash_attention", "launches", "reset_launches", "kept_pairs", "flash_attention_cost",
           "flash_attention_bwd_cost"]

FLASH_ATTENTION = "flash_attention"  # B6, every kernel
COUNTERS = {v: f"{FLASH_ATTENTION}_{v}" for v in kernel.VARIANTS}  # B6 by kernel
FLASH_ATTENTION_BWD = "flash_attention_bwd"  # B6's backward, every kernel
BWD_COUNTERS = {v: f"{FLASH_ATTENTION}_{v}" for v in kernel.BWD_VARIANTS}
launches: Dict[str, int] = {FLASH_ATTENTION: 0, **{c: 0 for c in COUNTERS.values()},
                            FLASH_ATTENTION_BWD: 0, **{c: 0 for c in BWD_COUNTERS.values()}}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kept_pairs(sq: int, skv: int, *, causal: bool = True, window: Optional[int] = None,
               q_offset: int = 0) -> int:
    """The (query, key) pairs the masks keep, per batch row and head: key j
    of query i (at position q_offset + i) is kept where j <= q_offset + i
    under ``causal`` and q_offset + i - j < window under a window."""
    i = np.arange(sq, dtype=np.int64) + int(q_offset)
    hi = np.minimum(skv - 1, i) if causal else np.full(sq, skv - 1, dtype=np.int64)
    lo = np.maximum(0, i - int(window) + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _pairs(q: torch.Tensor, k: torch.Tensor, kw: dict) -> int:
    return kept_pairs(q.shape[1], k.shape[1], causal=kw["causal"], window=kw["window"],
                      q_offset=kw["q_offset"])


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kw: dict) -> _cost.Charge:
    """One forward launch: 4·D FLOP per kept pair and query head (the two
    products); q, k and v read once and o written once."""
    b, _, hq, d = q.shape
    return _cost.Charge(FLASH_ATTENTION, 4 * d * hq * b * _pairs(q, k, kw),
                        (2 * q.numel() + k.numel() + v.numel()) * q.element_size())


def flash_attention_bwd_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kw: dict) -> _cost.Charge:
    """One backward launch: 10·D FLOP per kept pair and query head (S, dP,
    dV, dK, dQ); q, k, v, o and dO read once, dq, dk, dv written once, the
    row log-sum-exp read."""
    b, sq, hq, d = q.shape
    return _cost.Charge(FLASH_ATTENTION_BWD, 10 * d * hq * b * _pairs(q, k, kw),
                        (2 * (q.numel() + k.numel() + v.numel()) + 2 * q.numel())
                        * q.element_size() + b * hq * sq * 4)


def _charged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kw: dict) -> torch.Tensor:
    """B6 under a cost counter on inputs that launch no kernel (module
    docstring): what the card's call returns and keeps for its backward."""
    if q.numel() == 0 or k.shape[1] == 0:  # no launch on the card either
        return q.new_zeros(q.shape)

    def keep(inputs, o):  # the card's Function saves q, k, v, o and the log-sum-exp
        b, sq, hq, _ = inputs[0].shape  # (not q: the autograd node holds this closure, and
        # a tensor it closed over would outlive a checkpoint's release of the saved ones)
        return (*inputs, o, inputs[0].new_empty((b, hq, sq), dtype=torch.float32))

    return _cost.charged(lambda q_, k_, v_: ref.flash_attention_ref(q_, k_, v_, **kw), (q, k, v),
                         empty=lambda q_, k_, v_: q_.new_empty(q_.shape),
                         forward=flash_attention_cost(q, k, v, kw),
                         backward=flash_attention_bwd_cost(q, k, v, kw), backward_needs=None,
                         keep=keep)


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
    if q.device.type not in ("cpu", "cuda", "meta"):
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


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kw: dict, want_lse: bool):
    """The forward kernel's output, with ``want_lse`` its row log-sum-exp
    (B, Hq, Sq) f32 (else None), and the kernel's name (``VARIANTS``)."""
    b, sq, hq, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if want_lse else None
    which = kernel.variant(q, k, v)
    kernel.launch_flash_attention(q, k, v, o, variant=which, lse=lse, **kw)
    launches[FLASH_ATTENTION] += 1
    launches[COUNTERS[which]] += 1
    if _cost.counter is not None:
        _cost.charge(flash_attention_cost(q, k, v, kw))
    return o, lse, which


class _FlashAttention(torch.autograd.Function):
    """B6 forward with its log-sum-exp, B6 backward (module docstring);
    CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, kw: dict):
        o, lse, ctx.forward = _forward(q, k, v, kw, want_lse=True)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        which = kernel.bwd_variant(q, ctx.forward)
        if which == "bwd_sm90" and not kernel.tma_ready(do):
            do = do.clone()  # a contiguous view at an unaligned base: a fresh, aligned copy
        dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
        delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
        kernel.launch_flash_attention_bwd(q, k, v, o, lse, do, delta, dq, dk, dv, variant=which,
                                          forward=ctx.forward, **ctx.kw)
        launches[FLASH_ATTENTION_BWD] += 1
        launches[BWD_COUNTERS[which]] += 1
        if _cost.counter is not None:
            _cost.charge(flash_attention_bwd_cost(q, k, v, ctx.kw))
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, cap: Optional[float] = None,
                    q_offset: int = 0, bq: int = 128, bkv: int = 128) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) → (B, Sq, Hq, D) in q.dtype.
    ``bq`` and ``bkv`` (the reference's tile sizes) are accepted and
    ignored: the kernel has its own tiles and takes any Sq and Skv."""
    del bq, bkv
    _check(q, k, v, q_offset)
    kw = dict(causal=causal, window=window, cap=cap, q_offset=q_offset)
    if _cost.counter is not None and not _cost.launches_kernel(q):
        return _charged(q, k, v, kw)
    if q.device.type != "cuda":
        if q.device.type == "meta":
            return _charged(q, k, v, kw)
        return ref.flash_attention_ref(q, k, v, **kw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.numel() == 0 or k.shape[1] == 0:
            raise ValueError(f"{FLASH_ATTENTION}: no backward for empty q, k or v on the card")
        return _FlashAttention.apply(q, k, v, kw)
    if q.numel() == 0 or k.shape[1] == 0:  # no keys: every output row sums nothing
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    return _forward(q, k, v, kw, want_lse=False)[0]
