"""Build and launch the hand-written CUDA flash_attention kernels.

Four sources, four libraries: B6's three forward kernels and its backward
in three variants.

* ``csrc/flash_attention_sm90.cu`` (``sm90``): bf16 on ``wgmma`` with TMA
  loads and warp specialisation, for inputs TMA takes (``variant``);
* ``csrc/flash_attention.cu``: ``mma`` (bf16 on ``mma.sync``, any other
  bf16 input) and ``simt`` (f32 on f32 FMAs);
* ``csrc/flash_attention_bwd_sm90.cu`` (``bwd_sm90``): the backward after
  the ``sm90`` forward, on ``wgmma`` with TMA loads and warp specialisation;
* ``csrc/flash_attention_bwd.cu``: the backward after the other two,
  ``bwd_mma`` (bf16 on ``mma.sync``, after the ``mma`` forward) and
  ``bwd_simt`` (f32).

Each backward is three kernels in one launch call (Dᵢ, dK/dV, dQ), named
from the dtype and the forward kernel that wrote ``lse``
(``bwd_variant``); bf16 recomputes the scores as that kernel did.  Each
forward kernel writes the row log-sum-exp the backward reads when it is
given an ``lse`` tensor, and nothing more without one.

Each source's header says which TPU kernel it replaces, what bounds it and
what the design does.  ``kernels/_build.py`` compiles each at first use into
``build/kernels/`` and loads it with ``ctypes``.

``variant(q, k, v)`` picks the kernel from dtype, D, strides and alignment
alone; it never asks whether a build or a launch works, and a refused launch
raises (no kernel falls back to another).  The launcher takes tensors the
caller has already validated (``ops.py``) and runs on PyTorch's current
stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
SOURCE_SM90 = CSRC / "flash_attention_sm90.cu"
SOURCE_BWD = CSRC / "flash_attention_bwd.cu"
SOURCE_BWD_SM90 = CSRC / "flash_attention_bwd_sm90.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # flash_attention.cu's dtype codes
MAX_D = 256  # the widest head the kernels take
POS_LIMIT = 2**30  # |q_offset| + Sq + Skv must lie below it (int32 positions)
KERNEL_DTYPES = {"sm90": torch.bfloat16, "mma": torch.bfloat16, "simt": torch.float32}
VARIANTS = tuple(KERNEL_DTYPES)
BWD_DTYPES = {"bwd_sm90": torch.bfloat16, "bwd_mma": torch.bfloat16, "bwd_simt": torch.float32}
BWD_VARIANTS = tuple(BWD_DTYPES)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _declare_sm90(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _declare_bwd_sm90(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_bwd_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("flash_attention", SOURCE, _declare)
LIBRARY_SM90 = _build.Library("flash_attention_sm90", SOURCE_SM90, _declare_sm90)
LIBRARY_BWD = _build.Library("flash_attention_bwd", SOURCE_BWD, _declare_bwd)
LIBRARY_BWD_SM90 = _build.Library("flash_attention_bwd_sm90", SOURCE_BWD_SM90,
                                  _declare_bwd_sm90)


def build() -> Path:
    """Compile flash_attention.cu unless this exact build exists; returns the path."""
    return LIBRARY.build()


def build_sm90() -> Path:
    """Compile flash_attention_sm90.cu unless this exact build exists."""
    return LIBRARY_SM90.build()


def build_bwd() -> Path:
    """Compile flash_attention_bwd.cu unless this exact build exists."""
    return LIBRARY_BWD.build()


def build_bwd_sm90() -> Path:
    """Compile flash_attention_bwd_sm90.cu unless this exact build exists."""
    return LIBRARY_BWD_SM90.build()


def _tma_strides(t: torch.Tensor):
    """The (B, S, H) element strides TMA gets for ``t`` (B, S, H, D): a dim
    of size 1 is never stepped over, so it gets the stride it would have
    if compact over the dims inside it."""
    out, inner = [], t.shape[3]
    for dim in (2, 1, 0):
        out.append(t.stride(dim) if t.shape[dim] > 1 else inner)
        inner = out[-1] * t.shape[dim]
    return out[::-1]


def tma_ready(t: torch.Tensor) -> bool:
    """TMA takes ``t`` (B, S, H, D) bf16: D contiguous, a 16-byte aligned
    base and positive (B, S, H) strides that are multiples of 8 elements (a
    dim of size 1 needs none)."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 for s in _tma_strides(t)))


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which B6 kernel takes these inputs, from dtype, D, strides and
    alignment alone: ``"sm90"`` for bf16 with D a multiple of 8 in [8,
    256] and q, k, v ``tma_ready``; ``"mma"`` for every other bf16 input;
    ``"simt"`` for f32."""
    if q.dtype == torch.float32:
        return "simt"
    d = q.shape[-1]
    ok = d % 8 == 0 and 8 <= d <= MAX_D and all(tma_ready(t) for t in (q, k, v))
    return "sm90" if ok else "mma"


def bwd_variant(q: torch.Tensor, forward: str) -> str:
    """Which backward kernels take these inputs after the forward kernel
    ``forward`` (``VARIANTS``) wrote their ``lse``: ``"bwd_sm90"`` exactly
    after ``"sm90"``, ``"bwd_simt"`` for f32, ``"bwd_mma"`` for other bf16."""
    if forward == "sm90":
        return "bwd_sm90"
    return "bwd_simt" if q.dtype == torch.float32 else "bwd_mma"


def _window(window: Optional[int]) -> int:
    # a window past every position difference keeps what no window keeps
    return 0 if window is None else max(-POS_LIMIT, min(POS_LIMIT, int(window)))


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                           *, causal: bool, window: Optional[int], cap: Optional[float],
                           q_offset: int, variant: str, lse: Optional[torch.Tensor] = None) -> None:
    """B6: ``o`` (B, Sq, Hq, D) ← attention of q over k and v (module
    docstring of ``ops.py``) on the named kernel (``VARIANTS``; ``ops.py``
    names ``variant(q, k, v)``).  All four share a dtype (f32 or bf16) and
    have a contiguous last dim; ``o`` is contiguous.  With ``lse`` (B, Hq,
    Sq) f32 contiguous the kernel also writes each row's log-sum-exp
    (natural log; -1e30 on a row with no valid key)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    w = _window(window)
    if KERNEL_DTYPES.get(variant) != q.dtype:
        raise ValueError(f"flash_attention: no kernel {variant!r} for {q.dtype}")
    if variant == "sm90":
        fn = LIBRARY_SM90.load().flash_attention_sm90_launch
        tma = [s for t in (q, k, v) for s in _tma_strides(t)]
        strides = (ctypes.c_longlong * 12)(*tma, *o.stride()[:3])
        tail = (int(q_offset),)
    else:
        fn = LIBRARY.load().flash_attention_launch
        strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
        tail = (int(q_offset), float(d ** -0.5), DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 ctypes.cast(strides, ctypes.c_void_p), b, sq, skv, hq, hkv, d,
                 int(bool(causal)), int(window is not None), w, int(cap is not None),
                 float(cap) if cap is not None else 0.0, *tail,
                 None if lse is None else lse.data_ptr(), stream)
    _build.check_launch(fn, err)


def launch_flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                               delta: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                               dv: torch.Tensor, *, causal: bool, window: Optional[int],
                               cap: Optional[float], q_offset: int, variant: str,
                               forward: str) -> None:
    """B6's backward on the named kernels (``BWD_VARIANTS``): ``delta``
    (B, Hq, Sq) f32 ← rowsum(do∘o), then ``dk``, ``dv`` (B, Skv, Hkv, D)
    and ``dq`` (B, Sq, Hq, D) ← the gradients of the attention whose output
    ``o`` and row log-sum-exp ``lse`` (B, Hq, Sq, f32) the forward kernel
    ``forward`` (``VARIANTS``) wrote, for the cotangent ``do``; the scores
    are recomputed as that kernel computed them.  q, k, v, o and do share a
    dtype and have a contiguous last dim; dq, dk, dv (their dtype), lse and
    delta are contiguous.  ``bwd_sm90`` runs only after ``sm90`` and takes
    q, k, v and do as TMA does (``tma_ready``); ``bwd_mma`` takes bf16 after
    either bf16 forward."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if (BWD_DTYPES.get(variant) != q.dtype or KERNEL_DTYPES.get(forward) != q.dtype
            or (variant == "bwd_sm90" and forward != "sm90")):
        raise ValueError(f"flash_attention: no backward kernel {variant!r} after {forward!r} "
                         f"for {q.dtype}")
    if variant == "bwd_sm90":
        if d % 8 or not all(tma_ready(t) for t in (q, k, v, do)):
            raise ValueError("flash_attention: bwd_sm90 takes q, k, v and do as TMA does "
                             "(16-byte aligned bases and strides)")
        fn = LIBRARY_BWD_SM90.load().flash_attention_bwd_sm90_launch
        strides = (ctypes.c_longlong * 15)(*(s for t in (q, k, v, o, do)
                                             for s in _tma_strides(t)))
        tail = ()
    else:
        fn = LIBRARY_BWD.load().flash_attention_bwd_launch
        strides = (ctypes.c_longlong * 15)(*(s for t in (q, k, v, o, do)
                                             for s in t.stride()[:3]))
        tail = (DTYPES[q.dtype], int(forward != "sm90"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 ctypes.cast(strides, ctypes.c_void_p), b, sq, skv, hq, hkv, d,
                 int(bool(causal)), int(window is not None), _window(window),
                 int(cap is not None), float(cap) if cap is not None else 0.0, int(q_offset),
                 float(d ** -0.5), *tail, stream)
    _build.check_launch(fn, err)
