"""Build and launch the hand-written CUDA flash_attention kernels.

Two sources, two libraries, three kernels of B6:

* ``csrc/flash_attention_sm90.cu`` (``sm90``): bf16 on ``wgmma`` with TMA
  loads and warp specialisation, for inputs TMA takes (``variant``);
* ``csrc/flash_attention.cu``: ``mma`` (bf16 on ``mma.sync``, any other
  bf16 input) and ``simt`` (f32 on f32 FMAs).

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
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # flash_attention.cu's dtype codes
MAX_D = 256  # the widest head the kernels take
POS_LIMIT = 2**30  # |q_offset| + Sq + Skv must lie below it (int32 positions)
KERNEL_DTYPES = {"sm90": torch.bfloat16, "mma": torch.bfloat16, "simt": torch.float32}
VARIANTS = tuple(KERNEL_DTYPES)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _declare_sm90(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_sm90_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("flash_attention", SOURCE, _declare)
LIBRARY_SM90 = _build.Library("flash_attention_sm90", SOURCE_SM90, _declare_sm90)


def build() -> Path:
    """Compile flash_attention.cu unless this exact build exists; returns the path."""
    return LIBRARY.build()


def build_sm90() -> Path:
    """Compile flash_attention_sm90.cu unless this exact build exists."""
    return LIBRARY_SM90.build()


def _tma_strides(t: torch.Tensor):
    """The (B, S, H) element strides TMA gets for ``t`` (B, S, H, D): a dim
    of size 1 is never stepped over, so it gets the stride it would have
    if compact over the dims inside it."""
    out, inner = [], t.shape[3]
    for dim in (2, 1, 0):
        out.append(t.stride(dim) if t.shape[dim] > 1 else inner)
        inner = out[-1] * t.shape[dim]
    return out[::-1]


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which B6 kernel takes these inputs, from dtype, D, strides and
    alignment alone: ``"sm90"`` for bf16 with D a multiple of 8 in [8,
    256], D contiguous, 16-byte aligned bases and positive (B, S, H)
    strides that are multiples of 8 elements (16 bytes; a dim of size 1
    needs none); ``"mma"`` for every other bf16 input; ``"simt"`` for f32."""
    if q.dtype == torch.float32:
        return "simt"
    d = q.shape[-1]
    ok = d % 8 == 0 and 8 <= d <= MAX_D
    for t in (q, k, v):
        ok = ok and t.stride(3) == 1 and t.data_ptr() % 16 == 0
        ok = ok and all(s > 0 and s % 8 == 0 for s in _tma_strides(t))
    return "sm90" if ok else "mma"


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                           *, causal: bool, window: Optional[int], cap: Optional[float],
                           q_offset: int, variant: str) -> None:
    """B6: ``o`` (B, Sq, Hq, D) ← attention of q over k and v (module
    docstring of ``ops.py``) on the named kernel (``VARIANTS``; ``ops.py``
    names ``variant(q, k, v)``).  All four share a dtype (f32 or bf16) and
    have a contiguous last dim; ``o`` is contiguous."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    # a window past every position difference keeps what no window keeps
    w = 0 if window is None else max(-POS_LIMIT, min(POS_LIMIT, int(window)))
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
                 float(cap) if cap is not None else 0.0, *tail, stream)
    _build.check_launch(fn, err)
