"""Build and launch the hand-written CUDA flash_attention kernel.

``csrc/flash_attention.cu`` holds B6 (``flash_attention_mma_kernel`` for
bf16 on the tensor cores, ``flash_attention_simt_kernel`` for f32; the
source's header says which TPU kernel it replaces, what bounds it and what
the design does).  ``kernels/_build.py`` compiles it at first use into
``build/kernels/`` and loads it with ``ctypes``.

The launcher takes tensors the caller has already validated (``ops.py``)
and runs on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the source's dtype codes
MAX_D = 256  # the widest head the kernels take
POS_LIMIT = 2**30  # |q_offset| + Sq + Skv must lie below it (int32 positions)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("flash_attention", SOURCE, _declare)


def build() -> Path:
    """Compile the source unless this exact build exists; returns the path."""
    return LIBRARY.build()


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                           *, causal: bool, window: Optional[int], cap: Optional[float],
                           q_offset: int) -> None:
    """B6: ``o`` (B, Sq, Hq, D) ← attention of q over k and v (module
    docstring of ``ops.py``).  All four share a dtype (f32 or bf16) and
    have a contiguous last dim; ``o`` is contiguous."""
    fn = LIBRARY.load().flash_attention_launch
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    # a window past every position difference keeps what no window keeps
    w = 0 if window is None else max(-POS_LIMIT, min(POS_LIMIT, int(window)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 ctypes.cast(strides, ctypes.c_void_p), b, sq, skv, hq, hkv, d,
                 int(bool(causal)), int(window is not None), w, int(cap is not None),
                 float(cap) if cap is not None else 0.0, int(q_offset), float(d ** -0.5),
                 DTYPES[q.dtype], stream)
    _build.check_launch(fn, err)
