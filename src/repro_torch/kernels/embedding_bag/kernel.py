"""Build and launch the hand-written CUDA embedding_bag kernel.

``csrc/embedding_bag.cu`` holds B4 (``embedding_bag_kernel``; the source's
header says which TPU kernel it replaces, what bounds it and what the
design does).  ``kernels/_build.py`` compiles it at first use into
``build/kernels/`` and loads it with ``ctypes``.

The launcher takes tensors the caller has already validated (``ops.py``)
and runs on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the source's dtype codes


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.embedding_bag_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("embedding_bag", SOURCE, _declare)


def build() -> Path:
    """Compile the source unless this exact build exists; returns the path."""
    return LIBRARY.build()


def launch_embedding_bag(tables: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                         window: Optional[Tuple[int, int]] = None) -> None:
    """B4: ``out`` (B, F, D) ← the mean over h of ``tables[f, idx[b, f, h]]``.
    ``tables`` (F, R, D) f32 or bf16, ``idx`` (B, F, MH) int32, ``out`` in
    the tables' type; ``window`` = (V, row_lo): the tables are rows
    [row_lo, row_lo + R) of V-row tables (None: the whole tables)."""
    fn = LIBRARY.load().embedding_bag_launch
    f, r, d = tables.shape
    v, lo = (r, 0) if window is None else window
    b, _, mh = idx.shape
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = fn(tables.data_ptr(), idx.data_ptr(), out.data_ptr(), b * f, f, v, lo, r, d, mh,
                 DTYPES[tables.dtype], stream)
    _build.check_launch(fn, err)
