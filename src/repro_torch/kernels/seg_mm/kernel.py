"""Build and launch the hand-written CUDA seg_mm kernel.

``csrc/seg_mm.cu`` holds B5 (``seg_mm``; the source's header says which
TPU kernel it replaces, what bounds it and what the design does).
``kernels/_build.py`` compiles it at first use into ``build/kernels/`` and
loads it with ``ctypes``.

The launcher takes tensors the caller has already validated (``ops.py``)
and runs on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "seg_mm.cu"


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.seg_mm_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("seg_mm", SOURCE, _declare)


def build() -> Path:
    """Compile the source unless this exact build exists; returns the path."""
    return LIBRARY.build()


def launch_seg_mm(x: torch.Tensor, src: torch.Tensor, w: Optional[torch.Tensor],
                  order: torch.Tensor, row_ptr: torch.Tensor, out: torch.Tensor) -> None:
    """B5: ``out`` (n, D) f32 ← per row v, the sum over its edges
    ``order[row_ptr[v]:row_ptr[v+1]]`` of ``w[e] * x[src[e]]`` (``w`` None:
    weight 1).  ``x`` (N_src, D) f32 with N_src >= 1 where there are edges;
    ``src``, ``order``, ``row_ptr`` int32 (src ids outside [0, N_src) read
    the rows ``ref.gather_ids`` names)."""
    fn = LIBRARY.load().seg_mm_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), src.data_ptr(), None if w is None else w.data_ptr(),
                 order.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
                 out.shape[0], out.shape[1], x.shape[0], stream)
    _build.check_launch(fn, err)
