"""Build and launch the hand-written CUDA neighbor_sample kernel.

``csrc/neighbor_sample.cu`` holds B3 (``window_select``; the source's
header says which TPU kernel it replaces, what bounds it and what the
design does).  ``kernels/_build.py`` compiles it at first use into
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "neighbor_sample.cu"


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.window_select_launch
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("neighbor_sample", SOURCE, _declare)


def build() -> Path:
    """Compile the source unless this exact build exists; returns the path."""
    return LIBRARY.build()


def launch_window_select(start: torch.Tensor, deg: torch.Tensor, dst: torch.Tensor,
                         words: Optional[torch.Tensor], pri: torch.Tensor,
                         nbrs: torch.Tensor, eids: torch.Tensor, ok: torch.Tensor) -> None:
    """B3 over the (..., S) seeds of ``start``/``deg`` (int32): (m,) int32
    ``dst``, (..., S, W) f32 ``pri`` into (..., S, fanout) int32
    ``nbrs``/``eids`` and bool ``ok``.  ``words`` (int32) is None, one
    shared (W_m,) row, or (R, W_m) with row r read by the seeds of
    ``start[r]``."""
    fn = LIBRARY.load().window_select_launch
    total, w, fanout = start.numel(), pri.shape[-1], nbrs.shape[-1]
    with torch.cuda.device(pri.device):
        stream = torch.cuda.current_stream(pri.device).cuda_stream
        err = fn(start.data_ptr(), deg.data_ptr(), dst.data_ptr(),
                 None if words is None else words.data_ptr(), pri.data_ptr(),
                 nbrs.data_ptr(), eids.data_ptr(), ok.data_ptr(),
                 total, max(start.shape[-1], 1),
                 words.shape[-1] if words is not None and words.dim() == 2 else 0,
                 w, fanout, dst.numel(), stream)
    _build.check_launch(fn, err)
