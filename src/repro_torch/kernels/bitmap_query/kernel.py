"""Build and launch the hand-written CUDA bitmap_query kernels.

``csrc/bitmap_query.cu`` holds both kernels (B1 packed OR-scan, B2 byte
OR-scan; the source's header says which TPU kernel each replaces and what
bounds it).  ``kernels/_build.py`` compiles it at first use into
``build/kernels/`` and loads it with ``ctypes``.

The launchers take tensors the caller has already validated (``ops.py``)
and run on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitmap_query.cu"


def _declare(lib: ctypes.CDLL) -> None:
    for fn in (lib.bitmap_query_packed_launch, lib.bitmap_query_byte_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int


LIBRARY = _build.Library("bitmap_query", SOURCE, _declare)


def library_path() -> Path:
    """Where the build for the current source lives (content-addressed)."""
    return LIBRARY.path()


def build() -> Path:
    """Compile the source unless this exact build exists; returns the path."""
    return LIBRARY.build()


def _launch(fn, plane: torch.Tensor, masks: torch.Tensor, out: torch.Tensor) -> None:
    q, k = masks.shape
    cols = plane.shape[1]
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        err = fn(plane.data_ptr(), masks.data_ptr(), out.data_ptr(), q, k, cols, stream)
    _build.check_launch(fn, err)


def launch_packed(plane: torch.Tensor, masks: torch.Tensor, out: torch.Tensor) -> None:
    """B1 on (K, W) int32 ``plane``, (Q, K) bool ``masks`` into (Q, W) int32 ``out``."""
    _launch(LIBRARY.load().bitmap_query_packed_launch, plane, masks, out)


def launch_byte(bitmap: torch.Tensor, masks: torch.Tensor, out: torch.Tensor) -> None:
    """B2 on (K, N) int8 ``bitmap``, (Q, K) bool ``masks`` into (Q, N) bool ``out``."""
    _launch(LIBRARY.load().bitmap_query_byte_launch, bitmap, masks, out)
