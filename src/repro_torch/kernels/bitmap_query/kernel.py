"""Build and launch the hand-written CUDA bitmap_query kernels.

``csrc/bitmap_query.cu`` holds both kernels (B1 packed OR-scan, B2 byte
OR-scan; the source's header says which TPU kernel each replaces and what
bounds it).  It is compiled at first use with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``.  The
library is named after a hash of the source, so an edited source is never
served by a stale build, and it lands in ``build/kernels/`` at the repository
root (listed in ``.gitignore``).

Nothing here runs at import: the CPU tests import this module on machines
with no ``nvcc`` and no card.  The launchers take tensors the caller has
already validated (``ops.py``) and run on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitmap_query.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): "
                       "the bitmap_query kernels are built from source on the card's host")


def library_path() -> Path:
    """Where the build for the current source lives (content-addressed)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbitmap_query_{digest}.so"


def build() -> Path:
    """Compile the source unless this exact build exists; returns the path.

    Writes to a private temporary name and renames, so concurrent builds
    never load a half-written library.  A failed compile raises with the
    compiler's output.
    """
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn in (lib.bitmap_query_packed_launch, lib.bitmap_query_byte_launch):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _launch(fn, plane: torch.Tensor, masks: torch.Tensor, out: torch.Tensor) -> None:
    q, k = masks.shape
    cols = plane.shape[1]
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        err = fn(plane.data_ptr(), masks.data_ptr(), out.data_ptr(), q, k, cols, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def launch_packed(plane: torch.Tensor, masks: torch.Tensor, out: torch.Tensor) -> None:
    """B1 on (K, W) int32 ``plane``, (Q, K) bool ``masks`` into (Q, W) int32 ``out``."""
    _launch(_load().bitmap_query_packed_launch, plane, masks, out)


def launch_byte(bitmap: torch.Tensor, masks: torch.Tensor, out: torch.Tensor) -> None:
    """B2 on (K, N) int8 ``bitmap``, (Q, K) bool ``masks`` into (Q, N) bool ``out``."""
    _launch(_load().bitmap_query_byte_launch, bitmap, masks, out)
