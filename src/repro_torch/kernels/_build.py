"""Build a kernel family's CUDA source into a shared library and load it.

Each family compiles its ``csrc/*.cu`` at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  The library is named after a hash of the source and the flags,
so an edited source is never served by a stale build, and it lands in
``build/kernels/`` at the repository root (listed in ``.gitignore``).

Nothing here runs at import: the CPU tests import the kernel modules on
machines with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): "
                       "the CUDA kernels are built from source on the card's host")


class Library:
    """One kernel family's library: ``build()`` compiles it unless this
    exact build exists, ``load()`` opens it once (thread-safe) and hands the
    handle to ``declare`` to set each entry's ``argtypes``/``restype``."""

    def __init__(self, name: str, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        """Where the build for the current source lives (content-addressed)."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def build(self) -> Path:
        """Compile unless built; returns the path.  Writes to a private
        temporary name and renames, so concurrent builds never load a
        half-written library.  A failed compile raises with the compiler's
        output."""
        out = self.path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


def check_launch(fn, err: int) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
