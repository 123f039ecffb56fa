"""What the kernel ablation tools (``tools/*_ablations.py``) share.

A variant is a kernel's CUDA source with some parts changed by text
substitutions (a substitution that no longer finds its text raises: the
tool's ``CUTS`` is updated with the kernel).  ``build_variants`` writes each
variant under ``build/kernels/ablations/`` and builds them all at once with
``nvcc``; ``time_in_turns`` puts each variant's library in the kernel
module's place, checks it, and times it by the card's own clock
(``torch.profiler``) in turns, each order once.  Needs one CUDA card and
``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import _build

Cuts = Sequence[Tuple[str, str]]


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    if not torch.cuda.is_available():
        raise SystemExit("ablations: torch sees no CUDA card")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def source(kernel_mod, cuts: Cuts) -> str:
    """``kernel_mod.SOURCE`` with every (old, new) of ``cuts`` applied."""
    text = kernel_mod.SOURCE.read_text()
    for old, new in cuts:
        if old not in text:
            raise RuntimeError(f"the kernel source no longer holds {old.strip()!r}")
        text = text.replace(old, new)
    return text


def _build_variant(kernel_mod, prefix: str, name: str, text: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "ablations"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{prefix}_{name}.cu", out / f"lib{prefix}_{name}.so"
    src.write_text(text)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    kernel_mod._declare(handle)
    return handle


def build_variants(kernel_mod, prefix: str, cuts: Dict[str, Cuts]) -> Dict[str, ctypes.CDLL]:
    """One library per entry of ``cuts``, built in parallel."""
    texts = {name: source(kernel_mod, c) for name, c in cuts.items()}
    with ThreadPoolExecutor(len(texts)) as pool:
        return dict(zip(texts, pool.map(lambda kv: _build_variant(kernel_mod, prefix, *kv),
                                        texts.items())))


def device_ms(fn: Callable[[], object], reps: int, kernel_name: str) -> float:
    """The kernel's own time per launch over ``reps`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel_name in e.key]
    count = sum(e.count for e in hits)
    if not count:
        raise RuntimeError(f"the profiler recorded no {kernel_name} launch")
    return sum(e.self_device_time_total for e in hits) / 1e3 / count


def time_in_turns(kernel_mod, libs: Dict[str, ctypes.CDLL], launch: Callable[[str], None],
                  check: Callable[[str], None], kernel_name: str,
                  reps: int) -> Dict[str, List[float]]:
    """``launch(v)`` with variant ``v``'s library in ``kernel_mod``'s place:
    once each, then ``check(v)``, then timed over ``reps`` calls in turns,
    the variants in order and in reverse.  The shipped library is put back
    afterwards."""
    saved = kernel_mod.LIBRARY._lib

    def call(v):
        kernel_mod.LIBRARY._lib = libs[v]
        launch(v)

    try:
        for v in libs:
            call(v)
            check(v)
        ms: Dict[str, List[float]] = {v: [] for v in libs}
        for v in [*libs, *reversed(libs)]:
            ms[v].append(device_ms(lambda: call(v), reps, kernel_name))
    finally:
        kernel_mod.LIBRARY._lib = saved
    return ms
