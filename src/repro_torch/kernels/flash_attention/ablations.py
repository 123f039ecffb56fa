"""Where B6's time goes: the wgmma/TMA kernel timed with one part taken out.

    python -m repro_torch.kernels.flash_attention.ablations [--reps 20]

Needs one CUDA card and ``nvcc``.  Each variant is ``csrc/flash_attention_sm90.cu``
with one part removed by a text substitution, built with ``nvcc`` into
``build/kernels/ablations/`` (all builds at once) and timed with CUDA events at
``prefill_8k``'s layer shapes (q (1, 8192, 16, 256), k and v (1, 8192, 8, 256),
bf16, scores at the softcap's scale), with the cap of 50 and without it:

* ``base``: the kernel as it ships;
* ``no_kv_loads``: K and V are loaded for the first two tiles only (every
  later tile reuses them), so no L2 or HBM traffic past those;
* ``no_turns``: the two consumer warpgroups no longer take turns issuing
  their products (no named barriers);
* ``no_s``: the S = Q K^T products are not issued (S stays 0);
* ``no_pv``: the O += P V products are not issued.

Outputs of the variants are wrong by design; only their times mean
anything.  Prints one JSON object per mask and cap, beside the card's name and
power limit.  The removal of a part that binds the kernel shortens it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel

_LOADS = ("        mbar_expect_tx({b}_full(s), kTileBytes);\n"
          "        for (int c = 0; c < kBoxes; ++c) {{\n")
_FIRST_ONLY = ("        mbar_expect_tx({b}_full(s), j < kStages ? kTileBytes : 0);\n"
               "        for (int c = 0; c < (j < kStages ? kBoxes : 0); ++c) {{\n")
CUTS = {
    "base": [],
    "no_kv_loads": [(_LOADS.format(b=b), _FIRST_ONLY.format(b=b)) for b in ("k", "v")],
    "no_turns": [("bar_sync(kSchedBar + w, 256);", ""),
                 ("if (n_kv > 0 && w == 1) bar_arrive(kSchedBar + 0, 256);", ""),
                 ("bar_arrive(kSchedBar + (1 - w), 256);", ""),
                 ("if (w == 0) bar_arrive(kSchedBar + 1, 256);", "")],
    "no_s": [("  auto issue_s = [&](float (&sc)[32], int s) {\n",
              "  auto issue_s = [&](float (&sc)[32], int s) {\n"
              "    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;\n"
              "    wgmma_commit();\n    if (s >= 0) return;\n")],
    "no_pv": [("  auto issue_pv = [&](const uint32_t (&pa)[4][4], int s) {\n",
               "  auto issue_pv = [&](const uint32_t (&pa)[4][4], int s) {\n"
               "    wgmma_commit();\n    if (s >= 0) return;\n")],
}


def _source(cuts) -> str:
    text = kernel.SOURCE_SM90.read_text()
    for old, new in cuts:
        if old not in text:
            raise RuntimeError(f"the kernel source no longer holds {old.strip()!r}")
        text = text.replace(old, new)
    return text


def _build_variant(name: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "ablations"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"lib{name}.so"
    src.write_text(_source(CUTS[name]))
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    kernel._declare_sm90(handle)
    return handle


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablations: torch sees no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(_build_variant, CUTS)))
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = (torch.randn((1, 8192, 16, 256), generator=gen, device="cuda") * 3.0).bfloat16()
    k = (torch.randn((1, 8192, 8, 256), generator=gen, device="cuda") * 3.0).bfloat16()
    v = torch.randn((1, 8192, 8, 256), generator=gen, device="cuda").bfloat16()
    o = torch.empty_like(q)
    saved = kernel.LIBRARY_SM90._lib
    try:
        for window in (4096, None):
            for cap in (50.0, None):
                row = {"window": window, "cap": cap, "card": smi, "ms": {}}
                for name, lib in libs.items():
                    kernel.LIBRARY_SM90._lib = lib
                    row["ms"][name] = _time_ms(lambda: kernel.launch_flash_attention(
                        q, k, v, o, causal=True, window=window, cap=cap, q_offset=0,
                        variant="sm90"), args.reps)
                print(json.dumps(row), flush=True)
    finally:
        kernel.LIBRARY_SM90._lib = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
