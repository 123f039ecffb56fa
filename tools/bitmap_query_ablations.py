"""Where B2's time goes: the byte query kernel timed with one part changed.

    PYTHONPATH=src python tools/bitmap_query_ablations.py [--reps 20]

Needs one CUDA card and ``nvcc``.  Each variant is
``src/repro_torch/kernels/bitmap_query/csrc/bitmap_query.cu`` with one part
changed by a text substitution, built and timed in turns by
``kernel_ablation``:

* ``base``: the kernel as it ships (two selected rows' loads in flight);
* ``inflight_1``, ``inflight_4``, ``inflight_8``: 1, 4 or 8 rows in flight;
* ``one_load``: the second aligned 16-byte word of a misaligned span is
  never loaded (the realignment's own load);
* ``no_store``: the output is never written (the reads and folds alone).

Input, made on the card from a seed: graph3's byte plane (K = 50 rows of
N = 8,646,926 entities, N = 14 mod 16, so rows start at every even offset
from alignment) under phase 5's masks (Q = 2: rows 0 and 1, and row 2)
and with every row selected.  ``one_load`` and ``no_store`` are wrong by
design; every other variant is checked equal to the plain version.  Prints
one JSON object per mask set, beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

import torch

import kernel_ablation
from repro_torch.kernels.bitmap_query import kernel, ref

CUTS = {
    "base": [],
    "inflight_1": [("constexpr int kInFlight = 2;", "constexpr int kInFlight = 1;")],
    "inflight_4": [("constexpr int kInFlight = 2;", "constexpr int kInFlight = 4;")],
    "inflight_8": [("constexpr int kInFlight = 2;", "constexpr int kInFlight = 8;")],
    "one_load": [("  if (r != 0 && e + kSpan - r < n) hi = __ldg(a + 1);\n", "")],
    # a condition the compiler cannot decide, so the reads and folds stay
    "no_store": [("    if (c + kSpan <= span)\n", "    if (c + kSpan <= span && k < 0)\n"),
                 ("      if (i < lead && i < span) o[i]", "      if (i < lead && i < span && k < 0) o[i]"),
                 ("      if (tail + i - kSpan < span) o[", "      if (tail + i - kSpan < span && k < 0) o[")],
}
WRONG_BY_DESIGN = ("one_load", "no_store")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    smi = kernel_ablation.card()
    libs = kernel_ablation.build_variants(kernel, "bitmap_query", CUTS)
    gen = torch.Generator(device="cuda").manual_seed(18)
    k, n = 50, 8_646_926
    bitmap = (torch.rand((k, n), generator=gen, device="cuda") < 0.02).to(torch.int8)
    masks = torch.zeros((2, k), dtype=torch.bool, device="cuda")
    masks[0, :2] = True
    masks[1, 2] = True
    for name, m in (("main_path", masks), ("all_rows", torch.ones_like(masks))):
        want = ref.bitmap_query_batched_ref(bitmap, m)
        outs = {v: torch.empty((2, n), dtype=torch.bool, device="cuda") for v in libs}

        def launch(v):
            kernel.launch_byte(bitmap, m, outs[v])

        def check(v):
            if v not in WRONG_BY_DESIGN and not outs[v].equal(want):
                raise RuntimeError(f"{name}: {v} disagrees with the plain version")

        row = {"masks": name, "rows_selected": int(m.any(dim=0).sum()), "K": k, "N": n,
               "card": smi,
               "device_ms": kernel_ablation.time_in_turns(kernel, libs, launch, check,
                                                          "bitmap_query_byte_kernel", args.reps)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
