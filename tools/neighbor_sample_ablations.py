"""Where B3's time goes: the window_select kernel timed with one part taken out.

    PYTHONPATH=src python tools/neighbor_sample_ablations.py [--reps 20]

Needs one CUDA card and ``nvcc``.  Each variant is
``src/repro_torch/kernels/neighbor_sample/csrc/neighbor_sample.cu`` with one
part changed by a text substitution, built and timed in turns by
``kernel_ablation``:

* ``base``: the kernel as it ships;
* ``no_select``: no seed's window is read; every row is the -1 / false fill,
  staged and written out as usual (the write-out alone);
* ``no_write``: the staged rows are never written out (the selection alone);
* ``no_staging``: every fanout takes the direct path, rows written to the
  output 4 and 1 bytes a store;
* ``hub_rereads``: windows wider than 16 lanes are never held in registers;
  the warp re-reads them every round.

Inputs, made on the card from a seed: ``pattern`` is the sampling path's
layer 0 on graph3 (S = 262,144 seeds of which 171,606 real, Poisson(1.16)
out-degrees, m = 10,000,000, W = 16, no edge filter) at fanout 15 and 10;
``hubs`` is a call at W = 1024 in which 5% of the 65,536 windows hold 9-32
lanes and 3% are hubs of 40-1,000, under a random edge filter.  Outputs of
``no_select`` and ``no_write`` are wrong by design; every other variant is
checked equal to ``base``.  Prints one JSON object per input, beside the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

import torch

import kernel_ablation
from repro_torch.kernels.neighbor_sample import kernel

CUTS = {
    "base": [],
    "no_select": [("  const int i = threadIdx.x;\n  if (i < rows) {",
                   "  const int i = threadIdx.x;\n  if (i < rows) fill(row_of(i), 0, fanout, 1);\n"
                   "  if (false) {")],
    "no_write": [("  if (!staged) return;\n  __syncthreads();", "  return;\n  __syncthreads();")],
    "no_staging": [("constexpr int kStage = 16;", "constexpr int kStage = 0;")],
    "hub_rereads": [("      if (hi <= kWarp * R)\n", "      if (false)\n")],
}
WRONG_BY_DESIGN = ("no_select", "no_write")


def _inputs(gen: torch.Generator):
    """(name, start, deg, dst, words, pri, fanout) on the card."""
    dev = gen.device
    s, real, m = 262_144, 171_606, 10_000_000
    deg = torch.poisson(torch.full((s,), 1.16, device=dev), generator=gen).to(torch.int32)
    deg[real:] = 0
    start = (torch.rand(s, generator=gen, device=dev) * (m - 64)).to(torch.int32)
    dst = torch.randint(0, m, (m,), dtype=torch.int32, generator=gen, device=dev)
    pri = torch.rand((s, 16), generator=gen, device=dev)
    cases = [("pattern", start, deg, dst, None, pri, 15),
             ("pattern", start, deg, dst, None, pri, 10)]
    s, m = 65_536, 4_000_000
    deg = torch.poisson(torch.ones(s, device=dev), generator=gen).to(torch.int32)
    pick = torch.rand(s, generator=gen, device=dev)
    mid = torch.randint(9, 33, (s,), dtype=torch.int32, generator=gen, device=dev)
    hub = torch.randint(40, 1001, (s,), dtype=torch.int32, generator=gen, device=dev)
    deg = torch.where(pick < 0.05, mid, torch.where(pick < 0.08, hub, deg))
    start = (torch.rand(s, generator=gen, device=dev) * (m - 1024)).to(torch.int32)
    dst = torch.randint(0, m, (m,), dtype=torch.int32, generator=gen, device=dev)
    words = torch.randint(-2**31, 2**31, (-(-m // 32),), dtype=torch.int64, generator=gen,
                          device=dev).to(torch.int32)
    pri = torch.rand((s, 1024), generator=gen, device=dev)
    cases.append(("hubs", start, deg, dst, words, pri, 15))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    smi = kernel_ablation.card()
    libs = kernel_ablation.build_variants(kernel, "window_select", CUTS)
    gen = torch.Generator(device="cuda").manual_seed(17)
    for name, start, deg, dst, words, pri, fanout in _inputs(gen):
        outs = {v: [torch.empty((start.numel(), fanout), dtype=dt, device="cuda")
                    for dt in (torch.int32, torch.int32, torch.bool)] for v in libs}

        def launch(v):
            kernel.launch_window_select(start, deg, dst, words, pri, *outs[v])

        def check(v):
            if v not in WRONG_BY_DESIGN:
                if not all(a.equal(b) for a, b in zip(outs[v], outs["base"])):
                    raise RuntimeError(f"{name}: {v} disagrees with base")

        row = {"input": name, "fanout": fanout, "W": pri.shape[-1], "card": smi,
               "device_ms": kernel_ablation.time_in_turns(kernel, libs, launch, check,
                                                          "window_select_kernel", args.reps)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
