"""Where B5's time goes: the seg_mm kernel timed with one part taken out.

    PYTHONPATH=src python tools/seg_mm_ablations.py [--reps 20]

Needs one CUDA card and ``nvcc``.  Each variant is
``src/repro_torch/kernels/seg_mm/csrc/seg_mm.cu`` with one part changed by
a text substitution, built and timed in turns by ``kernel_ablation``:

* ``base``: the kernel as it ships;
* ``scalar``: no 16-byte loads; every column a 4-byte unit;
* ``rows_2``, ``rows_4``: a group owns 2 or 4 rows (8 ship);
* ``edges_1``, ``edges_2``, ``edges_8``: a lane holds 1, 2 or 8 edges' x
  units in flight (4 ship);
* ``no_prefetch``: the next edges' (src, w) are loaded after the current
  edges are folded, not while their x units are in flight;
* ``no_staging``: rows of 4-byte units (D = 7) leave straight from
  registers, 4 bytes a lane, not staged in shared memory and written 16
  bytes a store by the block;
* ``d7_g4``: rows of 5-8 scalar units take 4 lanes and two passes (8 lanes
  and one pass ship);
* ``no_store``: the staged rows (D = 7) are never written out (the loads
  and folds alone; float4 rows, not staged, are unchanged).

Inputs, made on the card from a seed, all weighted: ``population_l1`` and
``population_l2`` are the GNN ``population`` request's two B5 calls at its
sizes (n = 315,745 rows, E = 247,866 edges with src and dst uniform over
the rows, D = 16 and 7); ``graph3_full`` is graph3's whole edge list (n =
8,646,926, E = 10,000,000 uniform, D = 16); ``hubs`` has 10 rows of 50,000
edges beside 500,000 edges spread uniformly over 100,000 rows (D = 16).
``no_store`` is wrong by design; every other variant is checked equal to
``base`` bit for bit.  Prints one JSON object per input, beside the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json

import torch

import kernel_ablation
from repro_torch.kernels.seg_mm import kernel, ops

CUTS = {
    "base": [],
    "scalar": [("const bool vec = d % 4 == 0 &&", "const bool vec = false && d % 4 == 0 &&")],
    "rows_2": [("constexpr int kRows = 8;", "constexpr int kRows = 2;")],
    "rows_4": [("constexpr int kRows = 8;", "constexpr int kRows = 4;")],
    "edges_1": [("constexpr int kEdges = 4;", "constexpr int kEdges = 1;")],
    "edges_2": [("constexpr int kEdges = 4;", "constexpr int kEdges = 2;")],
    "edges_8": [("constexpr int kEdges = 4;", "constexpr int kEdges = 8;")],
    # the loop that copied the prefetched edges loads the next ones itself
    "no_prefetch": [("      load_edges(sn, wn, src, w, e + kEdges, end, n_src);\n", ""),
                    ("#pragma unroll\n      for (int u = 0; u < kEdges; ++u) {\n        s[u] = sn[u];\n"
                     "        wt[u] = wn[u];\n      }\n",
                     "      load_edges(s, wt, src, w, e + kEdges, end, n_src);\n")],
    "no_staging": [("const bool staged = d <= G;", "const bool staged = false;")],
    "d7_g4": [("  } else if (units <= 8) {\n    launch<8, T>",
               "  } else if (units <= 8) {\n    launch<4, T>")],
    # a condition the compiler cannot decide, so the loads and folds stay
    "no_store": [("  if (kStaged) {\n    // the block's rows are one contiguous run",
                  "  if (kStaged && n_src < 0) {\n    // the block's rows are one contiguous run")],
}
WRONG_BY_DESIGN = ("no_store",)


def _edges(gen, n: int, e: int):
    dev = gen.device
    src = torch.randint(0, n, (e,), dtype=torch.int32, generator=gen, device=dev)
    dst = torch.randint(0, n, (e,), dtype=torch.int32, generator=gen, device=dev)
    return src, dst, torch.rand(e, generator=gen, device=dev)


def _inputs(gen: torch.Generator):
    """(name, x, src, dst, n, w) on the card."""
    dev = gen.device
    n, e = 315_745, 247_866
    src, dst, w = _edges(gen, n, e)
    cases = [("population_l1", torch.randn((n, 16), generator=gen, device=dev), src, dst, n, w),
             ("population_l2", torch.randn((n, 7), generator=gen, device=dev), src, dst, n, w)]
    n, e = 8_646_926, 10_000_000
    src, dst, w = _edges(gen, n, e)
    cases.append(("graph3_full", torch.randn((n, 16), generator=gen, device=dev), src, dst, n, w))
    n, e = 100_000, 1_000_000
    src, dst, w = _edges(gen, n, e)
    dst[:500_000] = (torch.arange(500_000, device=dev, dtype=torch.int32) % 10) * 9_973
    cases.append(("hubs", torch.randn((n, 16), generator=gen, device=dev), src, dst, n, w))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    smi = kernel_ablation.card()
    libs = kernel_ablation.build_variants(kernel, "seg_mm", CUTS)
    gen = torch.Generator(device="cuda").manual_seed(18)
    for name, x, src, dst, n, w in _inputs(gen):
        layout = ops.build_layout(dst, n, src)
        w_sorted = ops.weights_in_dst_order(layout, w)
        outs = {v: torch.empty((n, x.shape[1]), device="cuda") for v in libs}

        def launch(v):
            kernel.launch_seg_mm(x, layout.src_sorted, w_sorted, layout.row_ptr, outs[v])

        def check(v):
            if v not in WRONG_BY_DESIGN and not outs[v].equal(outs["base"]):
                raise RuntimeError(f"{name}: {v} disagrees with base")

        row = {"input": name, "D": x.shape[1], "n": n, "E": src.numel(), "card": smi,
               "device_ms": kernel_ablation.time_in_turns(kernel, libs, launch, check,
                                                          "seg_mm_kernel", args.reps)}
        print(json.dumps(row), flush=True)
        del outs
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
