"""Time two hand kernels' wrappers on the card at phase 5's shapes, to hold
one checkout's launch path against another's in one call.

    python tools/wrapper_timing.py [--src PATH] [--label NAME] [--reps 200]

B4 at ``serve_p99`` (16 batches of 512 rows in turn over 26 × 1,000,000 ×
64 f32 tables: the host's launch path, the kernel ~5 µs) and B6 at
``prefill_8k``'s local and global layers (q (1, 8192, 16, 256), k, v (1,
8192, 8, 256) bf16, causal, cap 50, window 4,096 on the local one).
``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so two checkouts' wrappers can be timed in
turns on one card (parent, change, change, parent).  Prints one JSON line:
the card's name and power limit, and per case the wrapper's ms a call
(CUDA events around ``--reps`` calls; the median and the least of 5
windows, after 20 warm calls).  Needs the card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path


def windows(fn, reps: int, n: int = 5):
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return {"median_ms": statistics.median(out), "min_ms": min(out), "windows_ms": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch

    from repro_torch.kernels.embedding_bag import ops as b4
    from repro_torch.kernels.flash_attention import ops as b6

    if not torch.cuda.is_available():
        print("wrapper_timing: torch sees no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables = torch.randn((26, 1_000_000, 64), generator=gen, device="cuda")
    idxs = [torch.randint(0, 1_000_000, (512, 26, 1), generator=gen, device="cuda",
                          dtype=torch.int32) for _ in range(16)]
    pending = itertools.cycle(idxs)
    out = {"label": args.label, "src": args.src, "card": smi,
           "b4_serve_p99": windows(lambda: b4.embedding_bag_fields(tables, next(pending)),
                                   args.reps)}
    del tables, idxs
    q = torch.randn((1, 8192, 16, 256), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, 8192, 8, 256), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    for name, window in (("b6_prefill_8k_local", 4096), ("b6_prefill_8k_global", None)):
        out[name] = windows(lambda: b6.flash_attention(q, k, v, causal=True, window=window,
                                                       cap=50.0), max(args.reps // 10, 10))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
