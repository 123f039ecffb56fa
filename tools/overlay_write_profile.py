"""Where an overlay write batch's host time goes: phase 3g's first batches under cProfile.

    PYTHONPATH=src python tools/overlay_write_profile.py [--edges 10000000] [--batches 2]

Needs one CUDA card and ``nvcc``.  Builds ``chip_smoke.py``'s graph (graph3
of Tab. I by default, from ``--seed``), answers one request of each of phase
3's six kinds to seal both stores, then runs the first ``--batches`` write
batches of phase 3g's stream (``chip_smoke.overlay_ops``: ``insert_edges``,
``add_edge_relationships``, ``add_node_labels``) on a fork, each followed by
one ``match()``, under ``cProfile``.  A synchronising call holds the wait
for the card, so device time shows in the function that waited.

Prints the card's name and power limit, then one JSON object: the seconds
of the profiled run and the ``--top`` functions with the most time of their
own (``function``, ``ms``, ``calls``).
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.graph.generators import random_uniform_graph  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=10_000_000, help="graph3 of Tab. I")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("overlay_write_profile: torch sees no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sync = torch.cuda.synchronize
    src, dst = random_uniform_graph(args.edges, seed=args.seed)
    pg, _ = chip_smoke.build_graph(src, dst, args.seed, "cuda", sync)
    kinds = chip_smoke.requests(6)
    for _, text in kinds:
        pg.match(text)
    sync()
    stream = chip_smoke.overlay_ops(pg, args.seed, chip_smoke.OVERLAY_BATCH)
    stream = [s for s in stream if s[0] != "snapshot"][:3 * args.batches]
    ov = pg.fork()

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    chip_smoke.apply_ops(ov, stream, sync, lambda i, _s: ov.match(kinds[i % 6][1]))
    sync()
    prof.disable()
    seconds = time.perf_counter() - t0
    stats = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: kv[1][2], reverse=True)
    top = [{"function": f"{Path(f).name}:{line}({name})", "ms": tt * 1e3, "calls": nc}
           for (f, line, name), (_cc, nc, tt, _ct, _callers) in stats[:args.top]]
    print(json.dumps({"edges": args.edges, "batches": args.batches,
                      "batch": chip_smoke.OVERLAY_BATCH, "seconds": seconds, "top": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
