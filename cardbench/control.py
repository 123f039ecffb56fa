"""The controls that the limits of ``correct`` are set against.

    python3 cardbench/control.py --workload <cell> --seeds <n> [<n> ...]

A control is the reference put in the program's place at a lower
guarantee, on the cell's own graph and requests.  Its readings go through
the cell's own comparison (``run.judge`` with the mix's limits), and each
control has to come out not correct.  Per seed it prints one JSON line:

* pattern cells: ``bfloat16_columns``, the reference with the ``w``
  column held in bfloat16 instead of the float32 the store holds it in
  (the nearest lower precision of the only floating-point data the path
  reads; the anchored predicates put an edge one float32 unit below their
  bound), and ``unrolled_closure``, the
  reference whose unbounded hops stop after ``CLOSURE_ROUNDS`` closure
  rounds instead of at the fixed point (the exactness the configuration
  states, given up);
* analytics cells: ``bfloat16``, SSSP's and PageRank's reference computed
  in bfloat16, the precision below the port's float32 distances and ranks.

The benchmark's own runs never run it.  No program is built: the graph and
the requests come from the same seed streams a run uses.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from cardbench import generator, graphdata  # noqa: E402
from cardbench.reference import analytics, patterns  # noqa: E402

CLOSURE_ROUNDS = 0  # each unbounded hop ends after one step: `*` read as `*1..1`
PATTERNS_PER_CLIENT = 6  # one shuffled round of the six kinds per client


def pattern_readings(cfg: dict, mix: dict, data: dict, seed: int, device) -> dict:
    g = patterns.Graph(data, cfg, device)
    low = patterns.Graph(data, cfg, device, prop_dtype=torch.bfloat16)
    anchored = generator.anchors(mix, data, seed)
    lower = unrolled = 0
    for client in range(int(mix["clients"])):
        stream = generator.PatternStream(mix, seed, generator.WINDOW_STREAM, client, anchored)
        for _ in range(PATTERNS_PER_CLIENT):
            _, text = stream.next()
            want = patterns.match(g, text)
            lower += patterns.mismatched_bits(patterns.match(low, text), want)
            unrolled += patterns.mismatched_bits(
                patterns.match(g, text, closure_rounds=CLOSURE_ROUNDS), want)
    return {"bfloat16_columns": {"mismatched_bits": lower},
            "unrolled_closure": {"mismatched_bits": unrolled}}


def analytics_readings(cfg: dict, mix: dict, data: dict, seed: int, device) -> dict:
    src, dst, n = data["esrc"], data["edst"], data["n"]
    w = data["eprops"]["w"]
    sources = torch.unique(src).cpu().numpy()
    draw = generator.rng(seed, generator.WINDOW_STREAM)
    gap = 0.0
    for _ in range(int(mix["keep"])):
        s = int(sources[draw.integers(len(sources))])
        want = analytics.shortest_paths(src, dst, n, w, s, torch.float64)
        low = analytics.shortest_paths(src, dst, n, w, s, torch.bfloat16)
        gap = max(gap, analytics.max_relative_gap(low, want))
    pr = {c["kind"]: c.get("args", {}) for c in mix["calls"]}["pr"]
    kw = {"damping": pr["damping"], "iters": pr["iters"]}
    l1 = analytics.l1_gap(analytics.pagerank(src, dst, n, torch.bfloat16, **kw),
                          analytics.pagerank(src, dst, n, torch.float64, **kw))
    return {"bfloat16": {"sssp_gap": gap, "pr_l1": l1}}


def readings(plan: dict, seed: int, device) -> dict:
    """Per control, the numbers it reaches of those the cell compares."""
    cfg, mix = plan["cfg"], plan["mix"]
    data = graphdata.make(cfg, seed, device)
    fn = pattern_readings if "templates" in mix else analytics_readings
    return fn(cfg, mix, data, seed, device)


def judged(plan: dict, seed: int, device) -> dict:
    """Per control, the cell's own verdict on its readings: ``correct`` and
    each number beside its limit."""
    from cardbench import run

    out = {}
    for name, checks in readings(plan, seed, device).items():
        correct, numbers = run.judge(checks, plan["mix"]["limits"])
        out[name] = {"correct": correct, "checks": numbers}
    return out


def main(argv=None) -> int:
    import argparse

    from cardbench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plan = run.cell_plan(run.load_json("BENCHMARK.json"), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = judged(plan, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
