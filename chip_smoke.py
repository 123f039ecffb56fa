#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--edges 10000000] [--seed 0]

Needs one CUDA card and ``nvcc``; exits non-zero without them.  Phases,
none of whose failures is caught:

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/*/csrc``;
2. hold every kernel against its plain PyTorch version on the card,
   bitwise, over ragged shapes;
3. the main path at the paper's Tab. I ``graph3`` scale (10M edges drawn
   uniformly from a pool of 10M ids, §VII-A; 50 labels, 50 relationships,
   one int64 vertex column, one float64 edge column): build a
   ``PropGraph(backend="arr")`` on the card, answer a mix of ``match()``
   requests (fused 1-hop, 2-hop with a fused edge batch, predicates,
   reversed hop, ``*1..3``, ``*``), time them, and hold every request kind
   bitwise against the same graph run through the port on the CPU;
4. the byte layout (``byte_masks()``): build it and answer a fused pattern,
   which runs the byte kernel; its masks must equal the packed graph's;
5. time each kernel at the main path's shapes beside its plain version,
   its bound and (where one exists) a PyTorch call computing the same.

Kernel launch counts are zeroed right before each path and read right
after it; a kernel of the path that did not launch fails the run.  The
second-to-last lines are a JSON object with one entry per kernel and the
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
N_ATTRS = 50  # §VII-A: 50 labels and 50 relationships
SOURCE = "src/repro_torch/kernels/bitmap_query/csrc/bitmap_query.cu"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------- the data
def random_uniform_graph(m: int, seed: int):
    """§VII-A: (src, dst) uniform over a pool of ``m`` ids."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, m, size=m, dtype=np.int64),
            rng.integers(0, m, size=m, dtype=np.int64))


def attach_random_attributes(n_entities: int, seed: int):
    """§VII-A: each drawn entity takes one of ``N_ATTRS`` attributes."""
    rng = np.random.default_rng(seed)
    entities = rng.choice(n_entities, size=n_entities, replace=True).astype(np.int64)
    attrs = rng.integers(0, N_ATTRS, size=n_entities, dtype=np.int64)
    return entities, attrs


def build_graph(src, dst, seed: int, device, sync=lambda: None):
    """Ingest the graph, its labels, relationships and two typed columns.
    Returns the graph and the seconds each ingest step took (the input
    data for a step is made before its clock starts)."""
    from repro_torch.core import PropGraph

    steps = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        steps[name] = time.perf_counter() - t0

    pg = PropGraph(backend="arr", device=device)
    timed("edges", pg.add_edges_from, src, dst)
    nodes = pg.graph.node_map.cpu().numpy()
    es, ed = pg.graph.src.cpu().numpy(), pg.graph.dst.cpu().numpy()
    ents, attrs = attach_random_attributes(pg.n_vertices, seed + 1)
    timed("labels", pg.add_node_labels, nodes[ents],
          np.array([f"l{i}" for i in range(N_ATTRS)])[attrs])
    ents, attrs = attach_random_attributes(pg.n_edges, seed + 2)
    timed("relationships", pg.add_edge_relationships, nodes[es[ents]], nodes[ed[ents]],
          np.array([f"r{i}" for i in range(N_ATTRS)])[attrs])
    rng = np.random.default_rng(seed + 3)
    timed("vertex_column", pg.add_node_properties, "age", nodes,
          rng.integers(0, 100, pg.n_vertices, dtype=np.int64))
    timed("edge_column", pg.add_edge_properties, "w", nodes[es], nodes[ed],
          rng.random(pg.n_edges))
    # seal both stores: planes built and placed
    timed("seal", lambda: (pg._vstore.finalize(), pg._estore.finalize()))
    return pg, steps


def requests(count: int):
    """``count`` patterns cycling through the six request kinds."""
    kinds = [
        ("fused_1hop", "(a:l{0}|l{1})-[:r{0}]->(b:l{2})"),
        ("two_hop", "(a:l{0})-[:r{0}]->(b)-[:r{1}|r{2}]->(c:l{3})"),
        ("predicates", "(a:l{0} {{age > 50}})-[e:r{0} {{w < 0.25}}]->(b:l{1})"),
        ("reversed", "(a:l{0})<-[:r{0}]-(b:l{1})"),
        ("bounded", "(a:l{0})-[:r{0}*1..3]->(b)"),
        ("unbounded", "(a:l{0})-[:r{0}|r{1}*]->(b:l{2})"),
    ]
    out = []
    for i in range(count):
        name, text = kinds[i % len(kinds)]
        j = (7 * (i // len(kinds))) % (N_ATTRS - 4)
        out.append((name, text.format(j, j + 1, j + 2, j + 3)))
    return out


def same_result(a, b) -> bool:
    """Masks and bindings of two MatchResults equal bit for bit."""
    if not (a.vertex_mask.cpu().equal(b.vertex_mask.cpu())
            and a.edge_mask.cpu().equal(b.edge_mask.cpu())):
        return False
    ba, bb = a.bindings(), b.bindings()
    return set(ba) == set(bb) and all(ba[k].cpu().equal(bb[k].cpu()) for k in ba)


# ------------------------------------------------------------------ timing
def time_ms(fn, reps: int = 50) -> float:
    import torch

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


def max_abs_err(a, b) -> float:
    import torch

    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0


def device_profile(pg, reqs) -> dict:
    """Answer ``reqs`` once more under ``torch.profiler``: the summed time
    of the work that ran on the card (kernels and copies, one stream, so
    they do not overlap) against the window's wall time — the device's busy
    share; the profiler's own host cost lengthens the window — and the
    kernels that took the most of it.  Only device-side events are summed:
    a host op's device time repeats its kernels'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, text in reqs:
            pg.match(text)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    on_card = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_s = sum(e.self_device_time_total for e in on_card) / 1e6
    return {"wall_s": wall_s, "device_s": device_s,
            "busy_share": device_s / wall_s if device_s else "not measured",
            "top_ms": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                       for e in on_card[:12]]}


# ------------------------------------------------------------------ phases
def kernel_checks(device) -> None:
    """Every kernel against its plain version, bitwise, on ragged shapes."""
    import torch

    from repro_torch.kernels.bitmap_query import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(0)
    for q in (1, 2, 3, 8, 64):
        for k in (1, 50, 129, 300):
            for cols in (1, 31, 4099, 100_003):
                masks = (torch.rand((q, k), generator=gen) < 0.3).to(device)
                plane = torch.randint(-2**31, 2**31, (k, cols), dtype=torch.int64,
                                      generator=gen).to(torch.int32).to(device)
                got = ops.bitmap_query_batched_packed(plane, masks)
                check(got.equal(ref.bitmap_query_batched_packed_ref(plane, masks)),
                      f"B1 Q={q} K={k} W={cols}")
                bitmap = (torch.rand((k, cols), generator=gen) < 0.05).to(torch.int8).to(device)
                got = ops.bitmap_query_batched(bitmap, masks)
                check(got.equal(ref.bitmap_query_batched_ref(bitmap, masks)),
                      f"B2 Q={q} K={k} N={cols}")
    plane = torch.randint(0, 2**31, (50, 4099), dtype=torch.int32).to(device)
    mask = torch.rand(50) < 0.5
    check(ops.bitmap_query_packed(plane, mask.to(device)).equal(
        ref.bitmap_query_packed_ref(plane, mask.to(device))), "B1 single query")
    torch.cuda.synchronize()


def answer(pg, reqs, sync):
    """Answer ``reqs`` on ``pg``, ``sync()`` ending each request; returns
    per-request latencies (ms), the results and the window's seconds."""
    lat, results = [], []
    sync()
    t_all = time.perf_counter()
    for _, text in reqs:
        t0 = time.perf_counter()
        res = pg.match(text)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    total = time.perf_counter() - t_all
    return lat, results, total


def run(edges: int, seed: int, device: str, n_requests: int = 32) -> dict:
    import torch

    from repro_torch.core import PropGraph, bitplane
    from repro_torch.kernels.bitmap_query import kernel, ops, ref

    out = {"device": device}
    # --- phase 1: build the kernels
    t0 = time.perf_counter()
    if device == "cuda":
        kernel.build()
    out["kernel_build_s"] = time.perf_counter() - t0

    # --- phase 2: kernels against their plain versions
    if device == "cuda":
        kernel_checks(device)
    print("phase 2 ok: kernels equal their plain versions", flush=True)

    # --- phase 3: the main path (packed layout)
    src, dst = random_uniform_graph(edges, seed)
    ops.reset_launches()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    pg, out["build_steps_s"] = build_graph(src, dst, seed, device, sync)
    out["build_s"] = time.perf_counter() - t0
    out["n"], out["m"] = pg.n_vertices, pg.n_edges
    reqs = requests(n_requests)
    for _, text in requests(6):  # warm: one request of each kind, untimed
        pg.match(text)
    lat, results, total = answer(pg, reqs, sync)
    main_launches = dict(ops.launches)
    if device == "cuda":
        check(main_launches[ops.PACKED] > 0, "the main path launched the packed kernel")
    out["requests"] = len(reqs)
    out["p50_ms"] = statistics.median(lat)
    out["p95_ms"] = float(np.percentile(lat, 95))
    out["qps"] = len(reqs) / total
    out["per_kind_ms"] = {k: statistics.median([t for (kk, _), t in zip(reqs, lat) if kk == k])
                          for k, _ in requests(6)}
    out["matched_vertices"] = {k: r.n_vertices() for (k, _), r in zip(reqs[:6], results[:6])}
    print("phase 3 timings", json.dumps({k: out[k] for k in
                                        ("build_s", "n", "m", "p50_ms", "p95_ms", "qps")}),
          flush=True)

    if device == "cuda":
        out["profile"] = device_profile(pg, reqs)

    # correctness at full size: each request kind against the port on the CPU
    cpu_pg = PropGraph.from_arrays(pg.to_arrays(), device="cpu")
    for (kind, text), res in zip(reqs[:6], results[:6]):
        check(res.vertex_mask.shape == (pg.n_vertices,) and res.edge_mask.shape == (pg.n_edges,),
              f"{kind}: result shapes")
        check(same_result(res, cpu_pg.match(text)), f"{kind}: card result equals CPU result")
    check(all(r.n_vertices() > 0 for r in results[:6]), "every request kind matched something")
    del cpu_pg
    print("phase 3 ok: every request kind equals the CPU port bit for bit", flush=True)

    # --- phase 4: the byte layout
    ops.reset_launches()
    with bitplane.byte_masks():
        pgb, _ = build_graph(src, dst, seed, device)
    check(not pgb._vstore.packed, "byte_masks() built a byte store")
    text = reqs[0][1]
    resb = pgb.match(text)
    sync()
    byte_launches = dict(ops.launches)
    if device == "cuda":
        check(byte_launches[ops.BYTE] > 0, "the byte path launched the byte kernel")
    check(same_result(resb, results[0]), "byte layout equals packed layout")
    print("phase 4 ok: byte layout equals packed layout", flush=True)

    # --- phase 5: kernel times at the main path's shapes
    if device == "cuda":
        fused = pg.explain(reqs[0][1])
        plan_q = 2  # the fused 1-hop request batches its two node masks
        check("node slots [0, 1]" in fused, "fused 1-hop plan batches both node masks")
        masks = torch.zeros((plan_q, pg._vstore.k), dtype=torch.bool)
        masks[0, :2] = True
        masks[1, 2] = True
        masks = masks.to(device)
        plane = pg._vstore.finalize().bitmap
        bitmap = pgb._vstore.finalize().bitmap
        k, w = plane.shape
        n = bitmap.shape[1]
        got = ops.bitmap_query_batched_packed(plane, masks)
        b1 = {"name": "bitmap_query_packed (B1)", "route": "cuda", "source": SOURCE,
              "replaces": "src/repro/kernels/bitmap_query/kernel.py:118",
              "launches": main_launches[ops.PACKED],
              "max_abs_err": max_abs_err(got, ref.bitmap_query_batched_packed_ref(plane, masks)),
              "ms": time_ms(lambda: ops.bitmap_query_batched_packed(plane, masks)),
              "plain_ms": time_ms(lambda: ref.bitmap_query_batched_packed_ref(plane, masks), 10),
              "bound_ms": (k * w * 4 + plan_q * k + plan_q * w * 4) / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "library_ms": None,
              "shape": {"Q": plan_q, "K": k, "W": w}}
        got = ops.bitmap_query_batched(bitmap, masks)
        b2 = {"name": "bitmap_query_byte (B2)", "route": "cuda", "source": SOURCE,
              "replaces": "src/repro/kernels/bitmap_query/kernel.py:72",
              "launches": byte_launches[ops.BYTE],
              "max_abs_err": max_abs_err(got, ref.bitmap_query_batched_ref(bitmap, masks)),
              "ms": time_ms(lambda: ops.bitmap_query_batched(bitmap, masks)),
              "plain_ms": time_ms(lambda: ref.bitmap_query_batched_ref(bitmap, masks), 10),
              "bound_ms": (k * n + plan_q * k + plan_q * n) / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes",
              "library_ms": time_ms(lambda: (masks.half() @ bitmap.half()) > 0.5, 10),
              "shape": {"Q": plan_q, "K": k, "N": n}}
        check(b1["max_abs_err"] == 0 and b2["max_abs_err"] == 0, "timed kernels exact")
        # the edge plane, at the Q of a lone mask and of a fused edge batch
        eplane = pg._estore.finalize().bitmap
        for q in (1, 2):
            em = masks[:q].contiguous()
            out[f"b1_edge_plane_q{q}_ms"] = time_ms(
                lambda: ops.bitmap_query_batched_packed(eplane, em))
            out[f"b1_edge_plane_q{q}_bound_ms"] = (
                eplane.shape[0] * eplane.shape[1] * 4 + q * eplane.shape[0]
                + q * eplane.shape[1] * 4) / HBM_BYTES_PER_S * 1e3
        out["kernels"] = [b1, b2]
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=10_000_000, help="graph3 of Tab. I")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    out = run(args.edges, args.seed, "cuda")
    kernels = out.pop("kernels")
    print("summary", json.dumps(out), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
