#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--edges 10000000] [--seed 0]

Needs one CUDA card and ``nvcc``; exits non-zero without them.  Phases,
none of whose failures is caught:

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/*/csrc``, one ``nvcc`` per source, together;
2. hold every kernel against its plain PyTorch version on the card,
   bitwise, over ragged shapes;
3. the main path at the paper's Tab. I ``graph3`` scale (10M edges drawn
   uniformly from a pool of 10M ids, §VII-A; 50 labels, 50 relationships,
   one int64 vertex column, one float64 edge column): build a
   ``PropGraph(backend="arr")`` on the card, answer a mix of ``match()``
   requests (fused 1-hop, 2-hop with a fused edge batch, predicates,
   reversed hop, ``*1..3``, ``*``), time them, and hold every request kind
   bitwise against the same graph run through the port on the CPU;
3b. sampling on the same graph: three ``PropGraph.sample`` requests with
   GraphSAGE's 15-10 fanouts (1,024 explicit ids; the seeds of a label
   pattern; a predicate pattern under an edge filter), timed; every layer
   checked by the port's ``check_sample`` and every block held bitwise
   against the port on the CPU fed the card's priorities;
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
import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
N_ATTRS = 50  # §VII-A: 50 labels and 50 relationships
SOURCES = {  # kernel family -> its CUDA source
    "bitmap_query": "src/repro_torch/kernels/bitmap_query/csrc/bitmap_query.cu",
    "neighbor_sample": "src/repro_torch/kernels/neighbor_sample/csrc/neighbor_sample.cu",
}
FANOUTS = [15, 10]  # GraphSAGE 15-10
CHECK_ROWS = 4096  # rows of a sampled layer held to the Python-loop oracle


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
    window_select_checks(device)
    torch.cuda.synchronize()


def window_select_checks(device) -> None:
    """B3 against its plain version, bitwise: ragged windows (degrees past
    W, zero degrees, a ragged last edge word), no / shared / per-request
    edge words, and every other case with priorities forced to tie."""
    import torch

    from repro_torch.kernels.neighbor_sample import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(1)
    case = 0
    for r in (1, 8):
        for s in (1, 17, 1024, 262_144):
            for w in (8, 16, 64, 1024):
                if r * s * w > 2**28:  # keep the plain version's sort within 1 GiB of input
                    continue
                m = 2 * s * min(w, 64) + 13
                dst = torch.randint(0, m, (m,), dtype=torch.int32, generator=gen)
                deg = torch.randint(0, w + 5, (r, s), dtype=torch.int32, generator=gen)
                deg[torch.rand((r, s), generator=gen) < 0.1] = 0
                deg = deg.clamp(max=m)
                start = (torch.rand((r, s), generator=gen) * (m - deg + 1)).to(torch.int32)
                pri = torch.rand((r, s, w), generator=gen)
                if case % 2:
                    pri = torch.floor(pri * 3) / 3
                words = torch.randint(-2**31, 2**31, (r, -(-m // 32)), dtype=torch.int64,
                                      generator=gen).to(torch.int32)
                args = [t.to(device) for t in (start, deg, dst, pri, words)]
                start, deg, dst, pri, words = args
                for fanout in (1, 10, 15):
                    if fanout > w:
                        continue
                    for ew in (None, words[0].contiguous(), words):
                        got = ops.window_select(start, deg, dst, ew, pri, fanout=fanout)
                        want = ref.window_select_ref(start, deg, dst, ew, pri, fanout=fanout)
                        check(all(a.equal(b) for a, b in zip(got, want)),
                              f"B3 R={r} S={s} W={w} fanout={fanout} "
                              f"words={None if ew is None else tuple(ew.shape)} ties={case % 2}")
                case += 1
                del args, start, deg, dst, pri, words


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


# ---------------------------------------------------------------- sampling
def sample_requests(pg, seed: int):
    """Phase 3b's three requests: (kind, seeds or seed pattern, edge filter)."""
    nodes = pg.graph.node_map.cpu().numpy()
    ids = np.random.default_rng(seed + 4).choice(nodes, 1024, replace=False)
    return [("ids", ids, None),
            ("pattern", "(a:l0)", None),
            ("filtered", "(a:l0 {age > 50})", "(a)-[e {w < 0.5}]->(b)")]


@contextlib.contextmanager
def recording():
    """Record, in call order, every priority draw (key, shape, tensor), every
    layer's selection (seeds, valid, edge words, fanout and outputs) and
    every B3 call's inputs, of the sampling calls inside the block."""
    from repro_torch.kernels.neighbor_sample import ops

    rec = {"draws": [], "layers": [], "b3": []}
    saved = ops._draw_priorities, ops._window_select, ops.window_select

    def draw(key, shape, device):
        u = saved[0](key, shape, device)
        rec["draws"].append((key, tuple(shape), u))
        return u

    def layer(seg, dst, m, n, seeds, valid, ew_words, u, fanout):
        out = saved[1](seg, dst, m, n, seeds, valid, ew_words, u, fanout)
        rec["layers"].append((seeds, valid, ew_words, fanout, out))
        return out

    def b3(start, deg, dst, ew_words, pri, *, fanout):
        rec["b3"].append((start, deg, dst, ew_words, pri, fanout))
        return saved[2](start, deg, dst, ew_words, pri, fanout=fanout)

    ops._draw_priorities, ops._window_select, ops.window_select = draw, layer, b3
    try:
        yield rec
    finally:
        ops._draw_priorities, ops._window_select, ops.window_select = saved


@contextlib.contextmanager
def replaying(draws):
    """Hand the recorded priorities back, in order, to the sampling calls
    inside the block (on whatever device they run)."""
    from repro_torch.kernels.neighbor_sample import ops

    saved = ops._draw_priorities
    pending = iter(draws)

    def draw(key, shape, device):
        k, shp, u = next(pending)
        check(k == key and shp == tuple(shape), f"replayed draw {k}{shp} for {key}{shape}")
        return u.to(device)

    ops._draw_priorities = draw
    try:
        yield
    finally:
        ops._draw_priorities = saved


def check_layers(layers, seg, dst, m: int, seed: int) -> int:
    """Every recorded layer through ``check_sample`` (a random subset of
    ``CHECK_ROWS`` rows where it has more); returns the rows checked."""
    from repro_torch.core import bitplane
    from repro_torch.kernels.neighbor_sample.ref import check_sample

    rng = np.random.default_rng(seed)
    checked = 0
    for seeds, valid, ew, fanout, out in layers:
        keep = valid.cpu().numpy()
        sd = seeds.cpu().numpy()[keep]
        nb, ei, mk = (x.cpu().numpy()[keep] for x in out)
        rows = (np.sort(rng.choice(len(sd), CHECK_ROWS, replace=False))
                if len(sd) > CHECK_ROWS else np.arange(len(sd)))
        edge_ok = None if ew is None else bitplane.unpack_bits_host(ew.cpu().numpy(), m)
        check_sample(seg, dst, sd[rows], edge_ok, fanout, nb[rows], ei[rows], mk[rows])
        checked += len(rows)
    return checked


def same_blocks(a, b) -> bool:
    return len(a) == len(b) and all(
        getattr(x, f).dtype == getattr(y, f).dtype and np.array_equal(getattr(x, f), getattr(y, f))
        for x, y in zip(a, b)
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst", "edge_mask"))


def sampling_phase(pg, cpu_pg, seed: int, device: str, sync) -> dict:
    """Phase 3b (module docstring).  Returns per-kind results and the
    ``pattern`` request's layer-0 B3 inputs for phase 5."""
    from repro_torch.kernels.bitmap_query import ops as bq_ops
    from repro_torch.kernels.neighbor_sample import ops

    seg, dst = pg.graph.seg.cpu().numpy(), pg.graph.dst.cpu().numpy()
    out, b3_inputs = {}, None
    for kind, seeds, edge_filter in sample_requests(pg, seed):
        def request():
            return pg.sample(seeds, FANOUTS, seed=seed, pattern=edge_filter)

        ops.reset_launches()
        bq_ops.reset_launches()
        request()  # warm
        sync()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            request()
            sync()
            runs.append((time.perf_counter() - t0) * 1e3)
        launches = ops.launches[ops.WINDOW_SELECT]
        if device == "cuda":
            check(launches > 0, f"sample {kind}: the path launched B3")
            check(kind == "ids" or bq_ops.launches[bq_ops.PACKED] > 0,
                  f"sample {kind}: the seed pattern launched B1")
        with recording() as rec:
            blocks = request()
        sync()
        check(len(blocks) == len(FANOUTS) and len(rec["layers"]) == len(FANOUTS),
              f"sample {kind}: one block and one selection per layer")
        check(all(b.edge_mask.any() for b in blocks), f"sample {kind}: every layer sampled edges")
        checked = check_layers(rec["layers"], seg, dst, pg.n_edges, seed)
        with replaying(rec["draws"]):
            cpu_blocks = cpu_pg.sample(seeds, FANOUTS, seed=seed, pattern=edge_filter)
        check(same_blocks(blocks, cpu_blocks),
              f"sample {kind}: card blocks equal the CPU port's on the same priorities")
        if kind == "pattern":
            b3_inputs = rec["b3"][0]
        profiled = sample_profile(request) if device == "cuda" else None
        out[kind] = {"median_ms": statistics.median(runs), "runs_ms": runs,
                     "b3_launches": launches,
                     "seeds": int(blocks[-1].n_dst),
                     "layer_rows": [int(s.shape[-1]) for s, *_ in rec["layers"]],
                     "sampled_edges": [int(b.edge_mask.sum()) for b in blocks[::-1]],
                     "rows_checked": checked, "profile": profiled}
        del rec, blocks, cpu_blocks
    return {"requests": out, "b3_inputs": b3_inputs}


def sample_profile(request) -> dict:
    """One more run of a sample ``request`` under ``torch.profiler`` (the
    card's own time against the window: its busy share) and one under
    ``cProfile`` (where the host's time goes: the functions with the most
    time of their own, a synchronising call holding the wait for the card)."""
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    on_card = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_s = sum(e.self_device_time_total for e in on_card) / 1e6
    host = cProfile.Profile()
    host.enable()
    request()
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    return {"wall_ms": wall_s * 1e3, "device_ms": device_s * 1e3,
            "busy_share": device_s / wall_s if device_s else "not measured",
            "top_device_ms": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                              for e in on_card[:6]],
            "top_host_ms": [(f"{Path(f).name}:{line}({fn})", tt * 1e3, nc)
                            for (f, line, fn), (_cc, nc, tt, _ct, _callers) in top]}


def window_select_entry(b3_inputs, launches: int) -> dict:
    """Phase 5's B3 line at the ``pattern`` request's layer-0 shape.  The
    bound counts what these inputs need: start and degree of every seed,
    the priority and edge word of every lane inside a window, the DST entry
    of every selected lane, and the three outputs."""
    import torch

    from repro_torch.core import bitplane
    from repro_torch.kernels.neighbor_sample import ops, ref

    start, deg, dst, ew, pri, fanout = b3_inputs
    got = ops.window_select(start, deg, dst, ew, pri, fanout=fanout)
    want = ref.window_select_ref(start, deg, dst, ew, pri, fanout=fanout)
    t, w = start.numel(), pri.shape[-1]
    lanes = torch.minimum(deg.clamp(min=0), torch.full_like(deg, w)).to(torch.int64)
    n_words = bitplane.n_words(dst.numel())
    touched = torch.zeros(n_words + 1, dtype=torch.bool, device=start.device)
    first = start.to(torch.int64) >> 5
    last = (start.to(torch.int64) + lanes - 1) >> 5
    live = lanes > 0
    for j in range(w // 32 + 2):
        idx = first + j
        touched[torch.where(live & (idx <= last), idx, n_words)] = True
    words_bytes = 4 * int(touched[:n_words].sum()) if ew is not None else 0
    out_bytes = t * fanout * 9
    needed = 8 * t + 4 * int(lanes.sum()) + words_bytes + 4 * int(got[2].sum()) + out_bytes
    dense = 8 * t + 4 * t * w + words_bytes + 4 * int(got[2].sum()) + out_bytes
    return {"name": "window_select (B3)", "route": "cuda", "source": SOURCES["neighbor_sample"],
            "replaces": "src/repro/kernels/neighbor_sample/kernel.py:81",
            "launches": launches,
            "max_abs_err": max(max_abs_err(a, b) for a, b in zip(got, want)),
            "ms": time_ms(lambda: ops.window_select(start, deg, dst, ew, pri, fanout=fanout)),
            "plain_ms": time_ms(lambda: ref.window_select_ref(start, deg, dst, ew, pri,
                                                              fanout=fanout), 10),
            "bound_ms": needed / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "bound_all_lanes_ms": dense / HBM_BYTES_PER_S * 1e3,
            "shape": {"S": t, "W": w, "fanout": fanout, "m": dst.numel(),
                      "window_lanes": int(lanes.sum()), "edge_words": ew is not None}}


def run(edges: int, seed: int, device: str, n_requests: int = 32) -> dict:
    import torch

    from repro_torch.core import PropGraph, bitplane
    from repro_torch.kernels.bitmap_query import kernel, ops, ref
    from repro_torch.kernels.neighbor_sample import kernel as ns_kernel

    out = {"device": device}
    # --- phase 1: build the kernels, one nvcc per source, all at once
    t0 = time.perf_counter()
    if device == "cuda":
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(lambda build: build(), (kernel.build, ns_kernel.build)))
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
    print("phase 3 ok: every request kind equals the CPU port bit for bit", flush=True)

    # --- phase 3b: sampling on the same graph
    sampled = sampling_phase(pg, cpu_pg, seed, device, sync)
    out["sample"] = sampled["requests"]
    del cpu_pg
    print("phase 3b timings", json.dumps({k: (v["median_ms"], v["b3_launches"])
                                          for k, v in out["sample"].items()}), flush=True)
    print("phase 3b ok: every layer passes check_sample and equals the CPU port bit for bit",
          flush=True)

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
        b1 = {"name": "bitmap_query_packed (B1)", "route": "cuda", "source": SOURCES["bitmap_query"],
              "replaces": "src/repro/kernels/bitmap_query/kernel.py:118",
              "launches": main_launches[ops.PACKED],
              "max_abs_err": max_abs_err(got, ref.bitmap_query_batched_packed_ref(plane, masks)),
              "ms": time_ms(lambda: ops.bitmap_query_batched_packed(plane, masks)),
              "plain_ms": time_ms(lambda: ref.bitmap_query_batched_packed_ref(plane, masks), 10),
              "bound_ms": (k * w * 4 + plan_q * k + plan_q * w * 4) / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "library_ms": None,
              "shape": {"Q": plan_q, "K": k, "W": w}}
        got = ops.bitmap_query_batched(bitmap, masks)
        b2 = {"name": "bitmap_query_byte (B2)", "route": "cuda", "source": SOURCES["bitmap_query"],
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
        b3 = window_select_entry(sampled["b3_inputs"],
                                 sum(v["b3_launches"] for v in out["sample"].values()))
        check(b3["max_abs_err"] == 0, "timed B3 exact")
        out["kernels"] = [b1, b2, b3]
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
