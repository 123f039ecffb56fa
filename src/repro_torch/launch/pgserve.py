"""pgserve — CLI driver for the graph analytics service (``repro_torch.service``).

Builds named tenant graphs, generates a synthetic multi-tenant pattern
workload (zipf-skewed over a pattern pool — hot patterns repeat, like real
dashboards), and drives a ``Service`` with closed-loop concurrent clients,
reporting throughput/latency and the service's coalescing/cache counters.

    # throughput report: 2 tenant graphs, 64 requests, 8 concurrent clients
    PYTHONPATH=src python -m repro_torch.launch.pgserve --graphs 2 \
        --requests 64 --concurrency 8

    # smoke gate: correctness across all backends, and on an entity mesh
    PYTHONPATH=src python -m repro_torch.launch.pgserve --smoke

Network mode (the ``pgd`` front-end, docs/ARCHITECTURE.md §9):

    # foreground server process owning the graphs and the card
    PYTHONPATH=src python -m repro_torch.launch.pgserve --serve --port 8945

    # cross-process throughput: spawns the server, drives it with
    # concurrent PGClient connections over TCP
    PYTHONPATH=src python -m repro_torch.launch.pgserve --net --concurrency 8

    # smoke gate: client↔server round-trip bitwise vs in-process match
    PYTHONPATH=src python -m repro_torch.launch.pgserve --net --smoke

Everything runs on the CUDA card unless ``--device cpu`` asks for the CPU;
the spawned server takes the same ``--device``.  ``--mesh`` places the
tenant graphs on an entity mesh (``cli_mesh``: every card, or the one CPU
device); the smoke gates check a mesh too (``smoke_mesh``: every card
when there are several, else P = 8 shards on the one device).  The
workload and runner helpers are the building blocks of the port's serve
benchmark, so the CLI and a benchmark measure the same thing.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "build_tenant_graph",
    "cli_mesh",
    "smoke_mesh",
    "pattern_pool",
    "synthetic_workload",
    "run_workload",
    "run_workload_net",
    "warm_serving_path",
    "run_sequential",
    "spawn_server",
    "serve",
    "smoke",
    "net_smoke",
    "main",
]

N_LABELS = 12
RELS = ("follows", "likes")
SMOKE_SHARDS = 8  # the gates' P on a one-device machine (the reference CI forces 8 devices)


def _np(x) -> np.ndarray:
    """Host numpy of a torch tensor (on any device) or an array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _sync(device) -> None:
    """Wait for ``device``'s queue: the card's, nothing on the CPU."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cli_mesh(device):
    """``--mesh``'s entity mesh on ``device``'s kind, as the reference's
    ``make_entity_mesh()``: every card for a CUDA device, the one CPU
    device for the CPU."""
    import torch

    from repro_torch.launch.mesh import make_entity_mesh

    device = torch.device("cuda" if device is None else device)
    return make_entity_mesh() if device.type == "cuda" else make_entity_mesh(devices=[device])


def smoke_mesh(device):
    """The gates' mesh: every card when the machine has more than one;
    otherwise ``SMOKE_SHARDS`` shards on the one device (``device``: None
    is the card) — the port's counterpart of the reference CI's 8 forced
    host devices."""
    import torch

    from repro_torch.launch.mesh import make_entity_mesh

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return make_entity_mesh()
    return make_entity_mesh(devices=[device] * SMOKE_SHARDS)


def build_tenant_graph(backend: str, m: int, *, mesh=None, seed: int = 0, device=None):
    """One synthetic tenant on ``device`` (None: the CUDA card), or on the
    entity ``mesh``:
    Tab.-I-regime random graph with labels ``l0..l{N_LABELS-1}``,
    relationships ``follows``/``likes``, an ``age`` vertex property (the
    attribute shape every pool pattern queries) and a ``w`` edge weight in
    [0.5, 2) — what the weighted analytics traverse.  The same draws as the
    reference package's, so both build the same graph from one seed."""
    from repro_torch.core import PropGraph
    from repro_torch.graph import random_uniform_graph

    rng = np.random.default_rng(seed)
    src, dst = random_uniform_graph(m, seed=seed)
    pg = PropGraph(backend=backend, mesh=mesh, device=device).add_edges_from(src, dst)
    nodes = _np(pg.graph.node_map)
    pg.add_node_labels(nodes, rng.choice([f"l{i}" for i in range(N_LABELS)],
                                         size=len(nodes)))
    es, ed = _np(pg.graph.src), _np(pg.graph.dst)
    pg.add_edge_relationships(nodes[es], nodes[ed],
                              rng.choice(RELS, size=len(es)))
    pg.add_node_properties("age", nodes,
                           rng.integers(0, 90, len(nodes)).astype(np.int32))
    pg.add_edge_properties("w", nodes[es], nodes[ed],
                           rng.uniform(0.5, 2.0, len(es)).astype(np.float32))
    return pg


def pattern_pool() -> List[str]:
    """The query mix: 1-hop label/relationship shapes, predicate filters,
    reverse hops and a 2-hop chain — every planner path gets traffic."""
    return [
        "(a:l1|l2)-[:follows]->(b:l3)",
        "(a:l0)-[:likes]->(b:l4|l5)",
        "(a:l6 {age > 30})-[:follows]->(b)",
        "(a)<-[:likes]-(b:l7|l8)",
        "(a:l9)-[:follows]->(b:l10)",
        "(a:l2|l3 {age <= 60})-[:likes]->(b:l0)",
        "(a:l11)-[:likes]->(b:l1)",
        "(a:l4)-[:follows]->(b)-[:likes]->(c:l5)",
        "(a:l5|l6)-[:follows]->(b:l7)",
        "(a:l8 {age >= 18})-[:likes]->(b:l9|l10)",
        "(a:l3)<-[:follows]-(b:l2)",
        "(a:l0|l1|l2)-[:likes]->(b:l3|l4|l5)",
    ]


def synthetic_workload(
    graph_names: Sequence[str],
    pool: Sequence[str],
    n_requests: int,
    *,
    seed: int = 0,
    skew: float = 1.1,
) -> List[Tuple[str, str]]:
    """(graph, pattern) stream: tenants drawn uniformly, patterns drawn
    zipf-skewed (weight ∝ 1/rank^skew) — a hot head and a long tail, the
    distribution request coalescing and result caching are built for."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
    w = ranks ** -skew
    w /= w.sum()
    return [
        (graph_names[int(rng.integers(len(graph_names)))],
         pool[int(rng.choice(len(pool), p=w))])
        for _ in range(n_requests)
    ]


def _run_closed_loop(make_session, workload: Sequence[Tuple[str, str]],
                     concurrency: int, *, repeats: int = 1) -> Dict[str, float]:
    """The shared closed-loop harness behind ``run_workload`` (in-process)
    and ``run_workload_net`` (TCP): the workload splits round-robin over
    ``concurrency`` client threads; each thread gets its own session from
    ``make_session()`` — ``(call(graph, pattern), close())`` — and issues
    its next request only after the previous one resolved.  Session setup
    runs inside the measured loop on the client's own thread (a real
    client pays its connection cost too).  Returns wall/qps/latency
    metrics.

    ``repeats`` > 1 replays the workload and keeps the best-throughput
    run (latencies from that run) — multithreaded closed loops are highly
    exposed to cgroup CPU-quota throttling and noisy neighbors, and the
    best run is the least-interfered estimate of the service's own cost.
    Replays hit warm caches; measure cold behavior with ``repeats=1`` on
    a fresh ``Service``."""
    if repeats > 1:
        runs = [_run_closed_loop(make_session, workload, concurrency)
                for _ in range(repeats)]
        return max(runs, key=lambda r: r["qps"])
    lat_lock = threading.Lock()
    latencies: List[float] = []
    errors: List[BaseException] = []

    def client(items: List[Tuple[str, str]]) -> None:
        try:
            call, close = make_session()
        except BaseException as e:  # noqa: BLE001 — reported, not raised
            with lat_lock:
                errors.append(e)
            return
        try:
            for graph, pattern in items:
                t0 = time.monotonic()
                try:
                    call(graph, pattern)
                except BaseException as e:  # noqa: BLE001
                    with lat_lock:
                        errors.append(e)
                    return
                with lat_lock:
                    latencies.append(time.monotonic() - t0)
        finally:
            close()

    shards = [list(workload[i::concurrency]) for i in range(concurrency)]
    threads = [threading.Thread(target=client, args=(s,)) for s in shards if s]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    lat = np.sort(np.asarray(latencies))
    return {
        "wall_s": wall,
        "qps": len(workload) / wall,
        "p50_ms": float(lat[len(lat) // 2] * 1e3),
        "p95_ms": float(lat[min(int(len(lat) * 0.95), len(lat) - 1)] * 1e3),
    }


def run_workload(service, workload: Sequence[Tuple[str, str]],
                 concurrency: int, *, repeats: int = 1) -> Dict[str, float]:
    """Closed-loop clients against an in-process ``Service`` (the shared
    harness's docstring has the methodology)."""

    def make_session():
        return (lambda graph, pattern:
                service.submit(graph, pattern).result(timeout=120),
                lambda: None)

    return _run_closed_loop(make_session, workload, concurrency,
                            repeats=repeats)


def warm_serving_path(pg, pool: Sequence[str], *, max_masks: int = 64) -> None:
    """Warm everything steady-state serving will hit: each pattern's match
    and the batched store queries at every Q bucket ≤ ``max_masks`` —
    batch composition varies with load, and a shape first seen inside a
    measured (or served) window would pay the allocator's first blocks
    there (the port builds no program per shape; its kernel libraries load
    on first use)."""
    from repro_torch.kernels.bitmap_query.ops import Q_BUCKETS, bucketed_q

    dev = pg.device
    for p in pool:
        pg.match(p)
        _sync(dev)
    for b in Q_BUCKETS:
        pg._vstore.query_any_batched([()] * b)
        pg._estore.query_any_batched([()] * b)
        _sync(dev)
        if b >= bucketed_q(max_masks):
            break


def run_sequential(graphs: Dict[str, object],
                   workload: Sequence[Tuple[str, str]], *,
                   repeats: int = 1) -> Dict[str, float]:
    """The per-request baseline: every request is a single-tenant
    ``PropGraph.match`` call, its device synchronized, one after another
    (no service, no caches, no coalescing).  ``repeats`` keeps the best
    run, like ``run_workload``."""
    best = None
    for _ in range(max(repeats, 1)):
        t0 = time.monotonic()
        for graph, pattern in workload:
            pg = graphs[graph]
            pg.match(pattern)
            _sync(pg.device)
        wall = time.monotonic() - t0
        if best is None or wall < best:
            best = wall
    return {"wall_s": best, "qps": len(workload) / best}


# ------------------------------------------------------------- network mode
def serve(*, port: int = 0, host: str = "127.0.0.1", backend: str = "arr",
          backends: Optional[Sequence[str]] = None, graphs: int = 2,
          m: int = 20_000, seed: int = 0, mesh: bool = False,
          warm: bool = False, device=None) -> None:
    """Foreground server process: build the tenant graphs on ``device``
    (None: the CUDA card), bind, print ``PGSERVE LISTENING <port>`` (the
    spawn handshake), serve until a client sends ``shutdown``.

    ``backends`` (e.g. ``("arr", "list", "listd")``) builds ONE graph per
    backend, named after it — the multi-backend smoke layout; otherwise
    ``graphs`` tenants named ``tenant{i}`` on ``backend`` — the layout the
    workload generator and benchmarks address.  ``mesh`` places them on
    ``cli_mesh(device)``."""
    from repro_torch.service import PGServer, Service

    where = {"mesh": cli_mesh(device)} if mesh else {"device": device}
    with Service() as svc:
        if backends:
            named = {b: build_tenant_graph(b, m, seed=seed, **where) for b in backends}
        else:
            named = {f"tenant{i}": build_tenant_graph(backend, m, seed=seed + i, **where)
                     for i in range(graphs)}
        pool = pattern_pool()
        for name, pg in named.items():
            svc.add_graph(name, pg)
            if warm:
                warm_serving_path(pg, pool)
        server = PGServer(svc, host=host, port=port, device=device).start()
        print(f"PGSERVE LISTENING {server.port}", flush=True)
        server.wait_shutdown()
        server.close()
    print("PGSERVE SERVER EXIT", flush=True)


def spawn_server(extra_args: Sequence[str], *, timeout: float = 180.0):
    """Launch ``pgserve --serve --port 0 <extra_args>`` as a SEPARATE OS
    process and wait for its listening handshake; returns ``(proc, port)``.
    The child inherits the environment, with this package's ``src`` put
    first on ``PYTHONPATH``; pass ``--device`` in ``extra_args`` to pick
    its device (the CUDA card by default)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.pgserve", "--serve",
           "--port", "0", *extra_args]
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    # the handshake wait must not block in readline() itself — a wedged
    # child that stays silent would hang the caller past any deadline — so
    # a pump thread reads lines and the deadline is enforced on the queue
    # (the pump also keeps draining stdout afterwards, so a chatty server
    # can never fill the pipe and stall)
    import queue as _queue

    lines: "_queue.Queue" = _queue.Queue()

    def _pump() -> None:
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)  # EOF

    threading.Thread(target=_pump, name="pgserve-spawn-pump",
                     daemon=True).start()
    deadline = time.monotonic() + timeout
    port = None
    while True:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except _queue.Empty:
            break  # deadline passed with the child alive but silent
        if line is None:
            break  # child exited without the handshake
        if line.startswith("PGSERVE LISTENING "):
            port = int(line.split()[-1])
            break
    if port is None:
        proc.kill()
        raise RuntimeError("server process never reached LISTENING")
    return proc, port


def run_workload_net(port: int, workload: Sequence[Tuple[str, str]],
                     concurrency: int, *, repeats: int = 1,
                     host: str = "127.0.0.1") -> Dict[str, float]:
    """``run_workload`` over TCP: each closed-loop client is its own
    ``PGClient`` CONNECTION (its own session), so the server's batching
    window is fed by genuinely independent sockets."""
    from repro_torch.service import PGClient

    def make_session():
        c = PGClient(host, port=port)
        return c.query, c.close

    return _run_closed_loop(make_session, workload, concurrency,
                            repeats=repeats)


def _assert_wire_result_matches(got, ref, context) -> None:
    assert (_np(got.vertex_mask) == _np(ref.vertex_mask)).all(), context
    assert (_np(got.edge_mask) == _np(ref.edge_mask)).all(), context
    rb = ref.bindings()
    gb = got.bindings()
    assert sorted(gb) == sorted(rb), context
    for k in rb:
        assert (_np(gb[k]) == _np(rb[k])).all(), (context, k)


def _assert_blocks_equal(got, ref, context) -> None:
    """Sampled block lists match bitwise — field by field, layer by layer
    (works across ``SampledBlock`` and ``WireSampledBlock``)."""
    assert len(got) == len(ref), (context, len(got), len(ref))
    for li, (bg, br) in enumerate(zip(got, ref)):
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst",
                  "edge_mask"):
            a, b = _np(getattr(bg, f)), _np(getattr(br, f))
            assert a.shape == b.shape and (a == b).all(), (context, li, f)


def _packed_parity_block(m: int, seed: int, device=None) -> None:
    """Packed ≡ byte mask-plane gate (docs/ARCHITECTURE.md §14): the same
    tenant graph built with the bit-packed plane and with the
    ``REPRO_PG_BYTE_MASKS`` byte fallback answers match / khop /
    components / overlay views bitwise-identically — per backend, and on
    ``smoke_mesh(device)`` (word-axis shards and the packed OR all-reduce
    frontier against byte shards and the max all-reduce)."""
    from repro_torch.core import bitplane

    pool = pattern_pool()

    def surfaces(pg):
        out = []
        for pattern in pool[:3]:
            res = pg.match(pattern)
            out += [res.vertex_mask, res.edge_mask]
        nodes = _np(pg.graph.node_map)
        out.append(pg.khop(nodes[:4], 2, pattern="(a)-[:follows]->(b)"))
        out.append(pg.components("(a)-[:follows|likes]->(b)"))
        # overlay views: snapshot pins pre-write answers; live sees deltas
        snap = pg.snapshot()
        live = pg.fork()
        live.insert_edges(nodes[:8], nodes[-8:])
        live.add_node_labels(nodes[:8], ["l1"] * 8)
        live.delete_vertices(nodes[9:11])
        out.append(snap.match(pool[0]).vertex_mask)
        out.append(live.match(pool[0]).vertex_mask)
        out.append(live.match(pool[0]).edge_mask)
        return [_np(x) for x in out]

    for mesh in (None, smoke_mesh(device)):
        where = {"device": device} if mesh is None else {"mesh": mesh}
        for backend in ("arr", "list", "listd") if mesh is None else ("arr",):
            got = {}
            for packed in (True, False):
                with bitplane.byte_masks(not packed):
                    got[packed] = surfaces(build_tenant_graph(backend, m, seed=seed, **where))
            for i, (a, b) in enumerate(zip(got[True], got[False])):
                assert np.array_equal(a, b), (backend, mesh, i)
        kind = "single-device" if mesh is None else f"mesh P={mesh.size}"
        print(f"pgserve smoke: packed ≡ byte mask plane ({kind}) OK", flush=True)


def net_smoke(m: int = 600, seed: int = 0, tmp_dir: Optional[str] = None,
              device=None) -> None:
    """CI gate for the network path: one server SUBPROCESS serving all
    three backends; a client in THIS process verifies every pool pattern
    bitwise against an in-process ``PropGraph.match`` reference (the
    tenant build is seeded, so both processes construct identical graphs),
    then exercises pipelining, the semiring analytics verbs (weighted
    shortest paths / PageRank / communities), a variable-length traversal
    query (plus the plan-time string-predicate rejection), wire mutation +
    invalidation,
    the save→``load_graph`` path (cross-backend), error isolation, and
    graceful drain/shutdown.  Both processes run on ``device`` (None: the
    CUDA card).  Prints ``PGSERVE NET SMOKE OK``."""
    import tempfile

    import torch

    from repro_torch.core.io import save_propgraph
    from repro_torch.service import PGClient

    device = torch.device("cuda") if device is None else torch.device(device)
    backends = ("arr", "list", "listd")
    pool = pattern_pool()
    refs = {b: build_tenant_graph(b, m, seed=seed, device=device) for b in backends}
    proc, port = spawn_server(["--backends", ",".join(backends),
                               "--m", str(m), "--seed", str(seed),
                               "--device", device.type])
    try:
        with PGClient(port=port) as c:
            ping = c.ping()
            assert ping, "server did not answer ping"
            assert sorted(c.graphs()) == sorted(backends)
            # blocking queries: every backend, every pattern, bitwise
            for b in backends:
                for pattern in pool:
                    _assert_wire_result_matches(
                        c.query(b, pattern), refs[b].match(pattern), (b, pattern))
                print(f"pgserve net smoke: backend={b} ≡ in-process match OK",
                      flush=True)
            # pipelined burst: one pressure wave, still exact (dups included)
            burst = pool + pool[:4]
            got = c.query_batch("arr", burst)
            for pattern, res in zip(burst, got):
                _assert_wire_result_matches(res, refs["arr"].match(pattern),
                                            ("pipelined", pattern))
            # semiring analytics over the wire (§12): weighted shortest
            # paths and communities bitwise vs the in-process reference,
            # PageRank within float tolerance
            for b in backends:
                seeds = _np(refs[b].graph.node_map)[:4]
                spat = "(a)-[:follows]->(b)"
                assert np.array_equal(
                    c.shortest_paths(b, seeds, weight="w", pattern=spat),
                    _np(refs[b].shortest_paths(
                        seeds, weight="w", pattern=spat))), ("sp", b)
                assert np.allclose(
                    c.pagerank(b, weight="w"),
                    _np(refs[b].pagerank(weight="w")),
                    atol=1e-6), ("pagerank", b)
                assert np.array_equal(
                    c.communities(b),
                    _np(refs[b].communities())), ("communities", b)
            print("pgserve net smoke: weighted analytics ≡ in-process OK",
                  flush=True)
            # fused sampling over the wire (§15): deterministic-mode blocks
            # are bitwise the in-process ``PropGraph.sample`` ones on every
            # backend — explicit seeds, pattern seeds with an edge filter,
            # and a pipelined burst the server coalesces into one launch
            # per (graph, fanouts, bucket) group
            for b in backends:
                nb = _np(refs[b].graph.node_map)
                _assert_blocks_equal(
                    c.sample(b, nb[:48], [4, 3], seed=7),
                    refs[b].sample(nb[:48], [4, 3], seed=7),
                    ("net sample", b))
            nb = _np(refs["arr"].graph.node_map)
            _assert_blocks_equal(
                c.sample("arr", "(a:l0)", [4],
                         pattern="(a)-[:follows]->(b)", seed=3),
                refs["arr"].sample("(a:l0)", [4],
                                   pattern="(a)-[:follows]->(b)", seed=3),
                "net pattern sample")
            shs = [c.submit_sample("arr", nb[8 * i:8 * i + 24], [3], seed=i)
                   for i in range(6)]
            for i, h in enumerate(shs):
                _assert_blocks_equal(
                    h.result(),
                    refs["arr"].sample(nb[8 * i:8 * i + 24], [3], seed=i),
                    ("net pipelined sample", i))
            print("pgserve net smoke: fused sampling ≡ in-process OK",
                  flush=True)
            # explain crosses the wire as text
            assert "plan" in c.explain("arr", pool[0]).lower()
            # variable-length traversal over the wire: frontier-engine
            # propagation server-side, masks bitwise vs in-process match
            vpat = "(a:l1)-[:follows*1..4]->(b:l2)"
            for b in backends:
                _assert_wire_result_matches(
                    c.query(b, vpat), refs[b].match(vpat), ("varlen", b))
            assert "traverse" in c.explain("arr", vpat)
            print("pgserve net smoke: variable-length query ≡ in-process OK",
                  flush=True)
            # plan-time rejection reaches the client BEFORE any execution:
            # a string predicate fails with TypeError naming the column
            try:
                c.query("arr", '(a {age == "old"})-[:follows]->(b)')
            except TypeError as e:
                assert "age" in str(e)
            else:
                raise AssertionError("string predicate should raise TypeError")
            # mutation over the wire: version bump + cache invalidation,
            # mirrored locally on the reference graph
            nodes = _np(refs["arr"].graph.node_map)
            v = c.add_node_labels("arr", nodes[:7], ["l1"] * 7)
            assert v == refs["arr"].add_node_labels(nodes[:7], ["l1"] * 7).version
            _assert_wire_result_matches(c.query("arr", pool[0]),
                                        refs["arr"].match(pool[0]),
                                        ("post-mutation", pool[0]))
            # overlay over the wire: snapshot pins the pre-write state, the
            # fork branches privately, compact folds the overlay back in —
            # every step bitwise vs the mirrored in-process graph
            snap = c.snapshot("arr")
            snap_ref = {p: refs["arr"].match(p) for p in pool[:2]}
            v = c.insert_edges("arr", nodes[:12], nodes[-12:])
            refs["arr"].insert_edges(nodes[:12], nodes[-12:])
            assert v == refs["arr"].version
            c.add_node_labels("arr", nodes[:5], ["l2"] * 5)
            refs["arr"].add_node_labels(nodes[:5], ["l2"] * 5)
            for p in pool[:2]:
                _assert_wire_result_matches(c.query(snap, p), snap_ref[p],
                                            ("snapshot", p))
                _assert_wire_result_matches(c.query("arr", p),
                                            refs["arr"].match(p),
                                            ("overlay-live", p))
            fork = c.fork_view("arr")
            c.delete_vertices(fork, nodes[:1])
            fref = refs["arr"].fork()
            fref.delete_vertices(nodes[:1])
            _assert_wire_result_matches(c.query(fork, pool[0]),
                                        fref.match(pool[0]), "fork")
            _assert_wire_result_matches(c.query("arr", pool[0]),
                                        refs["arr"].match(pool[0]),
                                        "fork-parent")
            ov = c.compact("arr")
            assert ov["delta_edges"] > 0, ov
            refs["arr"].compact()
            _assert_wire_result_matches(c.query("arr", pool[0]),
                                        refs["arr"].match(pool[0]),
                                        "post-compact")
            c.drop_view(fork)
            c.drop_view(snap)
            remaining = c.graphs()
            assert fork not in remaining and snap not in remaining
            print("pgserve net smoke: overlay snapshot/fork/compact ≡ "
                  "in-process OK", flush=True)
            # save here → load_graph there (cross-backend reopen via wire)
            with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
                path = save_propgraph(os.path.join(td, "pg"), refs["arr"])
                info = c.load_graph("disk", path, backend="listd")
                assert info["backend"] == "listd"
                _assert_wire_result_matches(c.query("disk", pool[1]),
                                            refs["arr"].match(pool[1]),
                                            "load_graph")
                # reopen the same save onto the server's entity mesh (every
                # card; one CPU device for a CPU server): the sharded path,
                # driven cross-process, must stay bitwise too
                devices = c.server_info().get("devices", 1)
                c.load_graph("sharded", path, backend="arr", mesh=True)
                for pattern in pool[:4]:
                    _assert_wire_result_matches(c.query("sharded", pattern),
                                                refs["arr"].match(pattern), ("sharded", pattern))
                # weighted analytics on the reopen: the min all-reduce is
                # exact, PageRank's sum agrees within atol
                seeds = _np(refs["arr"].graph.node_map)[:4]
                assert np.array_equal(c.shortest_paths("sharded", seeds, weight="w"),
                                      _np(refs["arr"].shortest_paths(seeds, weight="w"))), \
                    "sharded sp"
                assert np.allclose(c.pagerank("sharded"), _np(refs["arr"].pagerank()),
                                   atol=1e-5), "sharded pagerank"
                # fused sampling on the reopen runs on the lead device:
                # its blocks are bitwise the unsharded graph's
                _assert_blocks_equal(c.sample("sharded", seeds.astype(np.int64), [4], seed=5),
                                     refs["arr"].sample(seeds, [4], seed=5), "sharded sample")
                print(f"pgserve net smoke: sharded P={devices} ≡ single-device OK", flush=True)
            # a bad request fails alone, with the real exception type
            try:
                c.query("arr", "(a {nosuchprop > 1})-[:follows]->(b)")
            except KeyError as e:
                assert "nosuchprop" in str(e)
            else:
                raise AssertionError("bad property should raise KeyError")
            assert c.ping()  # session survived the failed request
            # metrics verb (§13): the Prometheus exposition parses, counters
            # are monotonic across a pipelined burst, the totals agree with
            # the stats verb, and the span tree round-trips the client's
            # trace id
            from repro_torch.obs import parse_prometheus

            m1 = parse_prometheus(c.metrics())
            hs = [c.submit("arr", p) for p in pool[:8]]
            for h in hs:
                h.result()
            assert hs[0].trace is not None, "trace header missing"
            assert hs[0].trace["trace_id"] == hs[0].trace_id
            m2 = parse_prometheus(c.metrics())
            assert (m2["pg_service_submitted_total"]
                    == m1["pg_service_submitted_total"] + len(hs))
            totals = [k for k in m1 if k.endswith("_total")]
            assert totals and all(m2.get(k, 0.0) >= m1[k] for k in totals), \
                "counters went backwards"
            stats = c.stats()
            assert m2["pg_service_submitted_total"] == stats["submitted"]
            assert m2["pg_service_completed_total"] == stats["completed"]
            print("pgserve net smoke: metrics verb + trace round-trip OK",
                  flush=True)
            assert stats.get("completed", 0) > 0
            c.drain()
            c.shutdown()
        assert proc.wait(timeout=60) == 0, "server exit code"
    finally:
        if proc.poll() is None:
            proc.kill()
    _packed_parity_block(m, seed, device)
    print("PGSERVE NET SMOKE OK")


def _verify_bitwise(service, graphs: Dict[str, object],
                    pool: Sequence[str]) -> None:
    """Service answers ≡ direct ``match()`` for every (graph, pattern)."""
    for name, pg in graphs.items():
        for pattern in pool:
            ref = pg.match(pattern)
            got = service.query(name, pattern)
            assert (_np(got.vertex_mask) == _np(ref.vertex_mask)).all(), \
                (name, pattern)
            assert (_np(got.edge_mask) == _np(ref.edge_mask)).all(), \
                (name, pattern)


def smoke(m: int = 600, requests: int = 24, concurrency: int = 4,
          seed: int = 0, device=None) -> None:
    """Smoke gate on ``device`` (None: the CUDA card): service ≡ direct
    match on all three backends, invalidation works, the arr path actually
    coalesced, and a graph on ``smoke_mesh(device)`` answers as the
    single-device one.  Prints ``PGSERVE SMOKE OK``."""
    import torch

    from repro_torch.service import Service

    pool = pattern_pool()
    for backend in ("arr", "list", "listd"):
        pg = build_tenant_graph(backend, m, seed=seed, device=device)
        with Service() as svc:
            svc.add_graph("g", pg)
            wl = synthetic_workload(["g"], pool, requests, seed=seed)
            run_workload(svc, wl, concurrency)
            _verify_bitwise(svc, {"g": pg}, pool)
            # semiring analytics through the service (§12): weighted
            # traversal (tropical), PageRank (counting) and communities
            # (mode) match the direct PropGraph calls; the repeat probe is
            # a result-cache hit returning the identical array
            seeds = _np(pg.graph.node_map)[:4]
            spat = "(a)-[:follows]->(b)"
            sp = svc.shortest_paths("g", seeds, weight="w", pattern=spat)
            assert np.array_equal(sp, _np(pg.shortest_paths(
                seeds, weight="w", pattern=spat))), backend
            assert np.isfinite(sp).any(), backend
            pr = svc.pagerank("g", weight="w")
            pr_ref = _np(pg.pagerank(weight="w"))
            # bitwise on the CPU; on the card index_add_ sums in no fixed order
            assert (np.array_equal(pr, pr_ref) if pg.device.type == "cpu"
                    else np.allclose(pr, pr_ref, rtol=0, atol=1e-6)), backend
            assert abs(float(np.sum(pr)) - 1.0) < 1e-3, backend
            cm = svc.communities("g")
            assert np.array_equal(cm, _np(pg.communities())), backend
            hits0 = svc.stats().get("result_hits", 0)
            assert np.array_equal(sp, svc.shortest_paths(
                "g", seeds, weight="w", pattern=spat)), backend
            assert svc.stats().get("result_hits", 0) > hits0, backend
            # variable-length traversal through the service (per-request
            # fallback in the coalescer, result cache still serves it)
            vpat = "(a:l1)-[:follows*1..3]->(b:l2)"
            got = svc.query("g", vpat)
            ref = pg.match(vpat)
            assert (_np(got.edge_mask) == _np(ref.edge_mask)).all(), backend
            assert svc.stats().get("traversal_fallback_requests", 0) > 0, backend
            # mutation → version bump → cached results die
            before = svc.query("g", pool[0])
            nodes = _np(pg.graph.node_map)
            pg.add_node_labels(nodes[:5], ["l1"] * 5)
            after = svc.query("g", pool[0])
            ref = pg.match(pool[0])
            assert (_np(after.vertex_mask) == _np(ref.vertex_mask)).all()
            stats = svc.stats()
            assert stats.get("invalidated_results", 0) > 0, backend
            if backend == "arr":
                assert stats.get("coalesced_launches", 0) > 0, stats
            else:
                assert stats.get("fallback_requests", 0) > 0, stats
        print(f"pgserve smoke: backend={backend} OK "
              f"(coalesced_launches={stats.get('coalesced_launches', 0)}, "
              f"result_hits={stats.get('result_hits', 0)})")

    # overlay: snapshot isolation, fork what-if and compaction through the
    # service verbs (docs/ARCHITECTURE.md §11)
    pg = build_tenant_graph("arr", m, seed=seed, device=device)
    ref = build_tenant_graph("arr", m, seed=seed, device=device)  # stays at the pinned state
    with Service() as svc:
        svc.add_graph("g", pg)
        snap = svc.snapshot_graph("g")
        nodes = _np(pg.graph.node_map)
        pg.insert_edges(nodes[:16], nodes[-16:])  # delta, behind the snapshot
        pg.add_node_labels(nodes[:8], ["l1"] * 8)
        assert pg.delta_stats()["delta_edges"] > 0
        for pattern in pool[:3]:
            got = svc.query(snap, pattern)  # pinned: pre-write answers
            refr = ref.match(pattern)
            assert (_np(got.vertex_mask) == _np(refr.vertex_mask)).all(), pattern
            assert (_np(got.edge_mask) == _np(refr.edge_mask)).all(), pattern
            live = svc.query("g", pattern)  # live: overlay applied
            liver = pg.match(pattern)
            assert (_np(live.edge_mask) == _np(liver.edge_mask)).all(), pattern
        # fork: a private delete; the parent keeps serving unchanged
        fork = svc.fork_graph("g")
        fpg = svc.registry.get(fork)
        fpg.delete_vertices(nodes[:1])
        fgot = svc.query(fork, pool[0])
        assert (_np(fgot.vertex_mask)
                == _np(fpg.match(pool[0]).vertex_mask)).all()
        pgot = svc.query("g", pool[0])
        assert (_np(pgot.vertex_mask)
                == _np(pg.match(pool[0]).vertex_mask)).all()
        # compact folds the overlay in; live answers and the snapshot's
        # pinned answers both survive it
        svc.compact_graph("g")
        assert not pg.has_overlay()
        post = svc.query("g", pool[1])
        assert (_np(post.edge_mask)
                == _np(pg.match(pool[1]).edge_mask)).all()
        sgot = svc.query(snap, pool[0])
        assert (_np(sgot.vertex_mask)
                == _np(ref.match(pool[0]).vertex_mask)).all()
        svc.drop_graph(fork)
        svc.drop_graph(snap)
    print("pgserve smoke: overlay snapshot/fork/compact OK")

    # fused neighborhood sampling through the service (§15): deterministic
    # requests are bitwise the direct ``PropGraph.sample`` blocks —
    # explicit and pattern seeds, filtered and unfiltered, multi-layer;
    # a coalesced burst launches once per (graph, fanouts, bucket) group
    # with every row still bitwise its solo run; deterministic repeats hit
    # the result cache
    pg = build_tenant_graph("arr", m, seed=seed, device=device)
    with Service() as svc:
        svc.add_graph("g", pg)
        nodes = _np(pg.graph.node_map)
        for fanouts, filt in (([4, 3], None),
                              ([5], "(a)-[:follows]->(b)")):
            _assert_blocks_equal(
                svc.sample("g", nodes[:48], fanouts, pattern=filt, seed=7),
                pg.sample(nodes[:48], fanouts, pattern=filt, seed=7),
                ("sample", fanouts, filt))
        _assert_blocks_equal(
            svc.sample("g", "(a:l0)", [4], pattern="(a)-[:likes]->(b)",
                       seed=3),
            pg.sample("(a:l0)", [4], pattern="(a)-[:likes]->(b)", seed=3),
            "pattern-seed sample")
        specs = [(nodes[8 * i:8 * i + 32], i) for i in range(8)]
        launches0 = svc.stats().get("sample_coalesced_launches", 0)
        batch = svc.sample_batch("g", specs, [3])
        assert svc.stats().get("sample_coalesced_launches", 0) == launches0 + 1
        for (s, sv), bl in zip(specs, batch):
            _assert_blocks_equal(bl, pg.sample(s, [3], seed=sv),
                                 ("coalesced sample", sv))
        hits0 = svc.stats().get("result_hits", 0)
        svc.sample("g", nodes[:48], [4, 3], seed=7)
        assert svc.stats().get("result_hits", 0) > hits0, "sample cache miss"
    print("pgserve smoke: fused sampling ≡ in-process OK")

    # observability (§13): EXPLAIN ANALYZE splits compile from steady-state,
    # the metrics exposition parses and agrees with stats(), counters are
    # monotonic across a second burst, the trace ring holds full span trees,
    # and the disabled path still answers queries bitwise-identically
    from repro_torch.obs import parse_prometheus, set_enabled

    pg = build_tenant_graph("arr", m, seed=seed, device=device)
    with Service() as svc:
        svc.add_graph("g", pg)
        on_card = pg.device.type == "cuda"
        if on_card:  # the first report is cold by construction: new allocator blocks
            torch.cuda.empty_cache()
        rep = pg.explain_analyze(pool[0])
        warm = [pg.explain_analyze(pool[0]) for _ in range(3)]  # the first call's costs paid
        for r in (rep, *warm):
            assert r.total_first_ms >= r.steady_ms >= 0
        if on_card:
            # only a cold first report has a one-off share to compare; on
            # the CPU nothing is paid once and every reading is jitter.  A
            # warm report pays no more one-off cost than the cold one: one
            # warm host reading can be jitter above the noise floor, so the
            # least of three stands for the warm report
            assert min(r.compile_ms for r in warm) <= rep.compile_ms
        wl = synthetic_workload(["g"], pool, requests, seed=seed + 1)
        run_workload(svc, wl, concurrency)
        m1 = parse_prometheus(svc.metrics_text())
        st = svc.stats()
        assert m1["pg_service_submitted_total"] == st["submitted"]
        assert m1["pg_service_completed_total"] == st["completed"]
        run_workload(svc, wl, concurrency)
        m2 = parse_prometheus(svc.metrics_text())
        assert (m2["pg_service_submitted_total"]
                == m1["pg_service_submitted_total"] + len(wl))
        totals = [k for k in m1 if k.endswith("_total")]
        assert totals and all(m2.get(k, 0.0) >= m1[k] for k in totals), \
            "counters went backwards"
        tl = svc.trace_log()
        assert tl, "trace ring empty"
        names = {s["name"] for t in tl for s in t.get("spans", [])}
        assert "execute" in names or "cache" in names, names
        prev = set_enabled(False)
        try:
            before = svc.stats().get("submitted", 0)
            got = svc.query("g", pool[1])
            ref = pg.match(pool[1])
            assert (_np(got.edge_mask)
                    == _np(ref.edge_mask)).all()
            assert svc.stats().get("submitted", 0) == before, \
                "disabled metrics still counted"
        finally:
            set_enabled(prev)
    print("pgserve smoke: observability (metrics/traces/explain_analyze) OK")

    # the same tenant on an entity mesh: its stores sharded, every answer
    # the single-device graph's; no dense copy of a store is kept
    mesh = smoke_mesh(device)
    pg1 = build_tenant_graph("arr", m, seed=seed, device=device)
    pg2 = build_tenant_graph("arr", m, mesh=mesh, seed=seed)
    with Service() as svc:
        svc.add_graph("sharded", pg2)
        for pattern in pool[:4]:
            got = svc.query_batch("sharded", [pattern])[0]
            assert (_np(got.edge_mask) == _np(pg1.match(pattern).edge_mask)).all(), pattern
        # weighted analytics on the mesh: the min all-reduce is exact
        # (bitwise), PageRank's sum reassociates (atol)
        seeds = _np(pg1.graph.node_map)[:4]
        assert np.array_equal(svc.shortest_paths("sharded", seeds, weight="w"),
                              _np(pg1.shortest_paths(seeds, weight="w")))
        assert np.allclose(svc.pagerank("sharded", weight="w"), _np(pg1.pagerank(weight="w")),
                           atol=1e-5)
        # sampling runs on the lead device: blocks bitwise the unsharded graph's
        nodes = _np(pg1.graph.node_map)
        _assert_blocks_equal(
            svc.sample("sharded", nodes[:32], [4], pattern="(a)-[:follows]->(b)", seed=5),
            pg1.sample(nodes[:32], [4], pattern="(a)-[:follows]->(b)", seed=5), "mesh sample")
    for store in (pg2._vstore, pg2._estore):
        assert store._store is None and store._host is None and store._sharded is not None
    print(f"pgserve smoke: mesh P={mesh.size} ≡ single-device OK", flush=True)
    _packed_parity_block(m, seed, device)
    print("PGSERVE SMOKE OK")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast correctness pass; exits non-zero on failure")
    ap.add_argument("--serve", action="store_true",
                    help="run as a foreground pgd server process")
    ap.add_argument("--net", action="store_true",
                    help="cross-process mode: spawn a server, drive it over TCP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="--serve bind port (0 = OS-assigned, printed on stdout)")
    ap.add_argument("--backends", default=None,
                    help="--serve: comma list; one graph per backend, named after it")
    ap.add_argument("--warm", action="store_true",
                    help="--serve: warm the serving path before LISTENING")
    ap.add_argument("--graphs", type=int, default=2, help="tenant graph count")
    ap.add_argument("--backend", default="arr", choices=("arr", "list", "listd"))
    ap.add_argument("--m", type=int, default=20_000, help="edges per tenant graph")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--mesh", action="store_true",
                    help="place tenant graphs on an entity mesh (every card, or the CPU)")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the Prometheus exposition after the workload "
                         "(fetched over the wire in --net mode)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the graphs live and the service runs (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.serve:
        serve(port=args.port, host=args.host, backend=args.backend,
              backends=args.backends.split(",") if args.backends else None,
              graphs=args.graphs, m=args.m, seed=args.seed, mesh=args.mesh,
              warm=args.warm, device=args.device)
        return
    if args.net and args.smoke:
        net_smoke(seed=args.seed, device=args.device)
        return
    if args.net:
        proc, port = spawn_server(["--host", args.host,
                                   "--graphs", str(args.graphs),
                                   "--backend", args.backend,
                                   "--m", str(args.m),
                                   "--seed", str(args.seed), "--warm",
                                   "--device", args.device,
                                   *(["--mesh"] if args.mesh else [])])
        try:
            names = [f"tenant{i}" for i in range(args.graphs)]
            wl = synthetic_workload(names, pattern_pool(), args.requests,
                                    seed=args.seed)
            met = run_workload_net(port, wl, args.concurrency, host=args.host)
            print(f"net service (c={args.concurrency}): {met['qps']:.1f} qps, "
                  f"p50={met['p50_ms']:.2f}ms p95={met['p95_ms']:.2f}ms")
            from repro_torch.service import PGClient

            with PGClient(args.host, port=port) as c:
                print(f"stats: {c.stats()}")
                if args.metrics:
                    print(c.metrics(), end="")
                c.shutdown()
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
        return
    if args.smoke:
        smoke(seed=args.seed, device=args.device)
        return

    from repro_torch.service import Service

    where = {"mesh": cli_mesh(args.device)} if args.mesh else {"device": args.device}
    graphs = {
        f"tenant{i}": build_tenant_graph(args.backend, args.m, seed=args.seed + i, **where)
        for i in range(args.graphs)
    }
    pool = pattern_pool()
    wl = synthetic_workload(sorted(graphs), pool, args.requests, seed=args.seed)

    for pg in graphs.values():  # steady-state numbers, not first-call costs
        warm_serving_path(pg, pool)
    seq = run_sequential(graphs, wl)
    print(f"sequential baseline: {seq['qps']:.1f} qps ({seq['wall_s']:.2f}s)")

    with Service() as svc:
        for name, pg in graphs.items():
            svc.add_graph(name, pg)
        metrics = run_workload(svc, wl, args.concurrency)
        stats = svc.stats()
        exposition = svc.metrics_text() if args.metrics else None
    print(f"service (c={args.concurrency}): {metrics['qps']:.1f} qps, "
          f"p50={metrics['p50_ms']:.2f}ms p95={metrics['p95_ms']:.2f}ms, "
          f"speedup ×{metrics['qps'] / seq['qps']:.2f}")
    print(f"stats: {stats}")
    if exposition is not None:
        print(exposition, end="")


if __name__ == "__main__":
    main()
