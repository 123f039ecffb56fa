"""The overlay and the service on an entity mesh, against the reference on one device.

The counterparts of ``tests/test_overlay_concurrency.py``'s eight-device
snapshot race, ``tests/test_service.py``'s mesh checks
(``test_service_on_mesh_equals_single_device``,
``test_mesh_mode_never_caches_dense_store``) and ``net_smoke``'s sharded
reopen over the wire — in process, on meshes of CPU shards.
"""
import threading
import time

import numpy as np
import pytest

from _torch_parity import (
    OV_PATTERNS,
    SERVE_PATTERNS,
    as_np,
    assert_same_blocks,
    assert_same_match,
    assert_same_overlay,
    fixed_shape_edges,
    overlay_stream,
)
from repro.core import PropGraph as RefPG
from repro.core.io import save_propgraph as ref_save
from repro.graph import random_uniform_graph
from repro.launch import pgserve as ref_pgserve
from repro_torch.core import PropGraph
from repro_torch.kernels.bitmap_query import ops
from repro_torch.launch import pgserve
from repro_torch.launch.mesh import make_entity_mesh
from repro_torch.service import GraphRegistry, PGClient, PGServer, Service
from repro_torch.service.scheduler import execute_coalesced

BACKENDS = ("arr", "list", "listd")
TIMEOUT = 60.0


def cpu_mesh(p: int):
    return make_entity_mesh(devices=["cpu"] * p)


def _eq(a, b) -> bool:
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and bool((a == b).all())


# ------------------------------------------------------------------ the overlay
def overlay_mesh_pair(seed: int, backend: str, p: int, n: int = 40, m: int = 160):
    """``_torch_parity.overlay_pair``'s graph — the reference on one
    device, the port on a P-shard mesh — both stores sealed."""
    rng = np.random.default_rng(seed + 2000)
    src, dst = fixed_shape_edges(seed, n, m)
    ref = RefPG(backend=backend).add_edges_from(src, dst)
    port = PropGraph(backend=backend, mesh=cpu_mesh(p)).add_edges_from(src, dst)
    nodes = np.asarray(ref.graph.node_map)
    es, ed = np.asarray(ref.graph.src), np.asarray(ref.graph.dst)
    lab = rng.choice(["l1", "l2", "l3"], size=len(nodes))
    rel = rng.choice(["follows", "likes"], size=len(es), p=[0.7, 0.3])
    age = rng.integers(0, 60, len(nodes))
    w = rng.random(len(es))
    for pg in (ref, port):
        pg.add_node_labels(nodes, lab)
        pg.add_edge_relationships(nodes[es], nodes[ed], rel)
        pg.add_node_properties("age", nodes, age)
        pg.add_edge_properties("w", nodes[es], nodes[ed], w)
        pg.match(OV_PATTERNS[0][1])  # seal both stores
    meta = {"nodes": nodes, "src": nodes[es], "dst": nodes[ed], "labels": lab, "rels": rel}
    return ref, port, meta


@pytest.mark.parametrize("backend,p", [("arr", p) for p in (1, 2, 3, 4, 6, 8)]
                         + [(b, p) for b in ("list", "listd") for p in (3, 8)])
def test_overlay_on_a_mesh_equals_reference(backend, p):
    """A seeded stream of every write kind: after it, on the snapshot taken
    mid-stream, on the fork and after compaction, every request kind, count
    and overlay stat equals the reference's; compaction re-shards the
    stores, and the parent's views still share the placed shards."""
    ref, port, meta = overlay_mesh_pair(1, backend, p)
    snaps = None
    for op in overlay_stream(1, meta):
        if op[0] == "snapshot":
            snaps = (ref.snapshot(), port.snapshot())
            assert snaps[1]._vstore._sharded is port._vstore._sharded  # zero-copy
        elif op[0] == "fork":
            ref, port = ref.fork(), port.fork()
            assert port.mesh is snaps[1].mesh
        else:
            getattr(ref, op[0])(*op[1])
            getattr(port, op[0])(*op[1])
    assert_same_overlay(ref, port)
    assert_same_overlay(*snaps)
    seeds = meta["nodes"][:3]
    assert _eq(port.khop(seeds, 3), ref.khop(seeds, 3))
    assert _eq(port.shortest_paths(seeds), ref.shortest_paths(seeds))
    for pg in (ref, port):
        pg.compact()
    assert port._vstore.mesh is port.mesh and port._vstore._sharded is None
    assert_same_overlay(ref, port)
    assert port._vstore._sharded is not None and port._vstore._store is None
    assert_same_overlay(*snaps)  # the snapshot answers as before the compaction


def test_snapshot_isolation_under_writes_on_a_mesh():
    """``tests/test_overlay_concurrency.py``'s P = 8 race: snapshot reads stay
    pinned while a writer streams delta batches into the mesh parent, and
    the parent ends at the reference's single-device delta-path answer."""
    pattern, comp = "(a:l1|l2)-[:follows]->(b:l3)", "(a)-[:follows]->(b)"
    rng = np.random.default_rng(19)
    src, dst = random_uniform_graph(800, seed=19)
    pg = PropGraph(backend="arr", mesh=cpu_mesh(8)).add_edges_from(src, dst)
    nodes = as_np(pg.graph.node_map)
    labels = rng.choice(["l1", "l2", "l3"], size=len(nodes))
    es, ed = as_np(pg.graph.src), as_np(pg.graph.dst)
    rels = rng.choice(["follows", "likes"], size=len(es))
    pg.add_node_labels(nodes, labels)
    pg.add_edge_relationships(nodes[es], nodes[ed], rels)
    pg.match(pattern)  # seal the sharded stores
    snap = pg.snapshot()
    want_comp, want_match = snap.components(comp), snap.match(pattern).vertex_mask
    brng = np.random.default_rng(31)
    batches = [(brng.choice(nodes, 64), brng.choice(nodes, 64)) for _ in range(10)]
    stop, errors = threading.Event(), []

    def writer():
        try:
            for bs, bd in batches:
                pg.insert_edges(bs, bd)
                pg.add_edge_relationships(bs, bd, ["follows"] * 64)
                time.sleep(0.002)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=writer)
    t.start()
    reads = 0
    while (not stop.is_set() or reads < 3) and reads <= 500:
        assert _eq(snap.components(comp), want_comp), reads
        assert _eq(snap.match(pattern).vertex_mask, want_match), reads
        reads += 1
    t.join(timeout=60)
    assert not errors, errors
    assert pg.delta_stats()["delta_edges"] > 0
    ref = RefPG(backend="arr").add_edges_from(src, dst)
    ref.add_node_labels(nodes, labels)
    ref.add_edge_relationships(nodes[es], nodes[ed], rels)
    ref.match(pattern)  # seal: the same delta path
    for bs, bd in batches:
        ref.insert_edges(bs, bd)
        ref.add_edge_relationships(bs, bd, ["follows"] * 64)
    assert _eq(pg.components(comp), ref.components(comp))
    assert _eq(pg.match(pattern).vertex_mask, ref.match(pattern).vertex_mask)
    assert _eq(snap.components(comp), want_comp)  # still pinned


# ------------------------------------------------------------------ the service
@pytest.mark.parametrize("backend", BACKENDS)
def test_service_on_a_mesh_equals_the_reference(backend):
    """Coalesced groups on a mesh: arr's fused masks launch B1 once per
    shard at the group's bucketed Q; every answer equals the reference's
    single-device ``match``."""
    ref = ref_pgserve.build_tenant_graph(backend, 800, seed=3)
    pg = pgserve.build_tenant_graph(backend, 800, mesh=cpu_mesh(8), seed=3)
    with Service() as svc:
        svc.add_graph("g", pg)
        for res, p in zip(svc.query_batch("g", list(SERVE_PATTERNS)), SERVE_PATTERNS):
            assert_same_match(ref.match(p), res)
    from repro_torch.query import parse, plan_pattern

    stats = {}
    plans = [plan_pattern(pg, parse(p)) for p in SERVE_PATTERNS]
    for p, res in zip(SERVE_PATTERNS, execute_coalesced(pg, plans, stats=stats)):
        assert_same_match(ref.match(p), res)
    assert stats.get("coalesced_launches", 0) > 0 if backend == "arr" else \
        stats.get("fallback_requests", 0) == len(plans)


def test_mesh_mode_never_caches_dense_store():
    """Queries AND planner stats on a mesh graph leave no dense store
    anywhere: the host build is released once its shards are placed."""
    pg = pgserve.build_tenant_graph("arr", 800, mesh=cpu_mesh(8), seed=3)
    pg.match(SERVE_PATTERNS[0])  # planner stats + sharded query
    pg.label_counts()  # stats-only read
    for store in (pg._vstore, pg._estore):
        assert store._store is None
        assert store._host is None
        assert store._sharded is not None and len(store._sharded.bitmap) == 8
        assert store._counts is not None


def test_registry_and_service_load_onto_a_mesh(tmp_path):
    ref = ref_pgserve.build_tenant_graph("arr", 800, seed=4)
    path = ref_save(str(tmp_path / "g"), ref)
    reg = GraphRegistry()
    pg = reg.load("g", path, backend="list", mesh=cpu_mesh(4))
    assert pg.mesh.size == 4 and reg.get("g") is pg
    assert_same_match(ref.match(SERVE_PATTERNS[0]), pg.match(SERVE_PATTERNS[0]))
    with Service() as svc:
        svc.load_graph("s", path, mesh=cpu_mesh(6))
        for p in SERVE_PATTERNS:
            assert_same_match(ref.match(p), svc.query("s", p))
        assert svc.registry.get("s").mesh.size == 6


def test_wire_load_graph_onto_the_servers_mesh(tmp_path):
    """``load_graph(mesh=True)`` reopens a save onto the server's entity
    mesh — on a CPU server its one device, P = 1 — and the wire's answers
    (queries, analytics, samples) equal the reference's."""
    ref = ref_pgserve.build_tenant_graph("arr", 800, seed=3)
    path = ref_save(str(tmp_path / "g"), ref)
    with Service() as svc:
        server = PGServer(svc, port=0, device="cpu").start()
        try:
            with PGClient(port=server.port, timeout=TIMEOUT) as c:
                assert c.server_info()["devices"] == 1
                info = c.load_graph("sharded", path, backend="arr", mesh=True)
                assert (info["n"], info["m"]) == (ref.graph.n, ref.graph.m)
                assert svc.registry.get("sharded").mesh.size == 1
                for p in SERVE_PATTERNS:
                    got, want = c.query("sharded", p), ref.match(p)
                    assert _eq(got.vertex_mask, want.vertex_mask)
                    assert _eq(got.edge_mask, want.edge_mask)
                seeds = np.asarray(ref.graph.node_map)[:4]
                assert _eq(c.shortest_paths("sharded", seeds, weight="w"),
                           ref.shortest_paths(seeds, weight="w"))
                assert np.allclose(c.pagerank("sharded"), np.asarray(ref.pagerank()),
                                   rtol=0, atol=1e-6)
                port = pgserve.build_tenant_graph("arr", 800, seed=3, device="cpu")
                assert_same_blocks(c.sample("sharded", seeds.astype(np.int64), [4], seed=5),
                                   port.sample(seeds, [4], seed=5))
                c.shutdown()
        finally:
            server.close()


def test_pgserve_cli_mesh_and_smoke_mesh():
    """``--mesh`` spans the device's kind (the one CPU device here); the
    gates' mesh is 8 shards on a one-device machine."""
    assert pgserve.cli_mesh("cpu").size == 1
    mesh = pgserve.smoke_mesh("cpu")
    assert mesh.size == pgserve.SMOKE_SHARDS == 8 and set(mesh.devices) == {mesh.lead}
    ops.reset_launches()
    pg = pgserve.build_tenant_graph("arr", 600, mesh=mesh, seed=0)
    pg.match(SERVE_PATTERNS[0])
    assert ops.launches == {ops.PACKED: 0, ops.BYTE: 0}  # the CPU runs the plain versions
