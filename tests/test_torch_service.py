"""The port's analytics service (``repro_torch.service``: registry,
micro-batching scheduler, plan/result caches, coalesced sampling) — the
non-mesh contracts of ``tests/test_service.py``, the service parts of
``tests/test_overlay.py``, ``tests/test_overlay_concurrency.py`` and
``tests/test_sample.py``, on all three backends.

* Coalesced answers (``query_batch``, concurrent ``submit``) are bitwise
  each package's ``match`` and equal across the packages.
* Coalesced samples (``sample_batch``, ``submit_sample``) are bitwise the
  port's solo ``PropGraph.sample`` — including on graphs with delta edges
  and tombstoned vertices, where an unfiltered request's edge words are the
  alive edges.  (Sampling draws differ between the packages by design: the
  reference draws with threefry, the port with Philox.)
* Caches die exactly when a write can have changed their answer.

Graphs are ``pgserve.build_tenant_graph``'s tenants, the port's on the CPU.
Every future waits with a timeout, so a hang fails one test.
"""
import threading
import time

import numpy as np
import pytest

from _torch_parity import (
    SERVE_PATTERNS,
    as_np,
    assert_same_blocks,
    assert_same_match,
    service_pkg,
)
from repro_torch.core import PropGraph
from repro_torch.graph import random_uniform_graph
from repro_torch.launch.pgserve import build_tenant_graph
from repro_torch.service import GraphRegistry, LRUCache, Service, ServiceConfig
from repro_torch.service.scheduler import execute_coalesced

BACKENDS = ("arr", "list", "listd")
PATTERNS = SERVE_PATTERNS
PATTERN = PATTERNS[0]
TIMEOUT = 120


def _build(backend, m=800, seed=3):
    return build_tenant_graph(backend, m, seed=seed, device="cpu")


def _eq(a, b):
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and bool((a == b).all())


# ------------------------------------------------------------- equivalence
@pytest.mark.parametrize("backend", BACKENDS)
def test_coalesced_batch_equals_match_in_both_packages(backend):
    """query_batch (ONE coalesced group) ≡ per-request match, bitwise,
    duplicates and a variable-length hop included — in each package, and
    the port's answers equal the reference's."""
    patterns = list(PATTERNS) + [PATTERNS[0], "(a:l1)-[:follows*1..3]->(b:l2)", PATTERNS[2]]
    answers = {}
    for name in ("ref", "port"):
        pkg = service_pkg(name)
        pg = pkg.build(backend, 800, 3)
        with pkg.Service() as svc:
            svc.add_graph("g", pg)
            got = svc.query_batch("g", patterns)
            stats = svc.stats()
        for p, res in zip(patterns, got):
            assert_same_match(pg.match(p), res)
        if backend == "arr":
            assert stats["coalesced_launches"] > 0 and stats["coalesced_masks"] >= 4
        else:
            assert stats["fallback_requests"] > 0
        assert stats["dedup_hits"] == 2
        answers[name] = got
    for a, b in zip(answers["ref"], answers["port"]):
        assert_same_match(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_submit_equals_sequential_match(backend):
    pg = _build(backend)
    refs = {p: pg.match(p) for p in PATTERNS}
    with Service() as svc:
        svc.add_graph("g", pg)
        futs = []
        lock = threading.Lock()

        def client(p):
            f = svc.submit("g", p)
            with lock:
                futs.append((p, f))

        threads = [threading.Thread(target=client, args=(p,)) for p in PATTERNS for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert len(futs) == 3 * len(PATTERNS)
        for p, f in futs:
            assert_same_match(refs[p], f.result(timeout=TIMEOUT))


@pytest.mark.parametrize("n_plans", [1, 2, 3, 4, 40])
def test_execute_coalesced_bucket_padding_exact(n_plans):
    """Padding Q to a bucket with empty queries must not leak into results;
    40 plans of two node masks each take Q = 128 (past the top bucket, a
    multiple of 64).  Equal to ``execute_plan`` on the packed combine and
    to the reference's coalescer."""
    from repro.query import parse as ref_parse
    from repro.query import plan_pattern as ref_plan
    from repro.service.scheduler import execute_coalesced as ref_coalesced
    from repro_torch.kernels.bitmap_query import ops
    from repro_torch.query import execute_plan, parse, plan_pattern

    ref_pg = service_pkg("ref").build("arr", 800, 3)
    pg = _build("arr")
    texts = [PATTERNS[i % len(PATTERNS)] if n_plans < 40 else
             f"(a:l{i % 12}|l{(i + 5) % 12})-[:follows]->(b:l{(i + 3) % 12})"
             for i in range(n_plans)]
    plans = [plan_pattern(pg, parse(t)) for t in texts]
    stats = {}
    got = execute_coalesced(pg, plans, stats=stats)
    want = ref_coalesced(ref_pg, [ref_plan(ref_pg, ref_parse(t)) for t in texts])
    for p, res, r in zip(plans, got, want):
        assert_same_match(execute_plan(pg, p), res)
        assert_same_match(r, res)
    masks = sum(len(p.mask_steps) for p in plans)
    if masks >= 2:
        assert stats["coalesced_masks"] == masks
        assert stats["coalesced_launches"] in (1, 2)
    if n_plans == 40:
        assert ops.bucketed_q(sum(s.kind == "node" for p in plans for s in p.mask_steps)) == 128


# ------------------------------------------------------------ invalidation
def test_result_cache_invalidated_by_label_mutation():
    pg = _build("arr")
    with Service() as svc:
        svc.add_graph("g", pg)
        v0 = svc.registry.version("g")
        first = svc.query("g", PATTERN, timeout=TIMEOUT)
        assert svc.query("g", PATTERN, timeout=TIMEOUT) is first
        nodes = as_np(pg.graph.node_map)
        pg.add_node_labels(nodes[:9], ["l1"] * 9)
        assert svc.registry.version("g") == v0 + 1
        assert svc.stats()["invalidated_results"] >= 1
        assert len(svc.result_cache) == 0
        fresh = svc.query("g", PATTERN, timeout=TIMEOUT)
        assert_same_match(pg.match(PATTERN), fresh)
        assert not _eq(fresh.vertex_mask, first.vertex_mask)


def test_result_cache_invalidated_by_edge_rebuild():
    pg = _build("arr", m=400, seed=5)
    with Service() as svc:
        svc.add_graph("g", pg)
        svc.query("g", PATTERN, timeout=TIMEOUT)
        assert len(svc.result_cache) == 1
        src, dst = random_uniform_graph(500, seed=11)
        pg.add_edges_from(src, dst)
        assert len(svc.result_cache) == 0
        nodes = as_np(pg.graph.node_map)
        pg.add_node_labels(nodes, ["l1"] * len(nodes))
        pg.add_edge_relationships(nodes[as_np(pg.graph.src)], nodes[as_np(pg.graph.dst)],
                                  ["follows"] * pg.n_edges)
        text = "(a:l1)-[:follows]->(b:l1)"
        assert_same_match(pg.match(text), svc.query("g", text, timeout=TIMEOUT))


def test_version_counter_covers_every_mutator():
    pg = PropGraph(backend="arr", device="cpu")
    assert pg.version == 0
    src, dst = random_uniform_graph(200, seed=1)
    pg.add_edges_from(src, dst)
    nodes = as_np(pg.graph.node_map)
    pg.add_node_labels(nodes[:5], ["x"] * 5)
    pg.add_edge_relationships(src[:3], dst[:3], ["r"] * 3)
    pg.add_node_properties("p", nodes[:5], np.arange(5))
    pg.add_edge_properties("q", src[:3], dst[:3], np.arange(3))
    assert pg.version == 5


# -------------------------------------------------------------- accounting
def test_plan_cache_hit_accounting():
    pg = _build("arr")
    with Service(config=ServiceConfig(result_cache_size=0)) as svc:
        svc.add_graph("g", pg)
        svc.query("g", PATTERN, timeout=TIMEOUT)
        svc.query("g", " (a:l1|l2)-[:follows]->(b:l3) ", timeout=TIMEOUT)
        stats = svc.stats()
        assert stats["plan_misses"] == 1 and stats["plan_hits"] == 1
        pg.add_node_labels(as_np(pg.graph.node_map)[:3], ["l9"] * 3)
        svc.query("g", PATTERN, timeout=TIMEOUT)
        assert svc.stats()["plan_hits"] == 2


def test_bad_request_does_not_poison_cobatched_group():
    pg = _build("arr")
    with Service(config=ServiceConfig(window_ms=250.0)) as svc:
        svc.add_graph("g", pg)
        bad = svc.submit("g", "(a {nosuchprop > 1})-[:follows]->(b)")
        good = svc.submit("g", PATTERN)
        with pytest.raises(KeyError, match="nosuchprop"):
            bad.result(timeout=TIMEOUT)
        assert_same_match(pg.match(PATTERN), good.result(timeout=TIMEOUT))
    with Service() as svc:
        svc.add_graph("g", pg)
        good_c, good_ast = svc._canon(PATTERN)
        bad_c, bad_ast = svc._canon("(a {nosuchprop > 1})-[:follows]->(b)")
        out = svc._serve_group(pg, "g", None, {bad_c: bad_ast, good_c: good_ast})
        assert isinstance(out[bad_c], KeyError)
        assert_same_match(pg.match(PATTERN), out[good_c])


def test_result_cache_hit_and_fastpath_accounting():
    pg = _build("arr")
    with Service() as svc:
        svc.add_graph("g", pg)
        svc.query("g", PATTERN, timeout=TIMEOUT)
        svc.query("g", PATTERN, timeout=TIMEOUT)
        svc.query_batch("g", [PATTERN])
        stats = svc.stats()
    assert stats["result_hits"] == 2
    assert stats["fastpath_hits"] == 1
    assert stats["result_misses"] == 1


def test_closed_service_refuses_submits():
    pg = _build("arr", m=300)
    svc = Service()
    svc.add_graph("g", pg)
    svc.query("g", PATTERN, timeout=TIMEOUT)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("g", PATTERN)  # even a result-cache hit
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_sample("g", [1, 2], [2])


def test_lru_cache_eviction_and_disable():
    c = LRUCache(2)
    c.put("a", 1), c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.get("b") is None and c.get("c") == 3
    assert c.stats()["evictions"] == 1
    off = LRUCache(0)
    off.put("a", 1)
    assert off.get("a") is None and len(off) == 0
    with pytest.raises(ValueError):
        LRUCache(-1)


def test_lru_cache_put_on_existing_key_refreshes_recency():
    c = LRUCache(2)
    c.put("hot", 1)
    c.put("b", 2)
    c.put("hot", 10)
    c.put("c", 3)
    assert c.get("hot") == 10 and c.get("b") is None and c.get("c") == 3


# ---------------------------------------------------------------- registry
def test_registry_concurrent_subscribe_during_notify():
    pg = _build("arr", m=300, seed=9)
    reg = GraphRegistry()
    reg.register("g", pg)
    nodes = as_np(pg.graph.node_map)
    stop = threading.Event()
    errors = []

    def churn():
        try:
            while not stop.is_set():
                listeners = [lambda name, g: None for _ in range(4)]
                for ln in listeners:
                    reg.subscribe(ln)
                for ln in listeners:
                    reg.unsubscribe(ln)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def mutate():
        try:
            for i in range(60):
                pg.add_node_labels(nodes[:2], [f"l{i % 3}"] * 2)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    churners = [threading.Thread(target=churn) for _ in range(3)]
    mut = threading.Thread(target=mutate)
    for t in churners:
        t.start()
    mut.start()
    mut.join(timeout=TIMEOUT)
    stop.set()
    for t in churners:
        t.join(timeout=30)
    assert not errors
    survivor = []
    reg.subscribe(lambda name, g: survivor.append(name))
    pg.add_node_labels(nodes[:2], ["x"] * 2)
    assert survivor == ["g"]


def test_registry_load_and_errors(tmp_path):
    from repro_torch.core.io import save_propgraph

    pg = _build("arr", m=300, seed=9)
    path = save_propgraph(str(tmp_path / "pg"), pg)
    reg = GraphRegistry()
    reg.load("disk", path, backend="listd", device="cpu")
    assert "disk" in reg and reg.names() == ["disk"] and len(reg) == 1
    assert_same_match(pg.match(PATTERN), reg.get("disk").match(PATTERN))
    with pytest.raises(KeyError, match="unknown graph"):
        reg.get("nope")
    with Service(registry=reg) as svc:
        with pytest.raises(KeyError, match="unknown graph"):
            svc.submit("nope", PATTERN).result(timeout=60)
    assert reg._listeners == []


def test_registry_reregister_is_idempotent_and_silences_replaced_graph():
    pg1 = _build("arr", m=300, seed=9)
    pg2 = _build("arr", m=300, seed=10)
    reg = GraphRegistry()
    events = []
    reg.subscribe(lambda name, pg: events.append((name, pg)))
    reg.register("g", pg1)
    reg.register("g", pg1)
    events.clear()
    nodes = as_np(pg1.graph.node_map)
    pg1.add_node_labels(nodes[:2], ["x"] * 2)
    assert len(events) == 1
    reg.register("g", pg2)
    events.clear()
    pg1.add_node_labels(nodes[:2], ["y"] * 2)
    assert events == []
    pg2.add_node_labels(as_np(pg2.graph.node_map)[:2], ["z"] * 2)
    assert len(events) == 1


def test_label_counts_reads_cached_stats_without_device_store():
    pg = _build("list", m=300, seed=2)
    counts = pg.label_counts()
    assert pg._vstore._store is None
    assert set(counts) == set(pg._vstore.amap.values)
    rcounts = pg.relationship_counts()
    assert pg._estore._store is None
    assert sum(rcounts.values()) == pg._estore.nnz
    for lab, c in counts.items():
        assert int(pg.query_labels([lab]).sum()) == c


# ------------------------------------------------- the overlay's service side
def test_result_cache_overlap_invalidation():
    pg = build_tenant_graph("arr", 600, seed=3, device="cpu")
    with Service() as svc:
        svc.add_graph("g", pg)
        first = svc.query("g", PATTERN, timeout=TIMEOUT)
        assert len(svc.result_cache) == 1
        nodes = as_np(pg.graph.node_map)
        pg.add_node_labels(nodes[:5], ["l9"] * 5)  # no overlap: entry lives
        assert len(svc.result_cache) == 1
        assert svc.query("g", PATTERN, timeout=TIMEOUT) is first
        pg.update_node_properties("age", nodes[:3], [1, 2, 3])
        assert svc.query("g", PATTERN, timeout=TIMEOUT) is first
        es, ed = as_np(pg.graph.src), as_np(pg.graph.dst)
        pg.add_edge_relationships(nodes[es[:6]], nodes[ed[:6]], ["follows"] * 6)
        assert len(svc.result_cache) == 0
        fresh = svc.query("g", PATTERN, timeout=TIMEOUT)
        assert fresh is not first
        assert _eq(fresh.edge_mask, pg.match(PATTERN).edge_mask)
        svc.query("g", "(a:l9)-[:likes]->(b)", timeout=TIMEOUT)
        assert len(svc.result_cache) >= 1
        pg.insert_edges(nodes[:4], nodes[-4:])  # structural: purge everything
        assert len(svc.result_cache) == 0
        assert svc.stats()["invalidated_results"] >= 2


def test_snapshot_results_survive_parent_writes():
    pg = build_tenant_graph("arr", 600, seed=4, device="cpu")
    with Service() as svc:
        svc.add_graph("g", pg)
        snap = svc.snapshot_graph("g")
        pinned = svc.query(snap, PATTERN, timeout=TIMEOUT)
        live = svc.query("g", PATTERN, timeout=TIMEOUT)
        nodes = as_np(pg.graph.node_map)
        pg.add_node_labels(nodes[:9], ["l1"] * 9)
        pg.insert_edges(nodes[:6], nodes[-6:])
        assert svc.query(snap, PATTERN, timeout=TIMEOUT) is pinned
        refreshed = svc.query("g", PATTERN, timeout=TIMEOUT)
        assert refreshed is not live
        assert _eq(refreshed.vertex_mask, pg.match(PATTERN).vertex_mask)
        assert svc.snapshot_graph("g") == svc.snapshot_graph("g")
        svc.drop_graph(snap)
        assert snap not in svc.registry
        assert all(k[0] != snap for k in svc.result_cache._data)


def test_fork_and_compact_verbs():
    pg = build_tenant_graph("arr", 600, seed=6, device="cpu")
    with Service() as svc:
        svc.add_graph("g", pg)
        nodes = as_np(pg.graph.node_map)
        fork = svc.fork_graph("g")
        fpg = svc.registry.get(fork)
        fpg.delete_vertices(nodes[:1])
        assert _eq(svc.query(fork, PATTERN, timeout=TIMEOUT).vertex_mask,
                   fpg.match(PATTERN).vertex_mask)
        assert _eq(svc.query("g", PATTERN, timeout=TIMEOUT).vertex_mask,
                   pg.match(PATTERN).vertex_mask)
        pg.insert_edges(nodes[:8], nodes[-8:])
        folded = svc.compact_graph("g")
        assert folded["delta_edges"] > 0 and not pg.has_overlay()
        assert svc.compact_graph("g")["delta_edges"] == 0
        assert _eq(svc.query("g", PATTERN, timeout=TIMEOUT).edge_mask,
                   pg.match(PATTERN).edge_mask)
        st = svc.stats()
        assert st["forks"] == 1
        svc.drop_graph(fork)
        assert fork not in svc.registry


def test_noop_mutations_keep_version_and_cache():
    pg = build_tenant_graph("arr", 400, seed=6, device="cpu")
    with Service() as svc:
        svc.add_graph("g", pg)
        first = svc.query("g", PATTERN, timeout=TIMEOUT)
        v0 = pg.version
        empty = np.zeros(0, np.int64)
        pg.add_edges_from(empty, empty)
        pg.add_node_labels(empty, [])
        pg.add_edge_relationships(empty, empty, [])
        pg.add_node_properties("p_new", empty, empty)
        pg.add_edge_properties("q_new", empty, empty, empty)
        pg.insert_edges(empty, empty)
        pg.delete_vertices(empty)
        pg.delete_edges(empty, empty)
        pg.update_node_properties("age", empty, empty)
        pg.update_edge_properties("w", empty, empty, empty)
        assert pg.version == v0
        assert len(svc.result_cache) == 1
        assert svc.query("g", PATTERN, timeout=TIMEOUT) is first


def test_background_compactor_sweeps_a_graph_registry():
    from repro_torch.overlay import Compactor

    reg = GraphRegistry()
    pg = _build("arr", m=300, seed=21)
    reg.register("g", pg)
    pg.match(PATTERN)
    nodes = as_np(pg.graph.node_map)
    pg.insert_edges(nodes[:20], nodes[-20:])
    comp = Compactor(reg, threshold=4, interval=0.01)
    comp.start()
    deadline = time.monotonic() + 60
    while pg.has_overlay() and time.monotonic() < deadline:
        time.sleep(0.01)
    comp.stop()
    assert not pg.has_overlay() and comp.compactions >= 1
    pg.insert_edges(nodes[:2], nodes[-2:])
    snap = pg.snapshot()
    reg.register("s", snap)
    assert Compactor(reg, threshold=1000).sweep() == 0
    assert Compactor(reg, threshold=1).sweep() == 1
    assert not pg.has_overlay() and snap.has_overlay()


def test_service_stats_surface_compactor():
    with Service(config=ServiceConfig(auto_compact_threshold=8)) as svc:
        svc.add_graph("g", build_tenant_graph("arr", 300, seed=5, device="cpu"))
        st = svc.stats()
        assert st["compactor"]["errors"] == 0
        assert st["compactor"]["failing_graphs"] == {}
    with Service() as svc:
        assert "compactor" not in svc.stats()


def test_service_auto_compaction_invalidates_results():
    pg = build_tenant_graph("arr", 400, seed=8, device="cpu")
    with Service(config=ServiceConfig(auto_compact_threshold=8)) as svc:
        svc.add_graph("g", pg)
        svc.query("g", PATTERN, timeout=TIMEOUT)
        nodes = as_np(pg.graph.node_map)
        pg.insert_edges(nodes[:16], nodes[-16:])
        deadline = time.monotonic() + 60
        while pg.has_overlay() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not pg.has_overlay()
        assert len(svc.result_cache) == 0
        got = svc.query("g", PATTERN, timeout=TIMEOUT)
        assert _eq(got.edge_mask, pg.match(PATTERN).edge_mask)


def test_service_serves_pinned_snapshot_during_writes():
    pg = _build("arr", m=600, seed=23)
    nodes = as_np(pg.graph.node_map)
    rng = np.random.default_rng(37)
    batches = [(rng.choice(nodes, 16), rng.choice(nodes, 16)) for _ in range(12)]
    with Service() as svc:
        svc.add_graph("g", pg)
        snap = svc.snapshot_graph("g")
        pinned = svc.query(snap, PATTERN, timeout=TIMEOUT)
        want = as_np(pinned.vertex_mask)
        stop = threading.Event()
        errors = []

        def writer():
            try:
                for bs, bd in batches:
                    pg.insert_edges(bs, bd)
                    time.sleep(0.002)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
            finally:
                stop.set()

        t = threading.Thread(target=writer)
        t.start()
        reads = 0
        try:
            while not stop.is_set() or reads < 5:
                got = svc.query(snap, PATTERN, timeout=TIMEOUT)
                assert got is pinned
                assert _eq(got.vertex_mask, want)
                reads += 1
                if reads > 500:
                    break
        finally:
            t.join(timeout=60)
        assert not errors and reads >= 5
        assert _eq(svc.query("g", PATTERN, timeout=TIMEOUT).vertex_mask,
                   pg.match(PATTERN).vertex_mask)


# -------------------------------------------------------------- analytics
@pytest.mark.parametrize("backend", BACKENDS)
def test_analytics_verbs_equal_the_graph_and_the_reference(backend):
    ref_pkg, port_pkg = service_pkg("ref"), service_pkg("port")
    ref_pg, pg = ref_pkg.build(backend, 500, 4), port_pkg.build(backend, 500, 4)
    seeds = as_np(pg.graph.node_map)[:4]
    spat = "(a)-[:follows]->(b)"
    with Service() as svc, ref_pkg.Service() as ref_svc:
        svc.add_graph("g", pg)
        ref_svc.add_graph("g", ref_pg)
        sp = svc.shortest_paths("g", seeds, weight="w", pattern=spat)
        assert isinstance(sp, np.ndarray)
        assert np.array_equal(sp, as_np(pg.shortest_paths(seeds, weight="w", pattern=spat)))
        assert np.array_equal(sp, ref_svc.shortest_paths("g", seeds, weight="w", pattern=spat))
        pr = svc.pagerank("g", weight="w")
        assert np.array_equal(pr, as_np(pg.pagerank(weight="w")))
        assert np.allclose(pr, ref_svc.pagerank("g", weight="w"), rtol=0, atol=1e-6)
        cm = svc.communities("g")
        assert np.array_equal(cm, ref_svc.communities("g"))
        hits = svc.stats().get("result_hits", 0)
        assert svc.shortest_paths("g", seeds[::-1], weight="w", pattern=spat) is sp
        assert svc.stats()["result_hits"] == hits + 1
        pg.update_edge_properties("w", *(as_np(pg.graph.node_map)[as_np(x)[:2]]
                                         for x in (pg.graph.src, pg.graph.dst)), [9.0, 9.0])
        assert svc.shortest_paths("g", seeds, weight="w", pattern=spat) is not sp
        assert svc.communities("g") is cm  # a write to w is no write to communities


# ----------------------------------------------------------------- sampling
def _sample_specs(pg):
    nodes = as_np(pg.graph.node_map)
    return [(nodes[13 * i:13 * i + 40], i) for i in range(6)] + [("(a:l0)", 77)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_coalesced_batch_equals_sequential_sample(backend, monkeypatch):
    import repro_torch.kernels.neighbor_sample as ns

    rows, batched = [], ns.neighbor_sample_batched

    def recording(seg, dst, n, m, seeds, valid, keys, **kw):
        rows.append((len(keys), int(valid.sum())))
        return batched(seg, dst, n, m, seeds, valid, keys, **kw)

    monkeypatch.setattr(ns, "neighbor_sample_batched", recording)
    pg = _build(backend, m=600, seed=5)
    specs = _sample_specs(pg)
    with Service() as svc:
        svc.add_graph("g", pg)
        got = svc.sample_batch("g", specs, [4, 2])
        # one B3 launch per seed-capacity bucket, R padded to its bucket
        sizes = [int(pg.match(s).node_masks[0].sum()) if isinstance(s, str)
                 else len(pg._seed_ids(s)) for s, _ in specs]
        by_bucket = {}
        for n in sizes:
            by_bucket.setdefault(ns.bucketed_seeds(max(n, 1)), []).append(n)
        assert svc.stats()["sample_coalesced_launches"] == len(by_bucket) == len(rows)
        assert sorted(rows) == sorted((ns.bucketed_requests(len(v)), sum(v))
                                      for v in by_bucket.values())
    for (seeds, sv), blocks in zip(specs, got):
        assert_same_blocks(blocks, pg.sample(seeds, [4, 2], seed=sv))


@pytest.mark.parametrize("backend", BACKENDS)
def test_coalesced_samples_on_an_overlay_with_tombstones(backend):
    """Delta edges and tombstoned vertices: an unfiltered request's edge
    words are the alive edges (not None), so each coalesced row is still
    bitwise its solo ``sample`` — filtered and unfiltered rows in one
    launch, through ``sample_batch`` and concurrent ``submit_sample``."""
    pg = _build(backend, m=600, seed=8)
    nodes = as_np(pg.graph.node_map)
    pg.match(PATTERN)  # seal
    pg.insert_edges(nodes[:40], nodes[-40:])
    pg.add_edge_relationships(nodes[:40], nodes[-40:], ["follows"] * 40)
    pg.delete_vertices(nodes[40:60])
    seg, dstv, max_deg, perm = pg._sampling_view()
    assert perm is not None
    assert pg._sample_edge_words(None, perm) is not None  # the alive edges
    specs = [(nodes[10 * i:10 * i + 70], i) for i in range(5)]
    filt = "(a)-[:follows]->(b)"
    with Service() as svc:
        svc.add_graph("g", pg)
        unfiltered = svc.sample_batch("g", specs, [3, 2])
        filtered = svc.sample_batch("g", specs, [3, 2], pattern=filt)
        futs = [svc.submit_sample("g", s, [3, 2], seed=sv,
                                  pattern=filt if sv % 2 else None) for s, sv in specs]
        mixed = [f.result(timeout=TIMEOUT) for f in futs]
    for (s, sv), a, b, c in zip(specs, unfiltered, filtered, mixed):
        assert_same_blocks(a, pg.sample(s, [3, 2], seed=sv))
        assert_same_blocks(b, pg.sample(s, [3, 2], seed=sv, pattern=filt))
        assert_same_blocks(c, pg.sample(s, [3, 2], seed=sv, pattern=filt if sv % 2 else None))
    dead = set(nodes[40:60].tolist())
    for blocks in unfiltered:
        for b in blocks:
            assert not dead & set(as_np(pg.graph.node_map)[b.src_nodes].tolist())


def test_coalesced_sample_rows_read_their_own_edge_words():
    """A filtered row coalesced beside an unfiltered one samples only the
    filter's edges (its row of words); the unfiltered row samples others
    too."""
    pg = _build("arr", m=600, seed=12)
    nodes = as_np(pg.graph.node_map)
    filt = "(a)-[:follows]->(b)"
    with Service(config=ServiceConfig(window_ms=200.0, adaptive_window=False)) as svc:
        svc.add_graph("g", pg)
        futs = [svc.submit_sample("g", nodes[:64], [8], seed=1, pattern=p) for p in (None, filt)]
        plain, filtered = (f.result(timeout=TIMEOUT) for f in futs)
        assert svc.stats()["sample_coalesced_launches"] == 1  # one window, one group
    assert_same_blocks(plain, pg.sample(nodes[:64], [8], seed=1))
    assert_same_blocks(filtered, pg.sample(nodes[:64], [8], seed=1, pattern=filt))
    g = pg.graph
    follows = as_np(pg.query_relationships(["follows"]))
    follow_pairs = set(zip(as_np(g.src)[follows].tolist(), as_np(g.dst)[follows].tolist()))

    def sampled_pairs(block):
        ok = block.edge_mask
        return set(zip(block.dst_nodes[block.edge_dst[ok]].tolist(),
                       block.src_nodes[block.edge_src[ok]].tolist()))

    assert sampled_pairs(filtered[0]) and sampled_pairs(filtered[0]) <= follow_pairs
    assert sampled_pairs(plain[0]) - follow_pairs


def test_service_filtered_sample_parity_and_stats():
    pg = _build("arr", m=600, seed=5)
    nodes = as_np(pg.graph.node_map)
    with Service() as svc:
        svc.add_graph("g", pg)
        before = svc.stats().get("sample_requests", 0)
        got = svc.sample("g", nodes[:50], [5], pattern="(a)-[:follows]->(b)", seed=4,
                         timeout=TIMEOUT)
        assert_same_blocks(got, pg.sample(nodes[:50], [5], pattern="(a)-[:follows]->(b)",
                                          seed=4))
        assert svc.stats()["sample_requests"] == before + 1


def test_result_cache_deterministic_hits_keyed_never_cached():
    pg = _build("arr", m=600, seed=5)
    nodes = as_np(pg.graph.node_map)
    with Service() as svc:
        svc.add_graph("g", pg)
        a = svc.sample("g", nodes[:40], [4], seed=5, timeout=TIMEOUT)
        h0 = svc.stats().get("result_hits", 0)
        b = svc.sample("g", nodes[:40], [4], seed=5, timeout=TIMEOUT)
        assert svc.stats()["result_hits"] == h0 + 1
        assert_same_blocks(a, b)
        h1 = svc.stats()["result_hits"]
        c = svc.sample("g", nodes[:40], [4], deterministic=False, timeout=TIMEOUT)
        d = svc.sample("g", nodes[:40], [4], deterministic=False, timeout=TIMEOUT)
        assert svc.stats()["result_hits"] == h1
        same = all(np.array_equal(x.edge_src, y.edge_src)
                   and np.array_equal(x.edge_mask, y.edge_mask) for x, y in zip(c, d))
        assert not same
        with pytest.raises(ValueError, match="fanouts"):
            svc.submit_sample("g", nodes[:4], [0])


def test_compile_count_bounded_across_mixed_size_burst():
    from repro_torch.kernels.neighbor_sample import sample_compile_count
    from repro_torch.obs.metrics import GLOBAL

    pg = _build("arr", m=600, seed=5)
    nodes = as_np(pg.graph.node_map)
    sizes = np.random.default_rng(0).integers(1, 500, 64)
    with Service() as svc:
        svc.add_graph("g", pg)
        svc.sample("g", nodes[:16], [3], seed=0, timeout=TIMEOUT)
        c0 = sample_compile_count()
        m0 = GLOBAL.counter("pg_sample_compiles").value()
        l0 = GLOBAL.counter("pg_sample_launches").value()
        futs = [svc.submit_sample("g", nodes[:int(s)], (3,), seed=i, deterministic=False)
                for i, s in enumerate(sizes)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        grown = sample_compile_count() - c0
        assert grown <= 16, grown
        assert GLOBAL.counter("pg_sample_compiles").value() == m0 + grown
        assert GLOBAL.counter("pg_sample_launches").value() > l0


def test_sample_batch_takes_a_filter_per_request():
    """``(seeds, seed, edge_filter)`` triples: requests under different
    filters share one launch (the same capacity bucket) and each row reads
    its own edge words — bitwise each request's solo ``sample``."""
    pg = _build("arr", m=600, seed=14)
    nodes = as_np(pg.graph.node_map)
    filters = (None, "(a)-[:follows]->(b)", "(a)-[e {w < 1.0}]->(b)", None)
    specs = [(nodes[7 * i:7 * i + 50], i, f) for i, f in enumerate(filters)]
    with Service() as svc:
        svc.add_graph("g", pg)
        got = svc.sample_batch("g", specs, [4, 2], pattern="(a)-[:likes]->(b)")
        assert svc.stats()["sample_coalesced_launches"] == 1
    for (s, sv, f), blocks in zip(specs, got):
        assert_same_blocks(blocks, pg.sample(s, [4, 2], seed=sv, pattern=f))
