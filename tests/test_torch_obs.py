"""The port's observability layer (``repro_torch.obs``: metrics, Prometheus
exposition, trace spans, EXPLAIN ANALYZE) — the contracts of
``tests/test_obs.py`` in the port's terms, with cross-package checks:

* the same request stream through both packages' ``Service`` moves the
  same counters by the same amounts (request, cache, coalescing and the
  executor's ``pg_exec_*`` totals);
* after the same operations both expositions list the same metric names;
* ``match(profile=True)`` returns plain ``match``'s result bitwise, and
  ``explain_analyze``'s fields and ``to_dict()`` keys are the reference's.

Graphs are ``pgserve.build_tenant_graph``'s tenants, the port's on the CPU.
"""
import dataclasses
import threading

import numpy as np
import pytest

from _torch_parity import SERVE_PATTERNS, as_np, assert_same_match, service_pkg
from repro_torch.launch.pgserve import build_tenant_graph
from repro_torch.obs import (
    Span,
    Trace,
    TraceBuffer,
    new_trace_id,
    parse_prometheus,
    render_prometheus,
    set_enabled,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.service import Service, ServiceConfig
from repro_torch.service.cache import LRUCache

PATTERN = "(a:l1|l2)-[:follows]->(b:l3)"
BACKENDS = ("arr", "list", "listd")
# a query_batch stream: duplicates, a predicate, a 2-hop, a variable-length hop
STREAM = [*SERVE_PATTERNS, SERVE_PATTERNS[0], "(a:l1)-[:follows*1..3]->(b:l2)",
          SERVE_PATTERNS[2], PATTERN]
COUNTERS = ("submitted", "completed", "result_hits", "result_misses", "coalesced_launches",
            "coalesced_masks", "dedup_hits", "fallback_requests",
            "traversal_fallback_requests")
EXEC = ("pg_exec_plans", "pg_exec_mask_steps", "pg_exec_fused_masks")


@pytest.fixture
def pg():
    return build_tenant_graph("arr", 600, seed=11, device="cpu")


# ---------------------------------------------------------------- registry
def test_registry_get_or_create_identity():
    reg = MetricsRegistry()
    c1 = reg.counter("hits", "help text")
    assert reg.counter("hits") is c1
    a = reg.counter("pg_wire_frames", dir="sent")
    b = reg.counter("pg_wire_frames", dir="received")
    assert a is not b and reg.counter("pg_wire_frames", dir="sent") is a
    assert reg.histogram("lat_ms", op="query", tier="x") is reg.histogram(
        "lat_ms", tier="x", op="query")


def test_registry_rejects_type_mismatch():
    reg = MetricsRegistry()
    reg.counter("thing")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("thing")


def test_registry_snapshot_keys():
    reg = MetricsRegistry()
    reg.counter("plain").inc(3)
    reg.gauge("occupancy", tier="result").set(7)
    snap = reg.snapshot()
    assert snap["plain"] == 3
    assert snap["occupancy{tier=result}"] == 7


def test_counter_concurrent_increments_exact():
    reg = MetricsRegistry()

    def worker():
        for _ in range(2_000):
            reg.counter("submitted").inc()

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert reg.counter("submitted").value() == 16_000


def test_service_bump_concurrent_exact():
    svc = Service.__new__(Service)  # counters only — no scheduler needed
    svc.metrics = MetricsRegistry()
    svc._counters = {}

    def worker():
        for _ in range(1_000):
            svc._bump("submitted")

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert svc.metrics.counter("submitted").value() == 8_000


def test_histogram_buckets_cumulative():
    h = Histogram("h", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    snap = h.value()
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(555.5)
    assert snap["buckets"] == {1.0: 1, 10.0: 2, 100.0: 3}


def test_histogram_rejects_unsorted_buckets():
    with pytest.raises(ValueError):
        Histogram("h", buckets=(10.0, 1.0))


def test_disabled_metrics_do_not_move():
    c, h, g = Counter("c"), Histogram("h"), Gauge("g")
    prev = set_enabled(False)
    try:
        assert prev is True
        c.inc(5)
        h.observe(1.0)
        g.set(3)
        assert c.value() == 0 and h.value()["count"] == 0
        assert g.value() == 3  # gauges record state: deliberately ungated
    finally:
        set_enabled(prev)
    c.inc(5)
    assert c.value() == 5


def test_set_enabled_returns_previous():
    try:
        assert set_enabled(False) is True
        assert set_enabled(True) is False
        assert set_enabled(True) is True
    finally:
        set_enabled(True)


# -------------------------------------------------------------- exposition
def test_render_parse_roundtrip_and_name_normalization():
    reg = MetricsRegistry()
    reg.counter("result_hits").inc(4)
    reg.counter("pg_wire_frames", dir="sent").inc(9)
    reg.gauge("pg_cache_size", tier="plan").set(3)
    reg.histogram("pg_wire_op_ms", op="query", buckets=(1.0, 10.0)).observe(2.5)
    text = render_prometheus(reg)
    assert "# TYPE pg_service_result_hits_total counter" in text
    parsed = parse_prometheus(text)
    assert parsed["pg_service_result_hits_total"] == 4
    assert parsed['pg_wire_frames_total{dir="sent"}'] == 9
    assert parsed['pg_cache_size{tier="plan"}'] == 3
    assert parsed['pg_wire_op_ms_bucket{op="query",le="1"}'] == 0
    assert parsed['pg_wire_op_ms_bucket{op="query",le="10"}'] == 1
    assert parsed['pg_wire_op_ms_bucket{op="query",le="+Inf"}'] == 1
    assert parsed['pg_wire_op_ms_count{op="query"}'] == 1
    assert parsed['pg_wire_op_ms_sum{op="query"}'] == pytest.approx(2.5)


def test_parse_prometheus_rejects_malformed():
    with pytest.raises(ValueError):
        parse_prometheus("pg_thing_total notanumber\n")
    with pytest.raises(ValueError):
        parse_prometheus("   \x00garbage 1\n")


def test_service_exposition_agrees_with_stats(pg):
    with Service() as svc:
        svc.add_graph("g", pg)
        for _ in range(3):
            svc.query("g", PATTERN, timeout=60)
        st = svc.stats()
        parsed = parse_prometheus(svc.metrics_text())
    assert parsed["pg_service_submitted_total"] == st["submitted"] == 3
    assert parsed["pg_service_completed_total"] == st["completed"]
    assert parsed['pg_cache_size{tier="result"}'] == st["result_cache"]["size"]
    assert parsed['pg_cache_hits_total{tier="result"}'] == st["result_cache"]["hits"]


# ------------------------------------------------------------------- traces
def test_span_tree_and_serialization():
    tr = Trace("query", trace_id=new_trace_id())
    with tr.span("plan") as sp:
        sp.annotate(steps=3)
        with sp.span("inner"):
            pass
    tr.add_span("execute", 1.0, 1.25, batch_size=4)
    d = tr.finish().to_dict()
    assert d["trace_id"] == tr.trace_id
    assert [s["name"] for s in d["spans"]] == ["plan", "execute"]
    assert d["spans"][0]["attrs"] == {"steps": 3}
    assert d["spans"][0]["spans"][0]["name"] == "inner"
    assert d["spans"][1]["ms"] == pytest.approx(250.0)
    back = Trace.from_dict(d)
    assert back.trace_id == tr.trace_id
    assert back.to_dict()["spans"][1]["ms"] == pytest.approx(250.0)


def test_span_context_manager_records_error():
    tr = Trace()
    with pytest.raises(RuntimeError):
        with tr.span("execute") as sp:
            raise RuntimeError("boom")
    assert sp.t1 is not None and sp.attrs["error"] == "RuntimeError"
    assert isinstance(sp, Span)


def test_trace_buffer_ring_bounds_and_slow_mirror():
    buf = TraceBuffer(maxlen=4, slow_ms=0.0, slow_maxlen=2)
    for i in range(7):
        buf.push(Trace(trace_id=f"t{i:02d}"))
    assert len(buf) == 4
    assert [t["trace_id"] for t in buf.traces()] == ["t03", "t04", "t05", "t06"]
    assert [t["trace_id"] for t in buf.slow()] == ["t05", "t06"]
    disabled = TraceBuffer(maxlen=0)
    disabled.push(Trace())
    assert len(disabled) == 0


def test_trace_serialization_matches_the_reference():
    """The same span tree serializes to the same dict in both packages (the
    wire carries it), and each rehydrates the other's."""
    from repro.obs import trace as ref_trace

    def tree(mod):
        tr = mod.Trace("query", trace_id="abc123")
        tr.add_span("parse", 0.0, 0.001)
        tr.add_span("execute", 0.001, 0.004, batch_size=3)
        tr.root.t0, tr.root.t1 = 0.0, 0.005
        return tr.to_dict()

    from repro_torch.obs import trace as port_trace

    assert tree(ref_trace) == tree(port_trace)
    assert port_trace.Trace.from_dict(tree(ref_trace)).to_dict() == tree(ref_trace)


def test_service_trace_ring_captures_span_stages(pg):
    with Service(config=ServiceConfig(slow_query_ms=0.0)) as svc:
        svc.add_graph("g", pg)
        svc.query("g", PATTERN, timeout=60)  # cold: full pipeline
        svc.query("g", PATTERN, timeout=60)  # warm: submit fastpath hit
        traces = svc.trace_log()
        slow = svc.slow_queries()
    assert len(traces) == 2
    cold_names = [s["name"] for s in traces[0]["spans"]]
    for stage in ("parse", "batch.wait", "cache", "plan", "execute"):
        assert stage in cold_names, cold_names
    cache = next(s for s in traces[1]["spans"] if s["name"] == "cache")
    assert cache["attrs"]["hit"] is True
    assert len(slow) == 2


# ----------------------------------------------------------- explain analyze
def test_explain_analyze_first_then_steady(pg):
    """The port compiles nothing per shape: the report's split is the first
    call's one-off share, and a second report never shows more of it than
    the first.  Both reports' totals bound their steady parts."""
    pattern = "(a:l4)-[:likes]->(b:l5)"
    rep = pg.explain_analyze(pattern)
    assert rep.parse_ms >= 0 and rep.plan_ms >= 0
    assert rep.total_first_ms >= rep.steady_ms >= 0
    assert rep.compile_ms >= 0 and rep.cold == (rep.compile_ms > 0)
    rep2 = pg.explain_analyze(pattern)
    assert rep2.total_first_ms >= rep2.steady_ms >= 0
    txt = rep.describe()
    assert "analyze" in txt and "compile" in txt and "XLA" not in txt
    assert pg.explain(pattern) in txt


def test_explain_analyze_fields_and_keys_match_the_reference(pg):
    from repro.launch.pgserve import build_tenant_graph as ref_build
    from repro.obs.profile import ProfileReport as RefReport
    from repro_torch.obs.profile import ProfileReport

    assert ([f.name for f in dataclasses.fields(ProfileReport)]
            == [f.name for f in dataclasses.fields(RefReport)])
    for prop in ("compile_ms", "cold", "total_first_ms", "steady_ms"):
        assert isinstance(getattr(ProfileReport, prop), property), prop
    ref_pg = ref_build("arr", 600, seed=11)
    for pattern in (PATTERN, "(a:l1)-[:follows*1..3]->(b:l2)"):
        got, want = pg.explain_analyze(pattern), ref_pg.explain_analyze(pattern)
        assert set(got.to_dict()) == set(want.to_dict())
        assert got.attrs == want.attrs
        assert got.plan.describe() == want.plan.describe()


def test_match_profile_returns_identical_result(pg):
    ref = pg.match(PATTERN)
    got, rep = pg.match(PATTERN, profile=True)
    assert_same_match(ref, got)
    assert rep.steady_ms >= 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_match_profile_equals_the_reference_match(backend):
    """EXPLAIN ANALYZE's bool-mask path answers the reference's ``match``
    bitwise on every backend, variable-length hops included."""
    ref_pkg, port_pkg = service_pkg("ref"), service_pkg("port")
    ref_pg, port_pg = ref_pkg.build(backend, 500, 3), port_pkg.build(backend, 500, 3)
    for pattern in STREAM:
        got, _ = port_pg.match(pattern, profile=True)
        assert_same_match(ref_pg.match(pattern), got)


def test_profile_runs_counter_moves():
    from repro_torch.obs import GLOBAL

    pg = build_tenant_graph("arr", 300, seed=2, device="cpu")
    before = GLOBAL.counter("pg_profile_runs").value()
    pg.explain_analyze(PATTERN)
    pg.match(PATTERN, profile=True)
    assert GLOBAL.counter("pg_profile_runs").value() == before + 2


# -------------------------------------------------- across the two packages
def _exec_totals(pkg):
    return {k: pkg.obs.GLOBAL.counter(k).value() for k in EXEC}


def _run_stream(pkg, backend):
    """``STREAM`` through ``query_batch`` twice (the second from the result
    cache), then three blocking queries; the service's counters and the
    executor's process totals it moved."""
    g = pkg.build(backend, 600, 5)
    before = _exec_totals(pkg)
    with pkg.Service() as svc:
        svc.add_graph("g", g)
        first = svc.query_batch("g", STREAM)
        svc.query_batch("g", STREAM[::-1])
        for p in (SERVE_PATTERNS[1], "(a:l9)-[:likes]->(b)", SERVE_PATTERNS[1]):
            svc.query("g", p, timeout=60)
        st = svc.stats()
    after = _exec_totals(pkg)
    counters = {k: st.get(k, 0) for k in COUNTERS}
    counters.update({k: after[k] - before[k] for k in EXEC})
    return counters, first


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_batch_counters_equal_across_packages(backend):
    ref_counts, ref_res = _run_stream(service_pkg("ref"), backend)
    port_counts, port_res = _run_stream(service_pkg("port"), backend)
    assert port_counts == ref_counts
    for a, b in zip(ref_res, port_res):
        assert_same_match(a, b)
    if backend == "arr":
        assert port_counts["coalesced_launches"] > 0
    else:
        assert port_counts["fallback_requests"] > 0
    assert port_counts["traversal_fallback_requests"] > 0


def _exercise(pkg):
    """Every instrumented path once: queries (coalesced, fastpath, traced),
    samples, the three analytics verbs, k-hop and components, EXPLAIN
    ANALYZE, a compactor sweep and a wire round trip.  Returns the
    exposition's metric names (labels and histogram suffixes stripped)."""
    g = pkg.build("arr", 400, 7)
    nodes = as_np(g.graph.node_map)
    with pkg.Service() as svc:
        svc.add_graph("g", g)
        svc.query_batch("g", STREAM)
        svc.query("g", PATTERN, timeout=60)
        svc.query("g", PATTERN, timeout=60)
        svc.sample_batch("g", [(nodes[:20], 1), (nodes[5:30], 2)], [3, 2])
        svc.sample("g", nodes[:20], [3], seed=4)
        svc.shortest_paths("g", nodes[:3], weight="w")
        svc.pagerank("g")
        svc.communities("g")
        g.khop(nodes[:4], 2)
        g.components()
        g.explain_analyze(PATTERN)
        fork = g.fork()
        fork.insert_edges(nodes[:8], nodes[-8:])

        class Reg:
            def names(self):
                return ["f"]

            def get(self, name):
                return fork

        assert pkg.Compactor(Reg(), threshold=1).sweep() == 1
        server = pkg.server(svc).start()
        try:
            with pkg.PGClient(port=server.port, timeout=60) as c:
                c.query("g", PATTERN)
                c.ping()
        finally:
            server.close(timeout=10)
        text = svc.metrics_text()
    names = set()
    for key in parse_prometheus(text):
        base = key.split("{", 1)[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and not base.endswith("_total"):
                base = base[: -len(suffix)]
        names.add(base)
    return names


def test_expositions_list_the_same_metric_names():
    ref = _exercise(service_pkg("ref"))
    port = _exercise(service_pkg("port"))
    assert port == ref
    for name in ("pg_exec_plans_total", "pg_sample_launches_total", "pg_traverse_runs_total",
                 "pg_traverse_relax_rounds", "pg_profile_runs_total", "pg_wire_op_ms",
                 "pg_sched_coalesce_width", "pg_compact_compactions_total"):
        assert name in port, name


def test_traverse_metrics_record_the_rounds_the_engine_ran():
    """The port's ``pg_traverse_relax_rounds`` observes the rounds its loop
    ran (``traverse.engine.rounds``), the reference's the loop's bound."""
    from repro_torch import traverse
    from repro_torch.obs import GLOBAL

    pg = build_tenant_graph("arr", 400, seed=9, device="cpu")
    h = GLOBAL.histogram("pg_traverse_relax_rounds", op="components")
    runs = GLOBAL.counter("pg_traverse_runs", op="components")
    c0, s0, r0 = h.value()["count"], h.value()["sum"], runs.value()
    before = dict(traverse.engine.rounds)
    pg.components(max_iters=64)
    ran = traverse.engine.rounds["components"] - before.get("components", 0)
    assert runs.value() == r0 + 1
    assert h.value()["count"] == c0 + 1
    assert h.value()["sum"] == pytest.approx(s0 + ran)
    assert 0 < ran <= 64


# ----------------------------------------------------------------- lru cache
def test_lru_cache_stats_fields_regression():
    c = LRUCache(maxsize=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    assert c.get("zzz") is None
    c.put("c", 3)
    assert c.stats() == {"size": 2, "maxsize": 2, "hits": 1, "misses": 1, "evictions": 1}
    assert c.get("b") is None


def test_disabled_metrics_service_answers_unchanged(pg):
    """With metrics off the service still answers bitwise and counts
    nothing."""
    with Service() as svc:
        svc.add_graph("g", pg)
        prev = set_enabled(False)
        try:
            got = svc.query("g", SERVE_PATTERNS[1], timeout=60)
            assert svc.stats().get("submitted", 0) == 0
        finally:
            set_enabled(prev)
    want = pg.match(SERVE_PATTERNS[1])
    assert np.array_equal(as_np(got.edge_mask), as_np(want.edge_mask))
