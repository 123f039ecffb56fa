"""The port's network front-end (``repro_torch.service.{wire,server,client}``
and ``launch/pgserve``) — the contracts of ``tests/test_net_service.py``
in the port's terms, and across the two packages:

* the codec round-trips headers and arrays exactly and rejects garbage
  frames with ``ProtocolError``; the frames of the same result are
  byte-identical whichever package encodes them;
* a query through ``PGClient`` → TCP → ``PGServer`` → ``Service`` returns
  masks bitwise-equal to in-process ``match`` — port client and server,
  the reference's client against the port's server, and the port's client
  against the reference's server (all in process on 127.0.0.1);
* failures stay isolated, drains complete in-flight work (and do not wait
  for their own frame), the adaptive micro-batch window behaves;
* the cross-process server (``spawn_server``) and the CLI's
  ``--smoke``/``--net --smoke`` gates pass on the CPU.

Every socket, future and subprocess wait has its own timeout, and every
server is closed in a ``finally``.
"""
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import SERVE_PATTERNS, as_np, assert_same_blocks, service_pkg
from repro_torch.launch.pgserve import build_tenant_graph
from repro_torch.service import MicroBatcher, PGClient, PGServer, Service, ServiceConfig
from repro_torch.service import wire

PATTERNS = SERVE_PATTERNS
TIMEOUT = 120
SRC = Path(__file__).resolve().parents[1] / "src"


def _eq(a, b):
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and bool((a == b).all())


def _assert_wire_matches(got, ref):
    assert _eq(got.vertex_mask, ref.vertex_mask)
    assert _eq(got.edge_mask, ref.edge_mask)
    gb, rb = got.bindings(), ref.bindings()
    assert sorted(gb) == sorted(rb)
    for k in rb:
        assert _eq(gb[k], rb[k]), k


def _build(m, seed, backend="arr"):
    return build_tenant_graph(backend, m, seed=seed, device="cpu")


# ------------------------------------------------------------------- codec
def test_wire_roundtrip_header_and_arrays():
    arrays = [
        np.arange(7, dtype=np.int32),
        np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32),
        np.array([], dtype=np.int64),
        np.random.default_rng(1).random(83) > 0.5,
        np.zeros((2, 9), dtype=np.bool_),
    ]
    header = {"op": "query", "id": 3, "pattern": "(a)-[]->(b)", "impl": None}
    a, b = socket.socketpair()
    try:
        b.settimeout(30)
        wire.send_msg(a, header, arrays)
        got_header, got_arrays = wire.recv_msg(b)
        assert got_header == header and len(got_arrays) == len(arrays)
        for orig, back in zip(arrays, got_arrays):
            assert back.dtype == orig.dtype and back.shape == orig.shape
            assert _eq(back, orig)
    finally:
        a.close(), b.close()


def test_wire_rejects_garbage_and_truncation():
    a, b = socket.socketpair()
    try:
        b.settimeout(30)
        a.sendall(b"HTTP/1.1 200 OK\r\n\r\n" + b"x" * 20)
        with pytest.raises(wire.ProtocolError, match="magic"):
            wire.recv_msg(b)
    finally:
        a.close(), b.close()
    a, b = socket.socketpair()
    try:
        b.settimeout(30)
        frame = wire.encode_msg({"op": "ping", "id": 1}, [np.arange(100)])
        a.sendall(frame[: len(frame) // 2])
        a.close()
        with pytest.raises(wire.ProtocolError, match="truncated"):
            wire.recv_msg(b)
    finally:
        b.close()


def test_wire_rejects_hostile_array_specs():
    import json
    import struct

    def frame_with_specs(specs):
        hdr = json.dumps({"op": "x", "id": 1, "arrays": specs}).encode()
        payload = struct.pack("!I", len(hdr)) + hdr
        return wire.MAGIC + struct.pack("!I", len(payload)) + payload

    for specs in ([{"dtype": "bogus", "shape": [3]}], [{"dtype": "int32", "shape": [-4]}],
                  [{"dtype": "object", "shape": [2]}], [{"shape": [2]}],
                  [{"dtype": "int32", "shape": [2**30, 2**30, 2**30]}], "not-a-list"):
        a, b = socket.socketpair()
        try:
            b.settimeout(30)
            a.sendall(frame_with_specs(specs))
            with pytest.raises(wire.ProtocolError):
                wire.recv_msg(b)
        finally:
            a.close(), b.close()


def test_wire_clean_eof_is_connection_error():
    a, b = socket.socketpair()
    a.close()
    try:
        b.settimeout(30)
        with pytest.raises(ConnectionError):
            wire.recv_msg(b)
    finally:
        b.close()


def test_wire_exception_roundtrip():
    e = wire.wire_to_exc(wire.exc_to_wire(KeyError("nosuchprop")))
    assert isinstance(e, KeyError) and "nosuchprop" in str(e)
    e = wire.wire_to_exc({"type": "SomeServerOnlyError", "message": "boom"})
    assert isinstance(e, wire.RemoteError) and "boom" in str(e)


def test_wire_match_result_roundtrip():
    pg = _build(400, 7)
    ref = pg.match(PATTERNS[0])
    meta, arrays = wire.result_to_wire(ref)
    assert all(isinstance(a, wire.PackedMask) for a in arrays)  # packed on their device
    back = wire.wire_to_result(meta, [np.asarray(x) for x in arrays])
    _assert_wire_matches(back, ref)


def test_mask_payload_packs_torch_masks_and_passes_numpy():
    rng = np.random.default_rng(4)
    for n in (0, 1, 31, 32, 33, 1000):
        bits = rng.random(n) > 0.5
        packed = wire._mask_payload(torch.from_numpy(bits))
        assert isinstance(packed, wire.PackedMask) and packed.n == n
        assert packed.words.dtype == np.uint32
        assert wire._pack_array(packed)[1] == wire._pack_array(bits)[1]
        assert _eq(wire._as_bool_mask(packed), bits)
    plain = wire._mask_payload(np.array([True, False]))
    assert isinstance(plain, np.ndarray)
    ints = wire._mask_payload(torch.arange(5, dtype=torch.int32))
    assert isinstance(ints, np.ndarray) and _eq(ints, np.arange(5))


@pytest.mark.parametrize("pattern", [*PATTERNS, "(a:l1)-[:follows*1..3]->(b:l2)"])
def test_frames_are_byte_identical_across_packages(pattern):
    """The same result encodes to the same frame bytes in both packages —
    header, packed masks and bindings."""
    ref_pkg, port_pkg = service_pkg("ref"), service_pkg("port")
    ref_pg, port_pg = ref_pkg.build("arr", 600, 2), port_pkg.build("arr", 600, 2)
    header = {"id": 7, "ok": True}
    frames = []
    for pkg, pg in ((ref_pkg, ref_pg), (port_pkg, port_pg)):
        meta, arrays = pkg.wire.result_to_wire(pg.match(pattern))
        frames.append(pkg.wire.encode_msg({**header, "result": meta}, arrays))
    assert frames[0] == frames[1]
    # and each package decodes the other's frame into the same masks
    a, b = socket.socketpair()
    try:
        b.settimeout(30)
        a.sendall(frames[0])
        hdr, arrays = wire.recv_msg(b)
    finally:
        a.close(), b.close()
    _assert_wire_matches(wire.wire_to_result(hdr["result"], arrays), port_pg.match(pattern))


def test_sample_frames_are_byte_identical_across_packages():
    """Blocks of the same values encode to the same bytes in both packages
    (the draws themselves differ by design: threefry against Philox)."""
    ref_pkg, port_pkg = service_pkg("ref"), service_pkg("port")
    pg = port_pkg.build("arr", 600, 2)
    blocks = pg.sample(as_np(pg.graph.node_map)[:40], [4, 3], seed=3)
    frames = [pkg.wire.encode_msg({"id": 1}, pkg.wire.blocks_to_wire(blocks)[1])
              for pkg in (ref_pkg, port_pkg)]
    assert frames[0] == frames[1]
    meta, arrays = wire.blocks_to_wire(blocks)
    assert_same_blocks(wire.wire_to_blocks(meta, arrays), blocks)


# ----------------------------------------------------------- server/client
@pytest.fixture(scope="module")
def served():
    pg = _build(800, 3)
    svc = Service()
    svc.add_graph("g", pg)
    server = PGServer(svc, port=0, device="cpu").start()
    try:
        yield server, pg
    finally:
        server.close(timeout=10)
        svc.close()


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with Service() as svc:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PGServer(svc, port=0)


def test_net_query_bitwise_equals_match(served):
    server, pg = served
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        assert c.ping()
        assert c.server_info()["devices"] == 1  # a CPU server counts one device
        for p in PATTERNS:
            _assert_wire_matches(c.query("g", p), pg.match(p))


def test_net_pipelined_batch_with_duplicates(served):
    server, pg = served
    burst = list(PATTERNS) + [PATTERNS[0], PATTERNS[2]]
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        got = c.query_batch("g", burst)
    for p, res in zip(burst, got):
        _assert_wire_matches(res, pg.match(p))


def test_net_out_of_order_resolution(served):
    server, pg = served
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        ha = c.submit("g", PATTERNS[0])
        hb = c.submit("g", PATTERNS[1])
        _assert_wire_matches(hb.result(timeout=TIMEOUT), pg.match(PATTERNS[1]))
        _assert_wire_matches(ha.result(timeout=TIMEOUT), pg.match(PATTERNS[0]))


def test_net_errors_fail_alone_and_session_survives(served):
    server, pg = served
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        with pytest.raises(KeyError, match="nosuchprop"):
            c.query("g", "(a {nosuchprop > 1})-[:follows]->(b)")
        with pytest.raises(KeyError, match="unknown graph"):
            c.query("nope", PATTERNS[0])
        with pytest.raises(Exception):  # noqa: B017 — any server-side error
            c._call("no_such_op")
        with pytest.raises(NotImplementedError, match="mesh"):
            c.load_graph("sharded", "unread", mesh=True)
        _assert_wire_matches(c.query("g", PATTERNS[0]), pg.match(PATTERNS[0]))
        assert "plan" in c.explain("g", PATTERNS[0]).lower()
        assert c.stats()["completed"] > 0
        assert c.graphs()["g"] == pg.version


def test_net_mutation_invalidates_and_stays_bitwise():
    pg = _build(500, 11)
    local = _build(500, 11)
    with Service() as svc:
        svc.add_graph("g", pg)
        server = PGServer(svc, port=0, device="cpu").start()
        try:
            with PGClient(port=server.port, timeout=TIMEOUT) as c:
                c.query("g", PATTERNS[0])
                nodes = as_np(local.graph.node_map)
                v = c.add_node_labels("g", nodes[:9], ["l1"] * 9)
                local.add_node_labels(nodes[:9], ["l1"] * 9)
                assert v == local.version
                _assert_wire_matches(c.query("g", PATTERNS[0]), local.match(PATTERNS[0]))
                assert c.stats().get("invalidated_results", 0) >= 1
                c.add_node_properties("g", "age", nodes[:5], np.full(5, 99, np.int32))
                local.add_node_properties("age", nodes[:5], np.full(5, 99, np.int32))
                _assert_wire_matches(c.query("g", PATTERNS[1]), local.match(PATTERNS[1]))
                c.insert_edges("g", nodes[:6], nodes[-6:])
                local.insert_edges(nodes[:6], nodes[-6:])
                c.delete_vertices("g", nodes[6:8])
                local.delete_vertices(nodes[6:8])
                c.update_node_properties("g", "age", nodes[:4], [1, 2, 3, 4])
                local.update_node_properties("age", nodes[:4], [1, 2, 3, 4])
                for p in PATTERNS:
                    _assert_wire_matches(c.query("g", p), local.match(p))
                snap = c.snapshot("g")
                fork = c.fork_view("g")
                c.delete_edges(fork, nodes[:2], nodes[-2:])
                assert c.compact("g")["delta_edges"] > 0
                local.compact()
                _assert_wire_matches(c.query("g", PATTERNS[0]), local.match(PATTERNS[0]))
                c.drop_view(fork)
                c.drop_view(snap)
                assert set(c.graphs()) == {"g"}
        finally:
            server.close(timeout=10)


def test_net_load_graph_cross_backend(served, tmp_path):
    from repro_torch.core.io import save_propgraph

    server, pg = served
    path = save_propgraph(str(tmp_path / "pg"), pg)
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        info = c.load_graph("disk", path, backend="listd")
        assert info["backend"] == "listd"
        assert info["n"] == pg.n_vertices and info["m"] == pg.n_edges
        _assert_wire_matches(c.query("disk", PATTERNS[0]), pg.match(PATTERNS[0]))


def test_net_sample_and_analytics(served):
    server, pg = served
    nodes = as_np(pg.graph.node_map)
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        assert_same_blocks(c.sample("g", nodes[:48], [4, 3], seed=7),
                           pg.sample(nodes[:48], [4, 3], seed=7))
        assert_same_blocks(c.sample("g", "(a:l0)", [4], pattern="(a)-[:follows]->(b)", seed=3),
                           pg.sample("(a:l0)", [4], pattern="(a)-[:follows]->(b)", seed=3))
        hs = [c.submit_sample("g", nodes[8 * i:8 * i + 24], [3], seed=i) for i in range(6)]
        for i, h in enumerate(hs):
            assert_same_blocks(h.result(timeout=TIMEOUT),
                               pg.sample(nodes[8 * i:8 * i + 24], [3], seed=i))
        seeds = nodes[:4]
        assert np.array_equal(c.shortest_paths("g", seeds, weight="w"),
                              as_np(pg.shortest_paths(seeds, weight="w")))
        assert np.array_equal(c.pagerank("g"), as_np(pg.pagerank()))
        assert np.array_equal(c.communities("g"), as_np(pg.communities()))


def test_net_concurrent_client_connections(served):
    server, pg = served
    refs = {p: pg.match(p) for p in PATTERNS}
    errors = []

    def one_client():
        try:
            with PGClient(port=server.port, timeout=TIMEOUT) as c:
                for p in PATTERNS:
                    _assert_wire_matches(c.query("g", p), refs[p])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=one_client) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors and not any(t.is_alive() for t in threads)


def test_net_graceful_drain_completes_inflight_without_waiting_for_itself():
    """In-flight queries finish, no new connection is accepted, and the
    drain verb answers at once: its own frame is not in flight for it (the
    reference's server waits out its 30 s timeout for it, ROADMAP C.19)."""
    pg = _build(500, 13)
    svc = Service()
    svc.add_graph("g", pg)
    server = PGServer(svc, port=0, device="cpu").start()
    try:
        with PGClient(port=server.port, timeout=TIMEOUT) as c:
            handles = [c.submit("g", p) for p in PATTERNS]
            t0 = time.monotonic()
            c.drain()
            assert time.monotonic() - t0 < 10.0
            for h, p in zip(handles, PATTERNS):
                _assert_wire_matches(h.result(timeout=TIMEOUT), pg.match(p))
            with pytest.raises(OSError):
                PGClient(port=server.port, connect_timeout=2).ping()
    finally:
        server.close(timeout=10)
        svc.close()


# ------------------------------------------------ across the two packages
def _ref_served():
    pkg = service_pkg("ref")
    pg = pkg.build("arr", 600, 5)
    svc = pkg.Service()
    svc.add_graph("g", pg)
    return pkg, pg, svc, pkg.server(svc).start()


def test_reference_client_against_the_port_server():
    ref_pkg = service_pkg("ref")
    ref_pg = ref_pkg.build("arr", 600, 5)
    pg = _build(600, 5)
    svc = Service()
    svc.add_graph("g", pg)
    server = PGServer(svc, port=0, device="cpu").start()
    try:
        with ref_pkg.PGClient(port=server.port, timeout=TIMEOUT) as c:
            assert c.ping()
            for p in PATTERNS:
                got = c.query("g", p)
                _assert_wire_matches(got, pg.match(p))
                _assert_wire_matches(got, ref_pg.match(p))
            burst = c.query_batch("g", list(PATTERNS) * 2)
            for p, res in zip(list(PATTERNS) * 2, burst):
                _assert_wire_matches(res, ref_pg.match(p))
            nodes = as_np(pg.graph.node_map)
            assert_same_blocks(c.sample("g", nodes[:32], [4], seed=2),
                               pg.sample(nodes[:32], [4], seed=2))
            assert np.array_equal(c.communities("g"), as_np(ref_pg.communities()))
            h = c.submit("g", PATTERNS[1])
            h.result(timeout=TIMEOUT)
            assert h.trace["trace_id"] == h.trace_id
            ref_pkg.obs.parse_prometheus(c.metrics())
    finally:
        server.close(timeout=10)
        svc.close()


def test_port_client_against_the_reference_server():
    pkg, ref_pg, svc, server = _ref_served()
    pg = _build(600, 5)
    try:
        with PGClient(port=server.port, timeout=TIMEOUT) as c:
            assert c.ping()
            for p in PATTERNS:
                got = c.query("g", p)
                _assert_wire_matches(got, ref_pg.match(p))
                _assert_wire_matches(got, pg.match(p))
            burst = c.query_batch("g", list(PATTERNS) + [PATTERNS[0]])
            for p, res in zip(list(PATTERNS) + [PATTERNS[0]], burst):
                _assert_wire_matches(res, pg.match(p))
            nodes = as_np(pg.graph.node_map)
            assert np.array_equal(c.shortest_paths("g", nodes[:3], weight="w"),
                                  as_np(pg.shortest_paths(nodes[:3], weight="w")))
            blocks = c.sample("g", nodes[:32], [4], seed=2)
            assert_same_blocks(blocks, ref_pg.sample(nodes[:32], [4], seed=2))
            st = c.stats()
            assert st["completed"] > 0
    finally:
        server.close(timeout=10)
        svc.close()


# ------------------------------------------------------- adaptive batching
def _collecting_batcher(**kw):
    batches, done = [], threading.Event()

    def execute(batch):
        batches.append(list(batch))
        done.set()

    return MicroBatcher(execute, **kw), batches, done


def test_adaptive_window_skips_wait_when_idle():
    b, batches, done = _collecting_batcher(window_ms=5_000.0, adaptive=True)
    try:
        t0 = time.monotonic()
        b.submit("r1")
        assert done.wait(timeout=2.0), "request stuck behind the window"
        assert time.monotonic() - t0 < 2.0
        assert batches[0] == ["r1"]
    finally:
        b.close(timeout=1.0)


def test_window_opens_under_queue_pressure():
    gate = threading.Event()
    batches = []

    def execute(batch):
        batches.append(list(batch))
        gate.wait(timeout=5.0)

    b = MicroBatcher(execute, window_ms=200.0, adaptive=True, max_batch=8)
    try:
        b.submit("first")
        time.sleep(0.05)
        for i in range(5):
            b.submit(f"r{i}")
        gate.set()
        b.close(timeout=5.0)
        assert batches[0] == ["first"]
        assert [f"r{i}" for i in range(5)] in batches
    finally:
        gate.set()
        b.close(timeout=1.0)


def test_window_ms_zero_stays_live():
    b, batches, _ = _collecting_batcher(window_ms=0.0, adaptive=False)
    try:
        for i in range(16):
            b.submit(i)
        b.close(timeout=5.0)
        assert sorted(x for batch in batches for x in batch) == list(range(16))
    finally:
        b.close(timeout=1.0)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(99)
    with pytest.raises(ValueError):
        MicroBatcher(lambda batch: None, max_batch=0)


def test_service_window_ms_zero_end_to_end():
    pg = _build(400, 5)
    with Service(config=ServiceConfig(window_ms=0.0)) as svc:
        svc.add_graph("g", pg)
        futs = [svc.submit("g", p) for p in PATTERNS]
        for f, p in zip(futs, PATTERNS):
            assert _eq(f.result(timeout=TIMEOUT).vertex_mask, pg.match(p).vertex_mask)


def test_fixed_window_config_still_available():
    pg = _build(400, 5)
    with Service(config=ServiceConfig(adaptive_window=False, window_ms=1.0)) as svc:
        svc.add_graph("g", pg)
        got = svc.query("g", PATTERNS[0], timeout=TIMEOUT)
        assert _eq(got.vertex_mask, pg.match(PATTERNS[0]).vertex_mask)


# ------------------------------------------------------------ observability
def test_net_trace_id_roundtrip(served):
    server, pg = served
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        h = c.submit("g", PATTERNS[0])
        res = h.result(timeout=TIMEOUT)
        assert h.trace_id and h.trace is not None
        assert h.trace["trace_id"] == h.trace_id
        names = [s["name"] for s in h.trace["spans"]]
        assert "serialize" in names and ("parse" in names or "cache" in names), names
        assert c.last_trace is h.trace
        _assert_wire_matches(res, pg.match(PATTERNS[0]))


def test_net_trace_opt_out(served):
    server, _ = served
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        c.trace = False
        h = c.submit("g", PATTERNS[1])
        h.result(timeout=TIMEOUT)
        assert h.trace_id is None and h.trace is None


def test_net_slow_query_ring_captures_client_trace():
    pg = _build(400, 7)
    svc = Service(config=ServiceConfig(slow_query_ms=0.0))
    svc.add_graph("g", pg)
    server = PGServer(svc, port=0, device="cpu").start()
    try:
        with PGClient(port=server.port, timeout=TIMEOUT) as c:
            hs = [c.submit("g", p) for p in PATTERNS]
            for h in hs:
                h.result(timeout=TIMEOUT)
            payload = c.traces()
            slow_ids = {t["trace_id"] for t in payload["slow"]}
            assert {h.trace_id for h in hs} <= slow_ids
            assert {t["trace_id"] for t in payload["traces"]} >= slow_ids
    finally:
        server.close(timeout=10)
        svc.close()


def test_net_metrics_verb_parses_and_counts(served):
    from repro_torch.obs import parse_prometheus

    server, _ = served
    with PGClient(port=server.port, timeout=TIMEOUT) as c:
        m1 = parse_prometheus(c.metrics())
        for p in PATTERNS:
            c.query("g", p)
        m2 = parse_prometheus(c.metrics())
        st = c.stats()
    assert m2["pg_service_submitted_total"] == m1["pg_service_submitted_total"] + len(PATTERNS)
    assert m2["pg_service_submitted_total"] == st["submitted"]
    assert m2["pg_service_completed_total"] == st["completed"]
    assert any(k.startswith("pg_wire_bytes") for k in m2)


# ------------------------------------------------------------ cross-process
def test_cross_process_net_roundtrip():
    """A real second OS process: the serve-mode CLI on the CPU, queried over
    TCP and compared bitwise with this process's match()."""
    from repro_torch.launch.pgserve import spawn_server

    pg = _build(400, 0)
    proc, port = spawn_server(["--backends", "arr", "--m", "400", "--seed", "0",
                               "--device", "cpu"], timeout=TIMEOUT)
    try:
        with PGClient(port=port, timeout=TIMEOUT) as c:
            for p in PATTERNS[:2]:
                _assert_wire_matches(c.query("arr", p), pg.match(p))
            nodes = as_np(pg.graph.node_map)
            assert_same_blocks(c.sample("arr", nodes[:24], [3], seed=1),
                               pg.sample(nodes[:24], [3], seed=1))
            t0 = time.monotonic()
            c.shutdown()
            assert time.monotonic() - t0 < 10.0
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.pgserve", *args],
                          capture_output=True, text=True, env=env, timeout=300)
    return proc


@pytest.mark.parametrize("mode,ok_line", [(("--smoke",), "PGSERVE SMOKE OK"),
                                          (("--net", "--smoke"), "PGSERVE NET SMOKE OK")])
def test_cli_smoke_gates_pass_on_the_cpu(mode, ok_line):
    proc = _cli(*mode, "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == ok_line
    assert "skipped (1 device" in proc.stdout  # the mesh checks wait for A10
