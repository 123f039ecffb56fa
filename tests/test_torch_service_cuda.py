"""The service and wire layer on the card against the port on the CPU
(skipped without a card): coalesced answers through B1 equal the CPU
service's bitwise, coalesced samples through B3 equal the card's solo
``sample`` bitwise (the card and the CPU draw different priorities), wire
frames of card results equal the CPU's byte for byte, and a server on the
card answers a client bitwise."""
import numpy as np
import pytest
import torch

from _torch_parity import SERVE_PATTERNS, as_np, assert_same_blocks, assert_same_match

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")]

TIMEOUT = 120
STREAM = [*SERVE_PATTERNS, SERVE_PATTERNS[0], "(a:l1)-[:follows*1..3]->(b:l2)"]


def _pair(backend, m=2000, seed=3):
    from repro_torch.launch.pgserve import build_tenant_graph

    return (build_tenant_graph(backend, m, seed=seed, device="cuda"),
            build_tenant_graph(backend, m, seed=seed, device="cpu"))


@pytest.mark.parametrize("backend", ["arr", "list", "listd"])
def test_coalesced_answers_on_the_card_equal_the_cpu(backend):
    from repro_torch.kernels.bitmap_query import ops
    from repro_torch.service import Service

    card, cpu = _pair(backend)
    answers = []
    for pg in (card, cpu):
        with Service() as svc:
            svc.add_graph("g", pg)
            ops.reset_launches()
            answers.append(svc.query_batch("g", STREAM))
            futs = [svc.submit("g", p) for p in STREAM]
            answers.append([f.result(timeout=TIMEOUT) for f in futs])
            if pg is card and backend == "arr":
                assert ops.launches[ops.PACKED] > 0
    for a, b in zip(answers[0] + answers[1], answers[2] + answers[3]):
        assert_same_match(b, a)


def test_coalesced_samples_on_the_card_equal_solo_samples():
    from repro_torch.kernels.neighbor_sample import ops
    from repro_torch.service import Service

    card, _ = _pair("arr")
    nodes = as_np(card.graph.node_map)
    card.match(SERVE_PATTERNS[0])
    card.insert_edges(nodes[:30], nodes[-30:])
    card.delete_vertices(nodes[30:40])
    specs = [(nodes[20 * i:20 * i + 100], i) for i in range(9)]
    with Service() as svc:
        svc.add_graph("g", card)
        ops.reset_launches()
        got = svc.sample_batch("g", specs, [5, 3])
        assert ops.launches[ops.WINDOW_SELECT] > 0
        filt = svc.sample_batch("g", specs, [5, 3], pattern="(a)-[:follows]->(b)")
    for (s, sv), a, b in zip(specs, got, filt):
        assert_same_blocks(a, card.sample(s, [5, 3], seed=sv))
        assert_same_blocks(b, card.sample(s, [5, 3], seed=sv, pattern="(a)-[:follows]->(b)"))


def test_wire_frames_and_server_on_the_card():
    from repro_torch.service import PGClient, PGServer, Service, wire

    card, cpu = _pair("arr")
    for p in SERVE_PATTERNS:
        frames = [wire.encode_msg({"id": 1}, wire.result_to_wire(pg.match(p))[1])
                  for pg in (card, cpu)]
        assert frames[0] == frames[1]
    with Service() as svc:
        svc.add_graph("g", card)
        server = PGServer(svc, port=0).start()
        try:
            assert server.device.type == "cuda"
            with PGClient(port=server.port, timeout=TIMEOUT) as c:
                assert c.server_info()["devices"] == torch.cuda.device_count()
                for p, res in zip(STREAM, c.query_batch("g", STREAM)):
                    for name in ("vertex_mask", "edge_mask"):
                        assert np.array_equal(as_np(getattr(res, name)),
                                              as_np(getattr(cpu.match(p), name)))
        finally:
            server.close(timeout=10)


def test_explain_analyze_on_the_card():
    card, cpu = _pair("arr")
    got, rep = card.match(SERVE_PATTERNS[0], profile=True)
    assert_same_match(cpu.match(SERVE_PATTERNS[0]), got)
    assert rep.total_first_ms >= rep.steady_ms >= 0
    again = card.explain_analyze(SERVE_PATTERNS[0])
    assert again.total_first_ms >= again.steady_ms >= 0
    assert again.cold == (again.compile_ms > 0)
