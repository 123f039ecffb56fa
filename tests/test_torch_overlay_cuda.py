"""The overlay on the card against the port on the CPU (skipped without a
card): the same small stream into a graph on each device, then every
request kind, k-hop (both impls), components, the counts, sampling over the
re-sorted view on the card's priorities, and compaction — bitwise."""
import numpy as np
import pytest
import torch

from _torch_parity import (
    OV_PATTERNS,
    as_np,
    assert_same_match,
    fixed_shape_edges,
    overlay_stream,
)

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")]


def _pair(seed, backend):
    from repro_torch.core import PropGraph

    rng = np.random.default_rng(seed + 2000)
    src, dst = fixed_shape_edges(seed, 40, 160)
    graphs = []
    for device in ("cuda", "cpu"):
        pg = PropGraph(backend=backend, device=device).add_edges_from(src, dst)
        graphs.append(pg)
    nodes = as_np(graphs[1].graph.node_map)
    es, ed = as_np(graphs[1].graph.src), as_np(graphs[1].graph.dst)
    lab = rng.choice(["l1", "l2", "l3"], size=len(nodes))
    rel = rng.choice(["follows", "likes"], size=len(es), p=[0.7, 0.3])
    age, w = rng.integers(0, 60, len(nodes)), rng.random(len(es))
    for pg in graphs:
        pg.add_node_labels(nodes, lab)
        pg.add_edge_relationships(nodes[es], nodes[ed], rel)
        pg.add_node_properties("age", nodes, age)
        pg.add_edge_properties("w", nodes[es], nodes[ed], w)
        pg.match(OV_PATTERNS[0][1])
    meta = {"nodes": nodes, "src": nodes[es], "dst": nodes[ed]}
    return graphs[0], graphs[1], meta


@pytest.mark.parametrize("backend", ["arr", "list", "listd"])
def test_overlay_on_the_card_equals_the_cpu(backend):
    from repro_torch.kernels.neighbor_sample import ops

    card, cpu, meta = _pair(3, backend)
    for step in overlay_stream(3, meta):
        if step[0] == "snapshot":
            continue
        if step[0] == "fork":
            card, cpu = card.fork(), cpu.fork()
            continue
        for pg in (card, cpu):
            getattr(pg, step[0])(*step[1])
        for _, text in OV_PATTERNS:
            assert_same_match(cpu.match(text), card.match(text))
    assert card.label_counts() == cpu.label_counts()
    assert card.relationship_counts() == cpu.relationship_counts()
    seeds = meta["nodes"][:6]
    for impl in ("frontier", "csr"):
        assert card.khop(seeds, 3, impl=impl).cpu().equal(cpu.khop(seeds, 3, impl=impl))
    assert card.components("(a)-[:follows]->(b)").cpu().equal(cpu.components("(a)-[:follows]->(b)"))
    for got, want in zip(card._sampling_view(), cpu._sampling_view()):
        assert (got.cpu().equal(want) if torch.is_tensor(want) else got == want)
    draws = []
    saved = ops._draw_priorities

    def record(key, shape, device):
        u = saved(key, shape, device)
        draws.append(u)
        return u

    ops._draw_priorities = record
    try:
        blocks = card.sample("(a:l2|zz)", [3, 2], seed=1)
    finally:
        ops._draw_priorities = saved
    it = iter(draws)
    ops._draw_priorities = lambda key, shape, device: next(it).to(device)
    try:
        want = cpu.sample("(a:l2|zz)", [3, 2], seed=1)
    finally:
        ops._draw_priorities = saved
    for bg, bw in zip(blocks, want):
        for f in ("src_nodes", "dst_nodes", "edge_src", "edge_dst", "edge_mask"):
            assert np.array_equal(getattr(bg, f), getattr(bw, f)), f
    card.compact()
    cpu.compact()
    if backend == "arr":
        a, b = card.to_arrays(), cpu.to_arrays()
        for s in ("vstore", "estore"):
            assert np.array_equal(a[s]["bitmap"], b[s]["bitmap"])
    for _, text in OV_PATTERNS:
        assert_same_match(cpu.match(text), card.match(text))
