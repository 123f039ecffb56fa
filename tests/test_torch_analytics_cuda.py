"""The frontier and semiring engine on the card against the same calls on
the CPU (whose answers the CPU parity tests hold to the reference package):
every semiring's relax, k-hop on both impls, components, shortest paths,
PageRank and communities at a few thousand edges, odd inputs included
(NaN, -inf and negative-cycle weights, seed ids outside [0, n), a graph
without edges).  Bitwise, but PageRank within ``PR_ATOL``: ``index_add_``
on the card sums in another order.  Needs an NVIDIA card (marker ``cuda``;
skips without one); imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_analytics_cuda.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import fixed_shape_edges, ingest, raw_inputs
from repro_torch import traverse as pt
from repro_torch.core import PropGraph
from repro_torch.core.di import DIGraph, build_di

PR_ATOL = 1e-6  # ranks ~1/n summed in another order: a few f32 ulp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this holds the card's answers to the CPU's")
    return torch.device("cuda")


def same(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(a, b) if not a.is_floating_point()
                     else ((a == b) | (a.isnan() & b.isnan())).all()))


def graphs(cuda, seed: int):
    raw = raw_inputs(seed, n_pool=2000, m=5000)
    return ingest(PropGraph(device=cuda), raw), ingest(PropGraph(device="cpu"), raw)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_propgraph_analytics_on_card_equal_cpu(cuda, seed):
    gpu, cpu = graphs(cuda, seed)
    seeds = cpu.graph.node_map.numpy()[:: 97]
    for pattern in (None, "(a)-[:likes|knows]->(b)", "(a:mid)-[:follows {w < 0.6}]->(b)",
                    "(a)<-[:likes]-(b:common)", "(v:mid|common {age > 10})"):
        for k in (1, 3):
            for impl in (None, "csr"):
                for und in (False, True):
                    assert same(gpu.khop(seeds, k, pattern=pattern, impl=impl, undirected=und),
                                cpu.khop(seeds, k, pattern=pattern, impl=impl, undirected=und))
        assert same(gpu.components(pattern), cpu.components(pattern))
        assert same(gpu.communities(pattern), cpu.communities(pattern))
        for kw in ({}, {"weight": "w"}, {"weight": "w", "undirected": True}, {"max_iters": 3}):
            assert same(gpu.shortest_paths(seeds, pattern=pattern, **kw),
                        cpu.shortest_paths(seeds, pattern=pattern, **kw)), (pattern, kw)
        for kw in ({}, {"weight": "w"}):
            got = gpu.pagerank(pattern=pattern, **kw).cpu()
            want = cpu.pagerank(pattern=pattern, **kw)
            assert torch.allclose(got, want, rtol=0, atol=PR_ATOL), (pattern, kw)


def _di(cuda, seed, n=300, m=3000):
    src, dst = fixed_shape_edges(seed, n, m)
    return build_di(src, dst, device=cuda), build_di(src, dst, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("sr", ["boolean", "tropical", "counting", "minlabel"])
def test_relax_on_card_equals_cpu(cuda, sr):
    gg, gc = _di(cuda, 3)
    gen = np.random.default_rng(7)
    if sr in ("boolean", "minlabel"):
        x = (gen.random(gc.n) < 0.3 if sr == "boolean"
             else gen.integers(0, gc.n, gc.n).astype(np.int32))
        ev = gen.random(gc.m) < 0.7
    else:
        x = gen.uniform(0, 3, gc.n).astype(np.float32)
        ev = gen.uniform(0.5, 2, gc.m).astype(np.float32)
        if sr == "tropical":  # unreachable tails, masked edges, NaN and -inf weights
            x[:: 5] = np.inf
            ev[:: 7] = np.inf
            ev[3:: 101] = np.nan
            ev[5:: 103] = -np.inf
    xc, ec = torch.from_numpy(x), torch.from_numpy(ev)
    psr = getattr(pt, sr.upper())
    for kw in ({}, {"direction": -1}, {"undirected": True}):
        got = pt.semiring_relax(gg, xc.to(cuda), ec.to(cuda), psr, **kw)
        want = pt.semiring_relax(gc, xc, ec, psr, **kw)
        if sr == "counting":
            assert torch.allclose(got.cpu(), want, rtol=1e-6, atol=1e-6)
        else:
            assert same(got, want), kw
    if sr == "tropical":
        assert want.isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("odd", [float("nan"), float("-inf"), -5.0, float("inf")])
def test_shortest_paths_odd_weights_on_card(cuda, odd):
    gg, gc = _di(cuda, 4)
    gen = np.random.default_rng(8)
    w = gen.uniform(0.5, 2, gc.m).astype(np.float32)
    w[gen.choice(gc.m, 20, replace=False)] = odd
    wc = torch.from_numpy(w)
    sc = torch.from_numpy(gen.random(gc.n) < 0.02)
    ec = torch.from_numpy(gen.random(gc.m) < 0.8)
    for und in (False, True):
        for mi in (4, 40):
            got = pt.shortest_paths_masked(gg, sc.to(cuda), wc.to(cuda), ec.to(cuda),
                                           undirected=und, max_iters=mi)
            want = pt.shortest_paths_masked(gc, sc, wc, ec, undirected=und, max_iters=mi)
            assert same(got, want), (odd, und, mi)


@pytest.mark.cuda
def test_khop_csr_odd_seed_ids_on_card(cuda):
    gg, gc = _di(cuda, 5)
    n = gc.n
    for ids in ([n], [n + 5], [-1], [-n - 2], [-n], [-n - 1], [0, -1, 7, 7], [2**31 - 1]):
        for k in (1, 3):
            assert same(pt.khop_csr(gg, ids, None, k=k), pt.khop_csr(gc, ids, None, k=k)), ids


@pytest.mark.cuda
def test_graph_without_edges_on_card(cuda):
    def empty(dev):
        return DIGraph(src=torch.zeros(0, dtype=torch.int32, device=dev),
                       dst=torch.zeros(0, dtype=torch.int32, device=dev),
                       seg=torch.zeros(4, dtype=torch.int32, device=dev),
                       node_map=torch.arange(3, dtype=torch.int32, device=dev),
                       n=3, m=0, max_deg=0)

    gg, gc = empty(cuda), empty("cpu")
    sc = torch.tensor([True, False, False])
    assert same(pt.components_masked(gg), pt.components_masked(gc))
    assert same(pt.label_propagation_masked(gg), pt.label_propagation_masked(gc))
    assert same(pt.shortest_paths_masked(gg, sc.to(cuda)), pt.shortest_paths_masked(gc, sc))
    assert same(pt.khop_csr(gg, [1, -1], k=2), pt.khop_csr(gc, [1, -1], k=2))
    assert torch.allclose(pt.pagerank_masked(gg).cpu(), pt.pagerank_masked(gc), atol=PR_ATOL)
