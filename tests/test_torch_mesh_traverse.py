"""The port's sharded traversal and analytics against the reference on one device.

The counterparts of the reference's eight-device subprocess checks in
``tests/test_traverse.py`` (var-length ``match``, k-hop, components),
``tests/test_semiring.py`` (shortest paths, PageRank, communities, the
relax) and ``tests/test_sample.py`` (sampling on a mesh), run in process
on entity meshes of CPU shards.  The min/max instances and every integer
answer are bitwise; PageRank and the counting relax sum their shards'
partials in shard order and agree within ``PR_ATOL``.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.traverse as rt
import repro_torch.traverse as pt
from _torch_parity import analytics_pair, as_np, fixed_shape_edges
from repro.core import PropGraph as RefPG
from repro.core.di import build_di as ref_build_di
from repro.graph import sampler as ref_sampler
from repro.launch import pgserve as ref_pgserve
from repro_torch.core import PropGraph, bitplane
from repro_torch.core.di import build_di as port_build_di
from repro_torch.graph import sampler
from repro_torch.kernels.neighbor_sample import ops as ns_ops
from repro_torch.launch import pgserve
from repro_torch.launch.mesh import make_entity_mesh

BACKENDS = ("arr", "list", "listd")
PR_ATOL = 1e-6  # tests/test_torch_service.py's PageRank tolerance
FIELDS = ("src_nodes", "dst_nodes", "edge_src", "edge_dst", "edge_mask")


def cpu_mesh(p: int):
    return make_entity_mesh(devices=["cpu"] * p)


def same(a, b) -> bool:
    """Equal shape, dtype and values; NaNs equal NaNs where they stand."""
    a, b = as_np(a), as_np(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


def close(a, b) -> bool:
    a, b = as_np(a), as_np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.allclose(a, b, rtol=0, atol=PR_ATOL)


@lru_cache(maxsize=None)
def traverse_pair(backend: str, p: int):
    """``tests/test_traverse.py``'s sharded graph: 300 edges over 60 ids,
    x/y/z labels, r/s relationships — the reference on one device, the port
    on a P-shard mesh."""
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, 60, 300), rng.integers(0, 60, 300)
    ref = RefPG(backend=backend).add_edges_from(src, dst)
    port = PropGraph(backend=backend, mesh=cpu_mesh(p)).add_edges_from(src, dst)
    nodes = np.asarray(ref.graph.node_map)
    es, ed = np.asarray(ref.graph.src), np.asarray(ref.graph.dst)
    labels = rng.choice(["x", "y", "z"], size=len(nodes))
    rels = rng.choice(["r", "s"], size=len(es))
    for pg in (ref, port):
        pg.add_node_labels(nodes, labels)
        pg.add_edge_relationships(nodes[es], nodes[ed], rels)
    return ref, port


@lru_cache(maxsize=None)
def analytics_mesh_pair(seed: int, p: int):
    """``analytics_pair``'s graph (x/y/z, r/s, an f32 ``w``): the reference
    on one device and the port rebuilt on a P-shard mesh."""
    ref, _, meta = analytics_pair(seed, n=40, m=160)
    src, dst = fixed_shape_edges(seed, 40, 160)
    port = PropGraph(backend="arr", mesh=cpu_mesh(p)).add_edges_from(src, dst)
    nodes, es, ed = meta["nodes"], meta["es"], meta["ed"]
    port.add_node_labels(nodes, meta["labels"])
    port.add_edge_relationships(nodes[es], nodes[ed], meta["rels"])
    port.add_edge_properties("w", nodes[es], nodes[ed], meta["w"])
    return ref, port, meta


# --------------------------------------------------------------- the relax
def test_semiring_allreduce_names_match_the_reference():
    for a, b in ((pt.BOOLEAN, rt.BOOLEAN), (pt.TROPICAL, rt.TROPICAL),
                 (pt.COUNTING, rt.COUNTING), (pt.MINLABEL, rt.MINLABEL)):
        assert "p" + a.allreduce == b.allreduce  # max/min/sum ↔ pmax/pmin/psum


def _relax_inputs(sr_name: str, seed: int, n: int, m: int):
    rng = np.random.default_rng(seed)
    if sr_name == "boolean":
        return rng.random(n) < 0.4, rng.random(m) < 0.7
    if sr_name == "minlabel":
        x = rng.integers(0, n, n).astype(np.int32)
        x[rng.random(n) < 0.3] = np.iinfo(np.int32).max
        return x, rng.random(m) < 0.7
    x = rng.uniform(0, 3, n).astype(np.float32)
    if sr_name == "tropical":
        x[rng.random(n) < 0.3] = np.inf
        return x, np.where(rng.random(m) < 0.7, rng.uniform(0.5, 2, m), np.inf).astype(np.float32)
    return x, np.where(rng.random(m) < 0.7, rng.uniform(0.5, 2, m), 0).astype(np.float32)


@pytest.mark.parametrize("p", (3, 8))
@pytest.mark.parametrize("direction,undirected", [(1, False), (-1, False), (1, True)])
@pytest.mark.parametrize("sr", ["boolean", "tropical", "counting", "minlabel"])
def test_relax_sharded_matches_reference(sr, direction, undirected, p):
    """One sharded relax (pad edges carry the absorber; P = 3 pads 81 edges
    to 81, P = 8 to 88) against the reference's single-device relax."""
    src, dst = fixed_shape_edges(3, 24, 81)
    rg, pg = ref_build_di(src, dst), port_build_di(src, dst, device="cpu")
    x, ev = _relax_inputs(sr, 5, rg.n, rg.m)
    want = rt.semiring_relax(rg, jnp.asarray(x), jnp.asarray(ev), getattr(rt, sr.upper()),
                             direction=direction, undirected=undirected)
    got = pt.semiring_relax_sharded(pg, torch.from_numpy(x), torch.from_numpy(ev),
                                    getattr(pt, sr.upper()), mesh=cpu_mesh(p),
                                    direction=direction, undirected=undirected)
    assert (close if sr == "counting" else same)(got, want)


@pytest.mark.parametrize("p", (2, 6))
def test_reach_closure_sharded_matches_reference(p):
    src, dst = fixed_shape_edges(9, 40, 120)
    rg, pg = ref_build_di(src, dst), port_build_di(src, dst, device="cpu")
    rng = np.random.default_rng(p)
    seeds = rng.random(rg.n) < 0.1
    e_ok = rng.random(rg.m) < 0.6
    for direction, undirected in ((1, False), (-1, False), (1, True)):
        want = rt.reach_closure(rg, jnp.asarray(seeds), jnp.asarray(e_ok),
                                direction=direction, undirected=undirected)
        got = pt.reach_closure_sharded(pg, torch.from_numpy(seeds), torch.from_numpy(e_ok),
                                       mesh=cpu_mesh(p), direction=direction,
                                       undirected=undirected)
        assert same(got, want), (direction, undirected)


# ---------------------------------------------------- k-hop and var-length
@pytest.mark.parametrize("exchange", ["packed", "byte"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_khop_and_components_equal_reference(backend, exchange):
    """k-hop with the packed (OR all-reduce of words) and the byte (max
    all-reduce) exchange, k-hop on a reversed and an undirected walk, the
    csr impl (which degrades on a mesh), and components."""
    ref, port = traverse_pair(backend, 8)
    seeds = np.asarray(ref.graph.node_map)[:3]
    pat = "(a)-[:r]->(b)"
    with bitplane.byte_masks(exchange == "byte"):
        assert same(port.khop(seeds, 3, pattern=pat), ref.khop(seeds, 3, pattern=pat))
        assert same(port.khop(seeds, 2, pattern="(a:x|y)<-[:s]-(b)"),
                    ref.khop(seeds, 2, pattern="(a:x|y)<-[:s]-(b)"))
        assert same(port.khop(seeds, 2, undirected=True), ref.khop(seeds, 2, undirected=True))
        assert same(port.khop(seeds, 3, pattern=pat, impl="csr"),
                    ref.khop(seeds, 3, pattern=pat))
    assert same(port.components(pat), ref.components(pat))


@pytest.mark.parametrize("pattern", ["(a:x)-[:r*1..3]->(b:y)", "(a:x)-[v:r*]->(b:y|z)"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_var_length_match_equals_reference(backend, pattern):
    ref, port = traverse_pair(backend, 3)
    r1, r2 = ref.match(pattern), port.match(pattern)
    assert same(r1.vertex_mask, r2.vertex_mask) and same(r1.edge_mask, r2.edge_mask)
    for a, b in zip(r1.node_masks, r2.node_masks):
        assert same(a, b)


# ------------------------------------------------------------ the analytics
@pytest.mark.parametrize("p", (3, 8))
def test_weighted_analytics_equal_reference(p):
    """Shortest paths bitwise (the min all-reduce is exact), PageRank within
    PR_ATOL (the sum reassociates), components and communities bitwise
    (they run on the lead device)."""
    ref, port, meta = analytics_mesh_pair(11, p)
    seeds = meta["nodes"][:4]
    for kw in ({"weight": "w"}, {"weight": "w", "pattern": "(a)-[:r]->(b)"},
               {"weight": "w", "undirected": True}, {"pattern": "(a:x|y)<-[:s]-(b)"},
               {"weight": "w", "max_iters": 2}):
        want = ref.shortest_paths(seeds, **kw)
        assert same(port.shortest_paths(seeds, **kw), want), kw
    d = as_np(port.shortest_paths(seeds, weight="w", pattern="(a)-[:r]->(b)"))
    assert np.isfinite(d).any() and np.isinf(d).any()
    for kw in ({"weight": "w"}, {}, {"pattern": "(a:x)-[:r]->(b:y|z)"},
               {"pattern": "(a:x|y)", "weight": "w"}):
        assert close(port.pagerank(**kw), ref.pagerank(**kw)), kw
    for pat in (None, "(a)-[:r|s]->(b)", "(a:x|y)-[:r]->(b:x|y)"):
        assert same(port.components(pat), ref.components(pat)), pat
        assert same(port.communities(pat), ref.communities(pat)), pat


@pytest.mark.parametrize("p", (1, 2, 4, 6))
def test_every_traversal_surface_over_the_p_sweep(p):
    """The rest of P in {1, 2, 3, 4, 6, 8} (3 and 8 above): var-length
    ``match``, k-hop with both exchanges, shortest paths, PageRank,
    components and communities against the reference on one device."""
    ref, port, meta = analytics_mesh_pair(11, p)
    seeds = meta["nodes"][:4]
    for pat in ("(a:x)-[:r*1..3]->(b:y)", "(a:x)-[v:r*]->(b:y|z)"):
        r1, r2 = ref.match(pat), port.match(pat)
        assert same(r1.vertex_mask, r2.vertex_mask) and same(r1.edge_mask, r2.edge_mask), pat
    for byte in (False, True):
        with bitplane.byte_masks(byte):
            assert same(port.khop(seeds, 3, pattern="(a)-[:r]->(b)"),
                        ref.khop(seeds, 3, pattern="(a)-[:r]->(b)")), byte
    assert same(port.shortest_paths(seeds, weight="w"), ref.shortest_paths(seeds, weight="w"))
    assert close(port.pagerank(weight="w"), ref.pagerank(weight="w"))
    assert same(port.components("(a)-[:r]->(b)"), ref.components("(a)-[:r]->(b)"))
    assert same(port.communities(), ref.communities())


def test_edge_blocks_are_cached_per_version_and_direction():
    """The sharded steps read the graph's cached edge blocks: one build per
    (version, direction); a write that adds delta edges gives the combined
    view its own blocks, and the answers follow the reference's delta path."""
    ref, port, meta = analytics_pair(5, n=40, m=160)
    del port
    src, dst = fixed_shape_edges(5, 40, 160)
    port = PropGraph(backend="arr", mesh=cpu_mesh(4)).add_edges_from(src, dst)
    nodes, es, ed = meta["nodes"], meta["es"], meta["ed"]
    port.add_edge_relationships(nodes[es], nodes[ed], meta["rels"])
    port.add_node_labels(nodes, meta["labels"])
    b1 = port._edge_blocks(1)
    assert port._edge_blocks(1) is b1 and port._edge_blocks(-1) is not b1
    assert b1.m == port.n_edges and b1.m_pad % 4 == 0 and len(b1.tail) == 4
    seeds = nodes[:3]
    for pg in (ref, port):
        pg.match("(a:x)-[:r]->(b)")  # seal: later writes take the delta path
        pg.insert_edges(nodes[:7], nodes[-7:])
        pg.delete_edges(nodes[es[:3]], nodes[ed[:3]])
    b2 = port._edge_blocks(1)
    assert b2 is not b1 and b2.m == port._require_graph().m > b1.m
    assert same(port.khop(seeds, 3), ref.khop(seeds, 3))
    assert same(port.shortest_paths(seeds), ref.shortest_paths(seeds))
    assert close(port.pagerank(), ref.pagerank())
    assert same(port.components(), ref.components())


# ---------------------------------------------------------------- sampling
def _reference_draws(monkeypatch, seed: int, layers: int):
    """The port's layer-l draw returns the reference's uniforms for it
    (``tests/test_torch_sampler.py``'s harness)."""
    keys = {sampler.layer_key(seed, li): ref_sampler.layer_key(seed, li)
            for li in range(layers)}

    def draw(key, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(keys[int(key)], shape))).to(device)

    monkeypatch.setattr(ns_ops, "_draw_priorities", draw)


def _blocks_equal(got, want):
    assert len(got) == len(want)
    for bg, bw in zip(got, want):
        for f in FIELDS:
            a, b = as_np(getattr(bg, f)), as_np(getattr(bw, f))
            assert a.shape == b.shape and (a == b).all(), f


@lru_cache(maxsize=None)
def sample_graphs():
    """pgserve's 800-edge tenant (the service tests' graph): the port on
    one device and on a P = 8 mesh, and the reference on one device."""
    return (pgserve.build_tenant_graph("arr", 800, seed=3, device="cpu"),
            pgserve.build_tenant_graph("arr", 800, mesh=cpu_mesh(8), seed=3),
            ref_pgserve.build_tenant_graph("arr", 800, seed=3))


@pytest.mark.parametrize("seeds,pat", [("ids", None), ("(a:l0)", "(a)-[:follows]->(b)")])
def test_sample_on_a_mesh_is_bitwise(monkeypatch, seeds, pat):
    """``tests/test_sample.py``'s P = 8 check: a mesh graph samples on its
    lead device, bitwise the single-device port, and bitwise the reference
    when both draw the reference's priorities."""
    single, sharded, ref = sample_graphs()
    nodes = as_np(single.graph.node_map)
    s = nodes[:48] if seeds == "ids" else seeds
    _blocks_equal(sharded.sample(s, [4, 3], pattern=pat, seed=5),
                  single.sample(s, [4, 3], pattern=pat, seed=5))
    _reference_draws(monkeypatch, 5, 2)
    _blocks_equal(sharded.sample(s, [4, 3], pattern=pat, seed=5),
                  ref.sample(s, [4, 3], pattern=pat, seed=5))
