"""The port's sampler and ``PropGraph.sample`` against the reference package
on the CPU.

``PropGraph.sample`` is held bitwise: the port's ``_draw_priorities`` is
patched to return the reference's own uniforms for the layer it draws, so
both packages select from the same priorities.  Graphs come from
``build_pair`` (numpy-seeded raw inputs through both ingest paths).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np, build_pair, raw_inputs
from repro.graph import sampler as ref_sampler
from repro.traverse import single_hop_filters as ref_filters
from repro_torch.graph import sampler
from repro_torch.kernels.neighbor_sample import ops
from repro_torch.traverse import single_hop_filters

FIELDS = ("src_nodes", "dst_nodes", "edge_src", "edge_dst", "edge_mask")
FILTERS = [None, "(a)-[e:likes {w < 0.5}]->(b:common)", "(a {age > 20})",
           "(x:mid|rare)-[:follows|knows]->(y)"]


@pytest.fixture(scope="module")
def pair():
    return build_pair(raw_inputs(2, n_pool=80, m=500))


def _reference_draws(monkeypatch, seed: int, layers: int):
    """Patch the port's draw: its layer-l key (under base ``seed``) gives
    the reference's ``uniform(layer_key(seed, l), shape)``."""
    keys = {sampler.layer_key(seed, li): ref_sampler.layer_key(seed, li)
            for li in range(layers)}

    def draw(key, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(keys[int(key)], shape))).to(device)

    monkeypatch.setattr(ops, "_draw_priorities", draw)


def _blocks_equal(got, want):
    assert len(got) == len(want)
    for li, (bg, bw) in enumerate(zip(got, want)):
        for f in FIELDS:
            a, b = np.asarray(getattr(bg, f)), np.asarray(getattr(bw, f))
            assert a.shape == b.shape and a.dtype == b.dtype and (a == b).all(), (li, f)
        assert (bg.n_src, bg.n_dst, bg.n_edges) == (bw.n_src, bw.n_dst, bw.n_edges)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("edge_filter", FILTERS)
@pytest.mark.parametrize("seeds_kind", ["ids", "pattern", "pattern_with_predicate"])
def test_sample_matches_reference(pair, monkeypatch, seeds_kind, edge_filter, seed):
    ref, port = pair
    nodes = as_np(ref.graph.node_map)
    seeds = {"ids": np.concatenate([nodes[:25], [10**6]]),  # an unknown id drops out
             "pattern": "(a:mid)",
             "pattern_with_predicate": "(a:common {age > 30})-[:likes]->(b)"}[seeds_kind]
    _reference_draws(monkeypatch, seed, 2)
    got = port.sample(seeds, [3, 2], seed=seed, pattern=edge_filter)
    want = ref.sample(seeds, [3, 2], seed=seed, pattern=edge_filter)
    _blocks_equal(got, want)
    assert got[-1].edge_mask.any()


def test_sample_layers_and_block_match_reference(pair, monkeypatch):
    ref, port = pair
    words = np.asarray(ref._sample_edge_words("(a)-[:likes|knows]->(b)", None))
    frontier = np.arange(0, 30, dtype=np.int32)
    _reference_draws(monkeypatch, 4, 3)
    got = sampler.sample_layers(port.graph, frontier, [4, 3, 2], seed=4, edge_words=words)
    want = ref_sampler.sample_layers(ref.graph, frontier, [4, 3, 2], seed=4,
                                     edge_words=jnp.asarray(words))
    _blocks_equal(got, want)
    nb, mk = sampler.sample_block(port.graph, frontier, sampler.layer_key(4, 1), fanout=3)
    rnb, rmk = ref_sampler.sample_block(ref.graph, jnp.asarray(frontier),
                                        ref_sampler.layer_key(4, 1), fanout=3)
    np.testing.assert_array_equal(as_np(nb), np.asarray(rnb))
    np.testing.assert_array_equal(as_np(mk), np.asarray(rmk))


@pytest.mark.parametrize("seed", range(4))
def test_local_block_matches_reference(seed):
    rng = np.random.default_rng(seed)
    dst_nodes = np.unique(rng.integers(0, 200, 30)).astype(np.int32)
    nbrs = rng.integers(-1, 200, (len(dst_nodes), 5)).astype(np.int32)
    mask = (nbrs >= 0) & (rng.random(nbrs.shape) < 0.8)
    src_nodes = np.unique(np.concatenate([dst_nodes, nbrs[mask]])).astype(np.int32)
    _blocks_equal([sampler.local_block(dst_nodes, src_nodes, nbrs, mask)],
                  [ref_sampler.local_block(dst_nodes, src_nodes, nbrs, mask)])


@pytest.mark.parametrize("size", [0, 1, 2, 1000])
def test_sorted_unique_equals_numpy_unique(size):
    ids = np.random.default_rng(size).integers(-3, 50, size).astype(np.int32)
    got = sampler.sorted_unique(ids)
    np.testing.assert_array_equal(got, np.unique(ids))
    assert got.dtype == ids.dtype


@pytest.mark.parametrize("batch,fanouts", [(1, [1]), (8, [15, 10]), (1024, [25, 10, 5]),
                                           (3, [2, 2, 2, 2])])
def test_block_shapes_match_reference(batch, fanouts):
    assert sampler.block_shapes(batch, fanouts) == ref_sampler.block_shapes(batch, fanouts)


@pytest.mark.parametrize("pattern", [None, "(a:mid)", "(a {age > 20})-[e:likes {w < 0.5}]->(b)",
                                     "(a)<-[:follows]-(b:rare)", "(a)-[]->(b:common)"])
def test_single_hop_filters_match_reference(pair, pattern):
    ref, port = pair
    got, want = single_hop_filters(port, pattern), ref_filters(ref, pattern)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(as_np(g), np.asarray(w))


def test_sample_is_reproducible_and_key_equals_seed(pair):
    _ref, port = pair
    nodes = as_np(port.graph.node_map)
    a = port.sample(nodes[:40], [5, 3], pattern="(a)-[:likes]->(b)", seed=9)
    b = port.sample(nodes[:40], [5, 3], pattern="(a)-[:likes]->(b)", seed=9)
    c = port.sample(nodes[:40], [5, 3], pattern="(a)-[:likes]->(b)", key=9)
    _blocks_equal(a, b)
    _blocks_equal(a, c)
    for s in (0, 7, 2**31 - 1, 2**64 - 1):
        for layer in (0, 1, 5):
            k = sampler.layer_key(s, layer)
            assert k == sampler.layer_key(s, layer) and 0 <= k < 2**63
    assert len({sampler.layer_key(s, li) for s in range(20) for li in range(5)}) == 100
    kb = sampler.layer_keys_batch(np.arange(9), 1)
    assert [int(k) for k in kb] == [sampler.layer_key(i, 1) for i in range(9)]


def test_layer_independence(pair):
    """Layer 0's draw is the same whether or not deeper layers exist, and
    two layers with the same fanout do not reuse each other's draws."""
    _ref, port = pair
    nodes = as_np(port.graph.node_map)
    one = port.sample(nodes[:48], [4], seed=3)
    two = port.sample(nodes[:48], [4, 4], seed=3)
    _blocks_equal([one[-1]], [two[-1]])
    l0, l1 = two[-1], two[-2]
    assert not (len(l0.edge_mask) == len(l1.edge_mask)
                and np.array_equal(l0.edge_src, l1.edge_src)
                and np.array_equal(l0.edge_mask, l1.edge_mask))


def test_own_draws_are_valid_samples(pair):
    """Without patched priorities: every layer passes the structural oracle."""
    from repro_torch.kernels.neighbor_sample.ref import check_sample

    _ref, port = pair
    g = port.graph
    seg, dst = as_np(g.seg), as_np(g.dst)
    words = port._sample_edge_words("(a)-[:likes]->(b)")
    from repro_torch.core import bitplane
    edge_ok = bitplane.unpack_bits_host(as_np(words), g.m)
    seeds = np.arange(g.n, dtype=np.int32)
    nb, ei, mk = ops.neighbor_sample(g.seg, g.dst, g.n, g.m, seeds, 12, fanout=3,
                                     edge_words=words, max_deg=g.max_deg)
    check_sample(seg, dst, seeds, edge_ok, 3, *(as_np(x)[:g.n] for x in (nb, ei, mk)))
    blocks = port.sample(as_np(g.node_map)[:32], [6, 4], seed=1)
    for b in blocks:
        assert (np.diff(b.src_nodes) > 0).all()
        assert b.edge_src[b.edge_mask].max(initial=0) < b.n_src
        assert set(b.dst_nodes.tolist()) <= set(b.src_nodes.tolist())


def test_sample_rejects_bad_requests(pair):
    _ref, port = pair
    nodes = as_np(port.graph.node_map)
    with pytest.raises(ValueError, match="fanouts"):
        port.sample(nodes[:4], [])
    with pytest.raises(ValueError, match="fanouts"):
        port.sample(nodes[:4], [2, 0])
    with pytest.raises(ValueError, match="out-edges"):
        port.sample(nodes[:4], [2], pattern="(a)<-[:likes]-(b)")
    with pytest.raises(ValueError, match="hops"):
        port.sample(nodes[:4], [2], pattern="(a)-[:likes]->(b)-[:knows]->(c)")
    with pytest.raises(ValueError, match="variable-length"):
        port.sample(nodes[:4], [2], pattern="(a)-[:likes*1..2]->(b)")
