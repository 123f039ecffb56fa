"""The GNN serving slice end to end on the CPU, against the reference
package: a pattern picks the seeds, ``PropGraph.sample`` draws 15-10
blocks under an edge filter, the blocks are compacted into one batch, and
the GCN (``spmm_impl='kernel'``) scores it.

Both packages sample from the same priorities (the port's
``_draw_priorities`` returns the reference's uniforms for each layer, as in
``tests/test_torch_sampler.py``); the port's batch comes from
``chip_smoke.subgraph_batch``, the reference's from the example's own
function, copied below.  Batches are equal array for array and logits
agree at rtol = atol = 1e-5.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np, build_pair, raw_inputs
from repro.configs import gcn_cora as ref_cora
from repro.graph import sampler as ref_sampler
from repro.models import gcn as ref_gcn
from repro.models.gnn_common import GraphBatch as RefGraphBatch
from repro_torch.configs import gcn_cora
from repro_torch.graph import sampler
from repro_torch.kernels.neighbor_sample import ops
from repro_torch.models import gcn

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FANOUTS = [15, 10]
SEEDS = {"ids": None, "pattern": "(a:common)", "predicate": "(a:mid|rare {age > 20})"}
FILTERS = [None, "(a)-[e {w < 0.5}]->(b)"]


def ref_subgraph_batch(blocks, seed_int, feats, labels):
    """``subgraph_batch`` of examples/gnn_sampled_training.py:57, with the
    feature and label tables passed in (the example reads globals)."""
    sub = np.asarray(blocks[0].src_nodes)
    es_l, ed_l = [], []
    for b in blocks:
        sn, dn = np.asarray(b.src_nodes), np.asarray(b.dst_nodes)
        s, d = np.asarray(b.edge_src), np.asarray(b.edge_dst)
        keep = np.asarray(b.edge_mask)
        es_l.append(np.searchsorted(sub, sn[s[keep]]))
        ed_l.append(np.searchsorted(sub, dn[d[keep]]))
    e_src = np.concatenate(es_l).astype(np.int32)
    e_dst = np.concatenate(ed_l).astype(np.int32)
    order = np.argsort(e_src, kind="stable")
    nmask = np.zeros(len(sub), bool)
    nmask[np.searchsorted(sub, seed_int)] = True
    return RefGraphBatch(
        x=jnp.asarray(feats[sub]), pos=None, species=None,
        edge_src=jnp.asarray(e_src[order]), edge_dst=jnp.asarray(e_dst[order]),
        edge_attr=None, edge_mask=jnp.ones(len(e_src), bool),
        node_mask=jnp.asarray(nmask), labels=jnp.asarray(labels[sub]),
        graph_ids=jnp.zeros(len(sub), jnp.int32),
        n_nodes=len(sub), n_edges=len(e_src), n_graphs=1)


@pytest.fixture(scope="module")
def pair():
    return build_pair(raw_inputs(5, n_pool=90, m=600))


def _reference_draws(monkeypatch, seed: int, layers: int):
    keys = {sampler.layer_key(seed, li): ref_sampler.layer_key(seed, li)
            for li in range(layers)}

    def draw(key, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(keys[int(key)], shape))).to(device)

    monkeypatch.setattr(ops, "_draw_priorities", draw)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("edge_filter", FILTERS)
@pytest.mark.parametrize("seeds_kind", list(SEEDS))
def test_sampled_gcn_logits_match_reference(pair, monkeypatch, seeds_kind, edge_filter, size):
    ref, port = pair
    nodes = as_np(ref.graph.node_map)
    seeds = SEEDS[seeds_kind]
    if seeds is None:
        seeds = np.random.default_rng(1).choice(nodes, 20, replace=False)
    _reference_draws(monkeypatch, 3, len(FANOUTS))
    blocks = port.sample(seeds, FANOUTS, seed=3, pattern=edge_filter)
    ref_blocks = ref.sample(seeds, FANOUTS, seed=3, pattern=edge_filter)
    assert blocks[-1].edge_mask.any()

    ref_cfg = {"smoke": ref_cora.smoke_config, "full": ref_cora.full_config}[size]()
    ref_cfg = dataclasses.replace(ref_cfg, spmm_impl="kernel")
    cfg = {"smoke": gcn_cora.smoke_config, "full": gcn_cora.full_config}[size]()
    cfg = dataclasses.replace(cfg, spmm_impl="kernel")
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((port.n_vertices, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, port.n_vertices).astype(np.int32)

    rb = ref_subgraph_batch(ref_blocks, np.asarray(ref_blocks[-1].dst_nodes), feats, labels)
    b = chip_smoke.subgraph_batch(blocks, blocks[-1].dst_nodes, torch.from_numpy(feats),
                                  torch.from_numpy(labels))
    for f in ("x", "edge_src", "edge_dst", "edge_mask", "node_mask", "labels", "graph_ids"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(rb, f)),
                                      err_msg=f)
    assert (b.n_nodes, b.n_edges) == (rb.n_nodes, rb.n_edges)
    assert int(b.node_mask.sum()) == len(blocks[-1].dst_nodes)

    ref_params = ref_gcn.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = gcn.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    got = gcn.GCN(cfg, params)(b)
    want = np.asarray(ref_gcn.forward(ref_params, rb, ref_cfg))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
