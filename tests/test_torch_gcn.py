"""The port's GCN (``models/gcn.py``, ``configs/gcn_cora.py``), its batch
builders (``data/graph.py``) and the graph generators against the
reference package on the CPU.

The reference's params (drawn with its own key) go through
``params_from_reference``; the batch is the reference's
``synthetic_graph_batch`` read into the port's ``GraphBatch``.  Logits and
losses agree at rtol = atol = 1e-5 for both ``spmm_impl`` values (the
reference's ``kernel`` path runs its Pallas ``seg_mm`` in interpret mode),
at ``smoke_config`` and at ``full_config`` (d_in = 1433) on a 64-node
graph, with and without padded edges.  Seeded numpy builders must give
equal arrays.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import port_batch, with_padded_edges
from repro.configs import gcn_cora as ref_cora
from repro.data import graph as ref_data
from repro.graph import generators as ref_gen
from repro.models import gcn as ref_gcn
from repro_torch.configs import gcn_cora
from repro_torch.data import graph as data
from repro_torch.graph import generators as gen
from repro_torch.models import gcn
from repro_torch.models.gnn_common import GraphBatch

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {"smoke": (ref_cora.smoke_config, gcn_cora.smoke_config),
           "full": (ref_cora.full_config, gcn_cora.full_config)}


def _case(size, impl, padded, seed=0):
    ref_cfg_fn, cfg_fn = CONFIGS[size]
    ref_cfg = dataclasses.replace(ref_cfg_fn(), spmm_impl=impl)
    cfg = dataclasses.replace(cfg_fn(), spmm_impl=impl)
    rb = ref_data.synthetic_graph_batch(n_nodes=64, n_edges=256, d_feat=cfg.d_in,
                                        n_classes=cfg.n_classes, seed=seed)
    if padded:
        rb = with_padded_edges(rb, seed)
    ref_params = ref_gcn.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params = gcn.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, ref_params, rb, cfg, params, port_batch(rb)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("impl", ["segment", "kernel"])
@pytest.mark.parametrize("padded", [False, True])
def test_forward_and_loss_match_reference(size, impl, padded):
    ref_cfg, ref_params, rb, cfg, params, b = _case(size, impl, padded)
    got = gcn.forward(params, b, cfg)
    want = np.asarray(ref_gcn.forward(ref_params, rb, ref_cfg))
    assert got.shape == (64, cfg.n_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(gcn.loss_fn(params, b, cfg)),
                               float(ref_gcn.loss_fn(ref_params, rb, ref_cfg)), **TOL)


def test_module_equals_functional_forward():
    _, _, _, cfg, params, b = _case("full", "kernel", True, seed=3)
    model = gcn.GCN(cfg, params)
    assert len(list(model.parameters())) == 4
    torch.testing.assert_close(model(b), gcn.forward(params, b, cfg), rtol=0, atol=0)


def test_padded_edges_count_in_every_degree():
    """Marking an edge as padding zeroes its message but keeps it in both
    degree terms, as the reference does (the self loop divides by
    1 + in-degree over every edge)."""
    _, _, rb, cfg, params, b = _case("smoke", "segment", False, seed=4)
    padded = port_batch(with_padded_edges(rb, 4, share=1.0))
    out = gcn.forward(params, padded, cfg)
    # with every edge padded, layer outputs are the self term x / (1 + in-degree)
    deg = np.bincount(rb.edge_dst, minlength=64).astype(np.float32) + 1.0
    h = padded.x @ params["layers"][0]["w"] + params["layers"][0]["b"]
    h = torch.relu(h / torch.from_numpy(deg)[:, None])
    h = h @ params["layers"][1]["w"] + params["layers"][1]["b"]
    torch.testing.assert_close(out, h / torch.from_numpy(deg)[:, None], rtol=1e-6, atol=1e-6)


def test_init_params_shapes_and_default_device(monkeypatch):
    cfg = gcn_cora.full_config()
    params = gcn.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert [tuple(lp["w"].shape) for lp in params["layers"]] == [(1433, 16), (16, 7)]
    assert all((lp["b"] == 0).all() for lp in params["layers"])
    again = gcn.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(a["w"].equal(b["w"]) for a, b in zip(params["layers"], again["layers"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gcn.init_params(torch.Generator().manual_seed(0), cfg)


def test_params_from_reference_checks_shapes():
    cfg = gcn_cora.smoke_config()
    ref_params = jax.tree.map(np.asarray,
                              ref_gcn.init_params(jax.random.PRNGKey(0), ref_cora.full_config()))
    with pytest.raises(ValueError, match="do not fit"):
        gcn.params_from_reference(ref_params, cfg, "cpu")
    with pytest.raises(ValueError, match="layers"):
        gcn.params_from_reference({"layers": ref_params["layers"][:1]}, cfg, "cpu")


def test_configs_match_reference():
    for name in ("full_config", "smoke_config"):
        ref_cfg, cfg = getattr(ref_cora, name)(), getattr(gcn_cora, name)()
        for f in ("name", "n_layers", "d_in", "d_hidden", "n_classes", "norm", "aggregator",
                  "dropout", "spmm_impl"):
            assert getattr(cfg, f) == getattr(ref_cfg, f), (name, f)
    assert gcn_cora.ARCH_ID == ref_cora.ARCH_ID and gcn_cora.FAMILY == ref_cora.FAMILY


# ------------------------------------------------------------------ builders
def _same_batch(b: GraphBatch, rb) -> None:
    for f in ("x", "pos", "species", "edge_src", "edge_dst", "edge_attr", "edge_mask",
              "node_mask", "labels", "graph_ids"):
        a, r = getattr(b, f), getattr(rb, f)
        assert (a is None) == (r is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=f)
            assert a.numpy().dtype == np.asarray(r).dtype, f
    assert (b.n_nodes, b.n_edges, b.n_graphs) == (rb.n_nodes, rb.n_edges, rb.n_graphs)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=64, n_edges=256, d_feat=1433),
    dict(n_nodes=30, n_edges=70, d_feat=8, n_classes=3, seed=5),
    dict(n_nodes=20, n_edges=40, with_pos=True, seed=2),
    dict(n_nodes=24, n_edges=50, d_feat=4, n_graphs=3, seed=9),
    dict(n_nodes=12, n_edges=30, with_pos=True, with_triplets=True, seed=1),
])
def test_synthetic_graph_batch_equals_reference(kw):
    _same_batch(data.synthetic_graph_batch(**kw, device="cpu"),
                ref_data.synthetic_graph_batch(**kw))


def test_batch_to_moves_every_tensor():
    b = data.synthetic_graph_batch(n_nodes=10, n_edges=20, d_feat=3, device="cpu")
    moved = b.to("cpu")
    assert moved is not b and moved.x.equal(b.x) and moved.pos is None


@pytest.mark.parametrize("seed", [0, 3])
def test_build_triplets_equals_reference(seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 15, 40), rng.integers(0, 15, 40)
    for cap in (5, 320):
        np.testing.assert_array_equal(data.build_triplets(src, dst, cap),
                                      ref_data.build_triplets(src, dst, cap))


def test_generators_equal_reference():
    for got, want in [
        (gen.random_uniform_graph(5000, seed=3), ref_gen.random_uniform_graph(5000, seed=3)),
        (gen.random_uniform_graph(800, seed=1, vertex_pool=50),
         ref_gen.random_uniform_graph(800, seed=1, vertex_pool=50)),
        (gen.rmat_graph(8, 4, seed=2), ref_gen.rmat_graph(8, 4, seed=2)),
        (gen.attach_random_attributes(900, seed=4), ref_gen.attach_random_attributes(900, seed=4)),
        (gen.attach_random_attributes(900, n_attrs=7, coverage=0.4, seed=5),
         ref_gen.attach_random_attributes(900, n_attrs=7, coverage=0.4, seed=5)),
        (gen.paper_graph("graph2", scale_down=1000, seed=6),
         ref_gen.paper_graph("graph2", scale_down=1000, seed=6)),
    ]:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert gen.PAPER_GRAPHS == ref_gen.PAPER_GRAPHS


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_stack_matches_reference(final_act):
    from repro.models import gnn_common as ref_common
    from repro_torch.models import gnn_common

    ref_params = ref_common.init_mlp_stack(jax.random.PRNGKey(1), [12, 9, 5])
    params = gnn_common.params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    x = np.random.default_rng(2).standard_normal((7, 12)).astype(np.float32)
    got = gnn_common.mlp_stack(params, torch.from_numpy(x), final_act=final_act)
    want = ref_common.mlp_stack(ref_params, jax.numpy.asarray(x), final_act=final_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    own = gnn_common.init_mlp_stack(torch.Generator().manual_seed(0), [12, 9, 5], bias=False)
    assert [tuple(p["w"].shape) for p in own] == [(12, 9), (9, 5)] and "b" not in own[0]
