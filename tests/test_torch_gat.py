"""The port's GAT and GraphSAGE (``models/gat.py``) against the reference
package on the CPU: forward and loss at rtol = atol = 1e-5, params carried
by ``params_from_reference``, the batch from the reference's seeded
``synthetic_graph_batch`` (with and without padded edges)."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import port_batch, with_padded_edges
from repro.data import graph as ref_data
from repro.models import gat as ref_gat
from repro_torch.models import gat

TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(d_feat, padded, seed):
    rb = ref_data.synthetic_graph_batch(n_nodes=48, n_edges=200, d_feat=d_feat, n_classes=5,
                                        seed=seed)
    return with_padded_edges(rb, seed) if padded else rb


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("cfg_kw", [dict(d_in=16, d_hidden=4, n_heads=2, n_classes=5),
                                    dict(d_in=24, d_hidden=8, n_heads=3, n_classes=5,
                                         n_layers=3)])
def test_gat_matches_reference(cfg_kw, padded):
    ref_cfg, cfg = ref_gat.GATConfig(**cfg_kw), gat.GATConfig(**cfg_kw)
    rb = _batch(cfg.d_in, padded, seed=1)
    ref_params = ref_gat.init_gat(jax.random.PRNGKey(2), ref_cfg)
    params = gat.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    b = port_batch(rb)
    got = gat.gat_forward(params, b, cfg)
    assert got.shape == (48, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_gat.gat_forward(ref_params, rb, ref_cfg)),
                               **TOL)
    np.testing.assert_allclose(float(gat.gat_loss(params, b, cfg)),
                               float(ref_gat.gat_loss(ref_params, rb, ref_cfg)), **TOL)


@pytest.mark.parametrize("aggregator", ["mean", "max"])
@pytest.mark.parametrize("padded", [False, True])
def test_sage_matches_reference(aggregator, padded):
    kw = dict(d_in=12, d_hidden=8, n_classes=5, aggregator=aggregator)
    ref_cfg, cfg = ref_gat.SAGEConfig(**kw), gat.SAGEConfig(**kw)
    rb = _batch(cfg.d_in, padded, seed=3)
    ref_params = ref_gat.init_sage(jax.random.PRNGKey(4), ref_cfg)
    params = gat.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    b = port_batch(rb)
    got = gat.sage_forward(params, b, cfg)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_gat.sage_forward(ref_params, rb, ref_cfg)), **TOL)
    np.testing.assert_allclose(float(gat.sage_loss(params, b, cfg)),
                               float(ref_gat.sage_loss(ref_params, rb, ref_cfg)), **TOL)


def test_own_init_shapes_and_loader_checks():
    gcfg, scfg = gat.GATConfig(d_in=10, d_hidden=4, n_heads=2), gat.SAGEConfig(d_in=10)
    gp = gat.init_gat(torch.Generator().manual_seed(0), gcfg, device="cpu")
    assert [tuple(lp["w"]["w"].shape) for lp in gp["layers"]] == [(10, 8), (8, 7)]
    assert tuple(gp["layers"][1]["a_src"].shape) == (1, 7)
    sp = gat.init_sage(torch.Generator().manual_seed(0), scfg, device="cpu")
    assert tuple(sp["layers"][0]["w_nbr"]["w"].shape) == (10, 64)
    assert "b" not in sp["layers"][0]["w_nbr"]
    ref_params = jax.tree.map(np.asarray, ref_gat.init_gat(jax.random.PRNGKey(0),
                                                           ref_gat.GATConfig(d_in=11)))
    with pytest.raises(ValueError, match="do not fit"):
        gat.params_from_reference(ref_params, gat.GATConfig(d_in=10), "cpu")
    with pytest.raises(TypeError, match="config"):
        gat.params_from_reference(ref_params, object(), "cpu")
