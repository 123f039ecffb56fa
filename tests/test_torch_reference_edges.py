"""Inputs outside the usual range, through the port and the reference on
the CPU: the answers must be the reference's.

* Gather ids outside [0, N) in the GNN ops (``seg_mm``, ``gather_scatter``,
  ``degree_norm``, ``segment_softmax``) and so in the GAT, SAGE and GCN
  layers: an id in [-N, -1] wraps, an id >= N reads row N - 1, an id below
  -N reads row 0, as the reference's ``x[ids]`` does.  Ids N, N + 5,
  -N - 2 and -1; values at rtol = atol = 1e-5 (1e-6 for the primitives).
* Ties in DLRM's ``retrieval_scores``: ids equal to ``lax.top_k``'s, which
  puts the lower index first among equal scores (400 candidates of 50
  distinct rows repeated 8 times and shuffled, top 20; 300 all-zero
  candidates, top 10).
* Loss labels outside [0, C) in the LM and GCN losses: a label in [-C, -1]
  wraps, any other gives a NaN loss, as ``take_along_axis`` in fill mode
  does (labels C, -1, -100 and -C - 1), unless the GCN's bool node mask
  leaves the node out (the reference's NaN * False is 0).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_batch
from repro.configs import dlrm_rm2 as ref_rm2
from repro.configs import gcn_cora as ref_cora
from repro.configs import gemma2_9b as ref_gemma
from repro.data import graph as ref_data
from repro.graph import segment_ops as R
from repro.kernels.seg_mm import ref as ref_seg_mm
from repro.models import dlrm as ref_dlrm
from repro.models import gat as ref_gat
from repro.models import gcn as ref_gcn
from repro.models import transformer as RT
from repro_torch.configs import dlrm_rm2, gcn_cora, gemma2_9b
from repro_torch.graph import segment_ops as P
from repro_torch.kernels.seg_mm import ops as seg_ops
from repro_torch.kernels.seg_mm import ref as seg_ref
from repro_torch.models import dlrm, gat, gcn
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-5, atol=1e-5)
N, E, D = 6, 8, 3  # 6 nodes, 8 edges, 3 features


def bad_ids(n):
    """Ids outside [0, n) for n rows: past the end, far past it, below -n,
    and a wrapped one."""
    return [n, n + 5, -n - 2, -1]


def _edges(seed, bad, where="src"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    (src if where == "src" else dst)[3] = bad
    return x, src, dst, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------------ gather ids
@pytest.mark.parametrize("bad", bad_ids(N))
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_mm_reads_the_reference_rows(bad, weighted):
    x, src, dst, w = _edges(0, bad)
    ew = w if weighted else None
    want = np.asarray(ref_seg_mm.seg_mm_ref(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                                            N, edge_weight=None if ew is None else jnp.asarray(ew)))
    tx, ts, td = _t(x, src, dst)
    tw = None if ew is None else torch.from_numpy(ew)
    got = seg_ops.seg_mm(tx, ts, td, N, edge_weight=tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the same answer as the id replaced by the row the reference reads
    fixed = src.copy()
    fixed[3] = bad + N if -N <= bad < 0 else min(max(bad, 0), N - 1)
    again = seg_ref.seg_mm_ref(tx, torch.from_numpy(fixed), td, N, edge_weight=tw)
    assert got.equal(again)


def test_gather_ids_map():
    ids = torch.tensor([0, 5, 6, 11, -1, -6, -7, -100], dtype=torch.int32)
    assert seg_ref.gather_ids(ids, 6).tolist() == [0, 5, 5, 5, 5, 0, 0, 0]


def test_seg_mm_without_rows_raises_for_edges():
    x = torch.zeros((0, 4))
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="no rows"):
        seg_ops.seg_mm(x, ids, ids, 2)
    empty = torch.zeros(0, dtype=torch.int32)
    assert seg_ops.seg_mm(x, empty, empty, 2).equal(torch.zeros((2, 4)))


@pytest.mark.parametrize("bad", bad_ids(N))
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_gather_scatter_reads_the_reference_rows(bad, agg):
    x, src, dst, w = _edges(1, bad)
    got = P.gather_scatter(*_t(x, src, dst), N, edge_weight=torch.from_numpy(w), agg=agg)
    want = R.gather_scatter(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), N,
                            edge_weight=jnp.asarray(w), agg=agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", bad_ids(N))
@pytest.mark.parametrize("where", ["src", "dst"])
@pytest.mark.parametrize("mode", ["sym", "rw"])
def test_degree_norm_reads_the_reference_rows(bad, where, mode):
    _, src, dst, _ = _edges(2, bad, where)
    got = P.degree_norm(*_t(src, dst), N, mode=mode)
    want = R.degree_norm(jnp.asarray(src), jnp.asarray(dst), N, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", bad_ids(N))
@pytest.mark.parametrize("heads", [None, 2])
def test_segment_softmax_reads_the_reference_rows(bad, heads):
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((E,) if heads is None else (E, heads)).astype(np.float32)
    ids = rng.integers(0, N, E).astype(np.int32)
    ids[5] = bad
    got = P.segment_softmax(*_t(scores, ids), N)
    want = R.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), N)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _gnn_batch(bad, seed=4):
    rb = ref_data.synthetic_graph_batch(n_nodes=48, n_edges=200, d_feat=12, n_classes=5,
                                        seed=seed)
    src = np.array(rb.edge_src)
    src[[7, 70]] = bad(48)
    return dataclasses.replace(rb, edge_src=jnp.asarray(src))


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("model", ["gat", "sage", "gcn"])
def test_gnn_layers_read_the_reference_rows(which, model):
    rb = _gnn_batch(lambda n: bad_ids(n)[which])
    b = port_batch(rb)
    if model == "gat":
        ref_cfg, cfg = (c(d_in=12, d_hidden=4, n_heads=2, n_classes=5)
                        for c in (ref_gat.GATConfig, gat.GATConfig))
        ref_params = ref_gat.init_gat(jax.random.PRNGKey(5), ref_cfg)
        fwd, ref_fwd = gat.gat_forward, ref_gat.gat_forward
    elif model == "sage":
        ref_cfg, cfg = (c(d_in=12, d_hidden=8, n_classes=5) for c in (ref_gat.SAGEConfig,
                                                                      gat.SAGEConfig))
        ref_params = ref_gat.init_sage(jax.random.PRNGKey(6), ref_cfg)
        fwd, ref_fwd = gat.sage_forward, ref_gat.sage_forward
    else:
        ref_cfg = dataclasses.replace(ref_cora.smoke_config(), d_in=12, n_classes=5)
        cfg = dataclasses.replace(gcn_cora.smoke_config(), d_in=12, n_classes=5)
        ref_params = ref_gcn.init_params(jax.random.PRNGKey(7), ref_cfg)
        fwd, ref_fwd = gcn.forward, ref_gcn.forward
    load = gcn.params_from_reference if model == "gcn" else gat.params_from_reference
    params = load(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    got = fwd(params, b, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_fwd(ref_params, rb, ref_cfg)), **TOL)


# ------------------------------------------------------------------ ties
def _dlrm(seed=0):
    ref_cfg, cfg = ref_rm2.smoke_config(), dlrm_rm2.smoke_config()
    ref_params = ref_dlrm.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params = dlrm.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((1, cfg.n_dense)).astype(np.float32)
    sparse = rng.integers(0, cfg.vocab_size, (1, cfg.n_sparse, 1)).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, dense, sparse


def tied_candidates(kind, dim):
    """Two tied inputs: 50 distinct rows, each 8 times, shuffled; or 300
    all-zero rows."""
    if kind == "zeros":
        return np.zeros((300, dim), np.float32), 10
    rng = np.random.default_rng(8)
    rows = np.repeat(rng.standard_normal((50, dim)).astype(np.float32), 8, axis=0)
    return rows[rng.permutation(len(rows))], 20


@pytest.mark.parametrize("kind", ["repeated", "zeros"])
def test_retrieval_scores_order_ties_as_the_reference(kind):
    ref_cfg, ref_params, cfg, params, dense, sparse = _dlrm()
    cands, top_k = tied_candidates(kind, cfg.embed_dim)
    vals, ids = dlrm.retrieval_scores(params, *_t(dense, sparse, cands), cfg, top_k=top_k)
    rvals, rids = ref_dlrm.retrieval_scores(ref_params, jnp.asarray(dense), jnp.asarray(sparse),
                                            jnp.asarray(cands), ref_cfg, top_k=top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rvals), **TOL)
    if kind == "zeros":
        assert ids.tolist() == list(range(10))


def test_retrieval_scores_reject_top_k_past_the_candidates():
    _, _, cfg, params, dense, sparse = _dlrm()
    with pytest.raises(ValueError, match="top_k"):
        dlrm.retrieval_scores(params, *_t(dense, sparse, np.zeros((5, cfg.embed_dim),
                                                                   np.float32)), cfg, top_k=6)


# ------------------------------------------------------------------ loss labels
def bad_labels(c):
    return {"C": c, "-1": -1, "-100": -100, "-C-1": -c - 1}


@pytest.mark.parametrize("label", ["C", "-1", "-100", "-C-1"])
def test_lm_loss_labels_follow_the_reference(label):
    ref_cfg, cfg = ref_gemma.smoke_config(), gemma2_9b.smoke_config()
    ref_params = RT.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = T.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    labels[1, 9] = bad_labels(cfg.vocab)[label]
    got = float(T.loss_fn(params, *_t(toks, labels), cfg))
    want = float(RT.loss_fn(ref_params, jnp.asarray(toks), jnp.asarray(labels), ref_cfg))
    assert np.isnan(got) == np.isnan(want) == (label in ("C", "-C-1"))
    if not np.isnan(want):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("label", ["C", "-1", "-100", "-C-1"])
@pytest.mark.parametrize("masked", [False, True])
def test_gcn_loss_labels_follow_the_reference(label, masked):
    ref_cfg, cfg = ref_cora.smoke_config(), gcn_cora.smoke_config()
    rb = ref_data.synthetic_graph_batch(n_nodes=32, n_edges=96, d_feat=cfg.d_in,
                                        n_classes=cfg.n_classes, seed=9)
    labels = np.array(rb.labels)
    labels[4] = bad_labels(cfg.n_classes)[label]
    mask = np.array(rb.node_mask)
    mask[4] = not masked
    rb = dataclasses.replace(rb, labels=jnp.asarray(labels), node_mask=jnp.asarray(mask))
    ref_params = ref_gcn.init_params(jax.random.PRNGKey(9), ref_cfg)
    params = gcn.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    got = float(gcn.loss_fn(params, port_batch(rb), cfg))
    want = float(ref_gcn.loss_fn(ref_params, rb, ref_cfg))
    # a node outside the bool mask drops its NaN: the reference's nll * mask
    assert np.isnan(got) == np.isnan(want) == (label != "-1" and not masked)
    if not np.isnan(want):
        np.testing.assert_allclose(got, want, **TOL)


def test_label_logits_map():
    from repro_torch.nn.layers import label_logits

    lg = torch.arange(24.0).reshape(6, 4)
    got = label_logits(lg, torch.tensor([0, 3, 4, -1, -4, -5]))
    np.testing.assert_array_equal(got.numpy(), np.array([0, 7, np.nan, 15, 16, np.nan],
                                                        np.float32))
