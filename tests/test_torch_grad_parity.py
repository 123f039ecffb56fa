"""Gradients of the port against ``jax.grad`` of the reference on the CPU.

ROADMAP C.21: the reference's gathers read a clamped row for an id outside
[-n, n) going forward, but the transpose of the gather drops such ids, so
they get no gradient; ids in [-n, -1] wrap both ways.  The port's gathers
follow it through ``kernels/seg_mm/ref.gather_rows``: ``gather_scatter``,
``seg_mm_ref``, ``spmm_di`` (both impls), ``segment_softmax``, GAT and the
LM's ``_embed``.  Beyond C.21: autograd through GCN and DLRM against
``jax.grad``, and the card's autograd Functions (B5 with B5ᵀ, B4 with its
backward on B5) run here with their launchers replaced by plain CPU folds
over the same layouts, against the plain versions' autograd.  Gradients
agree at rtol 1e-4, atol 1e-6 (f32 sums in other orders), C.21's exact
small-integer case exactly.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_batch, with_padded_edges
from repro.data import graph as ref_data
from repro.graph import segment_ops as ref_seg
from repro.models import dlrm as ref_dlrm
from repro.models import gat as ref_gat
from repro.models import gcn as ref_gcn
from repro_torch.graph import segment_ops as seg
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.seg_mm import ops as sm_ops
from repro_torch.kernels.seg_mm import ref as sm_ref
from repro_torch.models import dlrm, gat, gcn
from repro_torch.models import transformer as T
from repro_torch.configs import gemma2_9b

TOL = dict(rtol=1e-4, atol=1e-6)

# ROADMAP C.21's input: x = arange(8).reshape(4, 2), src [0, 5, -1, -7], dst [0..3],
# loss Σ out · [1, 10, 100, 1000]; jax.grad gives x.grad[:, 0] = [1, 0, 0, 100]
C21_X = np.arange(8.0, dtype=np.float32).reshape(4, 2)
C21_SRC = np.array([0, 5, -1, -7], np.int32)
C21_DST = np.array([0, 1, 2, 3], np.int32)
C21_C = np.array([1, 10, 100, 1000], np.float32)
C21_WANT = np.array([1, 0, 0, 100], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_grad(fn, x):
    xt = _t(x).requires_grad_(True)
    fn(xt).backward(torch.ones(()))
    return xt.grad.numpy()


def _c21_port(fn):
    return _port_grad(lambda xt: (fn(xt) * _t(C21_C)[:, None]).sum(), C21_X)


def test_c21_reference_gradient_drops_out_of_range_ids():
    g = jax.grad(lambda x: jnp.sum(ref_seg.gather_scatter(
        x, jnp.asarray(C21_SRC), jnp.asarray(C21_DST), 4) * C21_C[:, None]))(jnp.asarray(C21_X))
    np.testing.assert_array_equal(np.asarray(g)[:, 0], C21_WANT)


@pytest.mark.parametrize("path", ["gather_scatter", "seg_mm_ref", "spmm_di_segment",
                                  "spmm_di_kernel"])
def test_c21_port_gradient_matches_the_reference(path):
    src, dst = _t(C21_SRC), _t(C21_DST)
    fn = {"gather_scatter": lambda x: seg.gather_scatter(x, src, dst, 4),
          "seg_mm_ref": lambda x: sm_ref.seg_mm_ref(x, src, dst, 4),
          "spmm_di_segment": lambda x: seg.spmm_di(x, src, dst, 4, impl="segment"),
          "spmm_di_kernel": lambda x: seg.spmm_di(x, src, dst, 4, impl="kernel")}[path]
    g = _c21_port(fn)
    np.testing.assert_array_equal(g[:, 0], C21_WANT)
    np.testing.assert_array_equal(g[:, 1], C21_WANT)


def test_gather_rows_forward_is_the_plain_gather():
    x = _t(C21_X).requires_grad_(True)
    got = sm_ref.gather_rows(x, _t(C21_SRC))
    want = x.detach()[sm_ref.gather_ids(_t(C21_SRC), 4)]
    assert torch.equal(got.detach(), want)
    with torch.no_grad():
        assert torch.equal(sm_ref.gather_rows(x, _t(C21_SRC)), want)


def _odd_edges(seed, n, m, n_src=None):
    """Edges whose src and dst include ids in [-n, -1], >= n and < -n."""
    n_src = n if n_src is None else n_src
    rng = np.random.default_rng(seed)
    src = rng.integers(-n_src - 3, n_src + 3, m).astype(np.int32)
    dst = rng.integers(-2, n + 2, m).astype(np.int32)
    return src, dst


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_scatter_gradients_match_jax(agg, weighted):
    n, m, d = 12, 60, 5
    src, dst = _odd_edges(0, n, m)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.random(m).astype(np.float32) if weighted else None
    c = rng.standard_normal((n, d)).astype(np.float32)

    def ref_loss(x, w):
        return jnp.sum(ref_seg.gather_scatter(x, jnp.asarray(src), jnp.asarray(dst), n,
                                              edge_weight=w, agg=agg) * c)

    gx, gw = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x),
                                                None if w is None else jnp.asarray(w))
    xt = _t(x).requires_grad_(True)
    wt = None if w is None else _t(w).requires_grad_(True)
    (seg.gather_scatter(xt, _t(src), _t(dst), n, edge_weight=wt, agg=agg) * _t(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    if w is not None:
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **TOL)


def test_segment_softmax_gradient_matches_jax():
    n, m = 9, 40
    _, seg_ids = _odd_edges(2, n, m)
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((m, 3)).astype(np.float32)
    c = rng.standard_normal((m, 3)).astype(np.float32)
    g = jax.grad(lambda s: jnp.sum(ref_seg.segment_softmax(s, jnp.asarray(seg_ids), n) * c))(
        jnp.asarray(scores))
    got = _port_grad(lambda s: (seg.segment_softmax(s, _t(seg_ids), n) * _t(c)).sum(), scores)
    np.testing.assert_allclose(got, np.asarray(g), rtol=1e-4, atol=1e-5)


def _gcn_case(size, padded, odd_ids, seed=0):
    from repro.configs import gcn_cora as ref_cora
    from repro_torch.configs import gcn_cora

    ref_cfg = {"smoke": ref_cora.smoke_config, "full": ref_cora.full_config}[size]()
    cfg = {"smoke": gcn_cora.smoke_config, "full": gcn_cora.full_config}[size]()
    rb = ref_data.synthetic_graph_batch(n_nodes=40, n_edges=160, d_feat=cfg.d_in,
                                        n_classes=cfg.n_classes, seed=seed)
    if padded:
        rb = with_padded_edges(rb, seed)
    if odd_ids:
        src, dst = _odd_edges(seed + 1, 40, 160)
        rb = dataclasses.replace(rb, edge_src=jnp.asarray(src), edge_dst=jnp.asarray(dst))
    ref_params = ref_gcn.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, rb, ref_params


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("impl", ["segment", "kernel"])
@pytest.mark.parametrize("case", ["plain", "padded", "odd_ids"])
def test_gcn_gradients_match_jax(size, impl, case):
    """The reference's ``kernel`` impl has no VJP (its op wraps the forward
    ``pallas_call`` alone), so both impls are held to ``jax.grad`` of its
    ``segment`` impl, the same function."""
    ref_cfg, cfg, rb, ref_params = _gcn_case(size, case == "padded", case == "odd_ids")
    cfg = dataclasses.replace(cfg, spmm_impl=impl)
    loss, grads = jax.jit(jax.value_and_grad(ref_gcn.loss_fn), static_argnums=2)(
        ref_params, rb, ref_cfg)
    params = gcn.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    leaves = [t.requires_grad_(True) for lp in params["layers"] for t in (lp["w"], lp["b"])]
    got = gcn.loss_fn(params, port_batch(rb), cfg)
    got_grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5, atol=1e-6)
    want = [np.asarray(lp[k]) for lp in grads["layers"] for k in ("w", "b")]
    for g, w in zip(got_grads, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_gat_gradients_match_jax_with_odd_ids(padded):
    kw = dict(d_in=8, d_hidden=4, n_heads=2, n_classes=3)
    ref_cfg, cfg = ref_gat.GATConfig(**kw), gat.GATConfig(**kw)
    rb = ref_data.synthetic_graph_batch(n_nodes=20, n_edges=80, d_feat=8, n_classes=3, seed=4)
    src, dst = _odd_edges(5, 20, 80)
    rb = dataclasses.replace(rb, edge_src=jnp.asarray(src), edge_dst=jnp.asarray(dst))
    if padded:
        rb = with_padded_edges(rb, 4)
    ref_params = ref_gat.init_gat(jax.random.PRNGKey(6), ref_cfg)
    grads = jax.jit(jax.grad(ref_gat.gat_loss), static_argnums=2)(ref_params, rb, ref_cfg)
    params = gat.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    leaves = [(lp["w"]["w"], lp["a_src"], lp["a_dst"]) for lp in params["layers"]]
    flat = [t.requires_grad_(True) for trio in leaves for t in trio]
    got = torch.autograd.grad(gat.gat_loss(params, port_batch(rb), cfg), flat)
    want = [np.asarray(x) for lp in grads["layers"] for x in (lp["w"]["w"], lp["a_src"],
                                                               lp["a_dst"])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


def _dlrm_case(seed, mh, low=0):
    cfg_kw = dict(vocab_size=40, bot_mlp=(13, 16, 8), embed_dim=8, top_mlp=(16, 8, 1),
                  multi_hot=mh)
    ref_cfg, cfg = ref_dlrm.DLRMConfig(**cfg_kw), dlrm.DLRMConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((6, 13)).astype(np.float32)
    idx = rng.integers(low, 40, (6, 26, mh)).astype(np.int32)
    labels = rng.integers(0, 2, 6).astype(np.int32)
    return ref_cfg, cfg, dense, idx, labels


@pytest.mark.parametrize("mh,low", [(1, 0), (3, 0), (2, -40)])
def test_dlrm_gradients_match_jax(mh, low):
    """Ids in [-V, -1] wrap (low = -V); every table row's gradient and the
    MLPs' against ``jax.grad`` of the reference's ``take`` path."""
    ref_cfg, cfg, dense, idx, labels = _dlrm_case(7, mh, low)
    ref_params = ref_dlrm.init_params(jax.random.PRNGKey(1), ref_cfg)
    grads = jax.jit(jax.grad(ref_dlrm.loss_fn), static_argnums=4)(
        ref_params, jnp.asarray(dense), jnp.asarray(idx), jnp.asarray(labels), ref_cfg)
    params = dlrm.params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    leaves = [params["tables"]] + [t for k in ("bot", "top") for lp in params[k]
                                   for t in (lp["w"], lp["b"])]
    for t in leaves:
        t.requires_grad_(True)
    got = torch.autograd.grad(dlrm.loss_fn(params, _t(dense), _t(idx), _t(labels), cfg), leaves)
    want = [grads["tables"]] + [lp[k] for s in ("bot", "top") for lp in grads[s]
                                for k in ("w", "b")]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_embedding_bag_gradient_drops_ids_outside_the_tables():
    """A bag with an id outside [-V, V) is NaN going forward; under a finite
    cotangent its other ids get theirs / MH, and the bad id gets none."""
    rng = np.random.default_rng(8)
    tables = rng.standard_normal((3, 10, 4)).astype(np.float32)
    idx = rng.integers(-10, 10, (5, 3, 2)).astype(np.int32)
    idx[0, 0, 1], idx[2, 1, 0], idx[3, 2, 1] = 10, -11, 999
    cot = rng.standard_normal((5, 3, 4)).astype(np.float32)

    def ref_bags(t):
        return jax.vmap(lambda tf, ix: jnp.mean(jnp.take(tf, ix, axis=0, mode="fill"), axis=1),
                        in_axes=(0, 1), out_axes=1)(t, jnp.asarray(idx))

    _, pull = jax.vjp(ref_bags, jnp.asarray(tables))
    (want,) = pull(jnp.asarray(cot))
    tt = _t(tables).requires_grad_(True)
    out = eb_ops.embedding_bag_fields(tt, _t(idx))
    assert torch.isnan(out[0, 0]).all() and torch.isfinite(out[1]).all()
    (got,) = torch.autograd.grad(out, tt, _t(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("low,high", [(0, 512), (-700, 700)])
def test_embed_gradient_matches_jax_for_ids_beyond_the_vocabulary(low, high):
    """``_embed`` with token ids >= V and < -V: forward rows as the
    reference's clamp reads them, gradients only for ids in [-V, V)."""
    cfg = gemma2_9b.smoke_config()
    rng = np.random.default_rng(9)
    table = (rng.standard_normal((cfg.vocab, cfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(low, high, (2, 12)).astype(np.int32)
    toks[0, :4] = [cfg.vocab, cfg.vocab + 5, -cfg.vocab - 1, -1]
    c = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)

    def ref_embed(e):  # the reference's ``params["embed"][tokens]``, cast and scaled
        return e[jnp.asarray(toks)].astype(jnp.float32) * math.sqrt(cfg.d_model)

    out, pull = jax.vjp(ref_embed, jnp.asarray(table))
    (want,) = pull(jnp.asarray(c))
    tt = _t(table).requires_grad_(True)
    got_out = T._embed({"embed": tt}, _t(toks), cfg)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=1e-6, atol=1e-7)
    (got,) = torch.autograd.grad(got_out, tt, _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------- the card's autograd Functions, on the CPU
def _cpu_seg_mm(x, src, w, row_ptr, out):
    """B5's launcher replaced by a plain fold over the layout it is given:
    the same rows, edges and order the kernel walks."""
    n = out.shape[0]
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(n), counts)
    lo = int(row_ptr[0])
    e = src[lo:lo + rows.numel()]
    msgs = x[sm_ref.gather_ids(e, x.shape[0])]
    if w is not None:
        msgs = msgs * w[lo:lo + rows.numel(), None]
    out.copy_(torch.zeros_like(out).index_add_(0, rows, msgs))


@pytest.fixture
def cpu_launchers(monkeypatch):
    """Run the card's autograd Functions with CPU launchers."""
    monkeypatch.setattr(sm_ops.kernel, "launch_seg_mm", _cpu_seg_mm)

    def launch_bag(tables, idx, out):
        out.copy_(eb_ref.embedding_bag_ref(tables, idx))

    monkeypatch.setattr(eb_ops.kernel, "launch_embedding_bag", launch_bag)
    sm_ops.reset_launches()
    eb_ops.reset_launches()
    sm_ops.LAYOUTS.__init__()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("weighted", [False, True])
def test_b5_transpose_matches_the_plain_backward(cpu_launchers, seed, weighted):
    """``_SegMM``'s backward (B5 on the transposed layout) against autograd
    of the plain version, on edges with src outside [-N, N), dst outside
    [0, n), a node count unlike N_src and empty rows; one forward and one
    transposed layout build, shared by two calls."""
    n_src, n, m, d = 15, 11, 70, 6
    src, dst = _odd_edges(seed, n, m, n_src=n_src)
    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    w = _t(rng.random(m).astype(np.float32)) if weighted else None
    c = _t(rng.standard_normal((n, d)).astype(np.float32))
    s_t, d_t = _t(src), _t(dst)
    want = _port_grad(lambda xt: (sm_ref.seg_mm_ref(xt, s_t, d_t, n, edge_weight=w) * c).sum()
                      + (sm_ref.seg_mm_ref(xt, s_t, d_t, n, edge_weight=w) * c * 2).sum(), x)
    xt = _t(x).requires_grad_(True)
    out1 = sm_ops._SegMM.apply(xt, s_t, d_t, n, w)
    out2 = sm_ops._SegMM.apply(xt, s_t, d_t, n, w)
    assert torch.equal(out1.detach(), sm_ref.seg_mm_ref(_t(x), s_t, d_t, n, edge_weight=w))
    ((out1 * c).sum() + (out2 * c * 2).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    assert sm_ops.launches == {sm_ops.SEG_MM: 4, sm_ops.SEG_MM_T: 2}
    assert sm_ops.LAYOUTS.builds_by_orientation == {sm_ops.FORWARD: 1, sm_ops.TRANSPOSE: 1}


def test_b5_transpose_on_c21(cpu_launchers):
    g = _c21_port(lambda x: sm_ops._SegMM.apply(x, _t(C21_SRC), _t(C21_DST), 4, None))
    np.testing.assert_array_equal(g[:, 0], C21_WANT)


def test_seg_mm_weight_gradient_on_the_cpu_is_the_plain_versions():
    """The CPU path differentiates the weights through the plain version
    (the card's path refuses them: ``test_torch_train_cuda.py``)."""
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((5, 3)).astype(np.float32))
    src, dst = _odd_edges(12, 5, 20)
    w = rng.random(20).astype(np.float32)
    c = rng.standard_normal((5, 3)).astype(np.float32)
    want = jax.grad(lambda w: jnp.sum(ref_seg.gather_scatter(
        jnp.asarray(x.numpy()), jnp.asarray(src), jnp.asarray(dst), 5, edge_weight=w) * c))(
        jnp.asarray(w))
    got = _port_grad(lambda wt: (sm_ops.seg_mm(x, _t(src), _t(dst), 5, edge_weight=wt)
                                 * _t(c)).sum(), w)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("mh", [0, 1, 3])
def test_b4_backward_matches_the_plain_backward(cpu_launchers, mh):
    """``_EmbeddingBag``'s backward (a segment sum on B5 over the (field,
    row) layout) against autograd of the plain version, ids outside [-V, V)
    included (their bags NaN, a finite cotangent); MH = 0 gives zeros."""
    rng = np.random.default_rng(mh)
    f, v, d, b = 3, 9, 4, 7
    tables = _t(rng.standard_normal((f, v, d)).astype(np.float32))
    idx = rng.integers(-v - 2, v + 2, (b, f, mh)).astype(np.int32)
    cot = _t(rng.standard_normal((b, f, d)).astype(np.float32))
    want_t = tables.clone().requires_grad_(True)
    bags = eb_ref.embedding_bag_ref(want_t, _t(idx))
    want = (torch.autograd.grad(bags, want_t, cot)[0] if bags.requires_grad
            else torch.zeros_like(tables))  # MH = 0: the bags read no table
    tt = tables.clone().requires_grad_(True)
    out = eb_ops._EmbeddingBag.apply(tt, _t(idx))
    (got,) = torch.autograd.grad(out, tt, cot)
    assert torch.equal(got, want)
    assert eb_ops.launches[eb_ops.EMBEDDING_BAG_BACKWARD] == (1 if mh else 0)
