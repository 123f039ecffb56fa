"""Training on the card against the port on the CPU: the backward passes
of the kernels (B5ᵀ, B4's backward on B5, B6's backward) against the plain
versions on ragged shapes with out-of-range ids, empty rows and query rows
with no valid key, bitwise run to run; the weight gradient B5 refuses;
GCN, DLRM and LM gradients at 1e-4 against the CPU port on the same
inputs; ``make_smoke_step`` on the card for GCN, DLRM and an LM, and a
bitwise restart there.  Needs an NVIDIA card (marker ``cuda``; skips without
one).  Imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.seg_mm import ops as sm_ops
from repro_torch.kernels.seg_mm import ref as sm_ref
from repro_torch.launch import train
from repro_torch.optim.tree import flatten, leaves, tree_map, unflatten

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _odd_edges(rng, n_src, n, m):
    src = rng.integers(-n_src - 3, n_src + 3, m).astype(np.int32)
    dst = rng.integers(-2, n + 2, m).astype(np.int32)
    return torch.from_numpy(src), torch.from_numpy(dst)


@pytest.mark.cuda
@pytest.mark.parametrize("n_src,n,m,d", [(15, 11, 70, 6), (1000, 3000, 20_000, 16),
                                         (4096, 50, 9000, 7), (300, 300, 0, 5)])
@pytest.mark.parametrize("weighted", [False, True])
def test_b5_transpose_matches_the_plain_backward(cuda, n_src, n, m, d, weighted):
    rng = np.random.default_rng(n_src + m)
    src, dst = _odd_edges(rng, n_src, n, m)
    x = torch.from_numpy(rng.standard_normal((n_src, d)).astype(np.float32))
    w = torch.from_numpy(rng.random(m).astype(np.float32)) if weighted else None
    c = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    xc = x.clone().requires_grad_(True)
    (sm_ref.seg_mm_ref(xc, src, dst, n, edge_weight=w) * c).sum().backward()
    grads = []
    for _ in range(2):
        xg = x.to(cuda).requires_grad_(True)
        sm_ops.reset_launches()
        out = sm_ops.seg_mm(xg, src.to(cuda), dst.to(cuda), n,
                            edge_weight=None if w is None else w.to(cuda))
        (out * c.to(cuda)).sum().backward()
        torch.cuda.synchronize()
        assert sm_ops.launches[sm_ops.SEG_MM_T] == (1 if n_src else 0)
        grads.append(xg.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], xc.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_b5_refuses_a_weight_gradient(cuda):
    x = torch.ones((3, 2), device=cuda, requires_grad=True)
    w = torch.ones(4, device=cuda, requires_grad=True)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="edge_weight"):
        sm_ops.seg_mm(x, idx, idx, 3, edge_weight=w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,v,d,mh", [(7, 3, 9, 4, 3), (4096, 26, 5000, 64, 1),
                                        (513, 5, 700, 33, 2), (8, 2, 10, 8, 0)])
def test_b4_backward_matches_the_plain_backward(cuda, b, f, v, d, mh):
    rng = np.random.default_rng(b + mh)
    tables = torch.from_numpy(rng.standard_normal((f, v, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-v - 2, v + 2, (b, f, mh)).astype(np.int32))
    cot = torch.from_numpy(rng.standard_normal((b, f, d)).astype(np.float32))
    tc = tables.clone().requires_grad_(True)
    bags = eb_ref.embedding_bag_ref(tc, idx)
    want = (torch.autograd.grad(bags, tc, cot)[0] if bags.requires_grad
            else torch.zeros_like(tables))
    got = []
    for _ in range(2):
        tg = tables.to(cuda).requires_grad_(True)
        eb_ops.reset_launches()
        (g,) = torch.autograd.grad(eb_ops.embedding_bag_fields(tg, idx.to(cuda)), tg,
                                   cot.to(cuda))
        torch.cuda.synchronize()
        assert eb_ops.launches[eb_ops.EMBEDDING_BAG_BACKWARD] == (1 if mh else 0)
        got.append(g.cpu())
    assert torch.equal(got[0], got[1])
    # the CPU's plain backward sums a row's duplicates in its own (threaded) order
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-6)


# (b, sq, skv, hq, hkv, d, kwargs): ragged lengths, G = 1, 2, 8, D = 16..256, causal
# on and off, window, softcap, q_offset (rows with no valid key at q_offset < 0); the
# last four at D = 192 and 256 with Sq and Skv no multiples of 32 or 64, G = 1 and 8
B6_BWD_CASES = [
    (1, 200, 200, 16, 8, 256, dict(causal=True, window=64, cap=50.0)),
    (2, 77, 131, 4, 2, 16, dict(causal=True, q_offset=-5)),
    (1, 130, 97, 8, 1, 64, dict(causal=False, cap=30.0)),
    (1, 150, 150, 8, 8, 128, dict(causal=True, window=40, q_offset=-20)),
    (1, 33, 70, 2, 2, 40, dict(causal=False, window=20, q_offset=60)),
    (1, 201, 173, 8, 1, 192, dict(causal=True, window=50, cap=50.0, q_offset=-20)),
    (2, 97, 150, 4, 4, 192, dict(causal=True, cap=30.0, q_offset=-9)),
    (1, 150, 90, 16, 2, 256, dict(causal=True, window=70, cap=50.0, q_offset=-40)),
    (1, 171, 229, 3, 3, 256, dict(causal=False, window=45, q_offset=30)),
]
# gradients against the plain backward (f32; from bf16 inputs for bf16), relative to
# the largest |gradient|: f32 sums of up to Sq·G terms in another order; bf16 P and dS
# rounded to bf16 before their products, as the kernel does
B6_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kw", B6_BWD_CASES)
def test_b6_backward_matches_the_plain_backward(cuda, b, sq, skv, hq, hkv, d, kw, dtype):
    rng = np.random.default_rng(sq + skv + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                   .to(cuda) for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                                           (b, sq, hq, d)))
    o, lse = fa_ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = fa_ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                          do.float(), **kw)
    got = []
    for _ in range(2):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fa_ops.reset_launches()
        fa_ops.flash_attention(*ts, **kw).backward(do)
        torch.cuda.synchronize()
        assert fa_ops.launches[fa_ops.FLASH_ATTENTION_BWD] == 1
        assert fa_ops.launches[fa_ops.BWD_COUNTERS["bwd_simt" if dtype == torch.float32
                                                    else "bwd_sm90"]] == 1
        got.append([t.grad for t in ts])
    tol = B6_BWD_TOL[dtype]
    for g, again, w in zip(*got, want):
        assert g.dtype == dtype and torch.equal(g, again)
        scale = float(w.abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol * max(scale, 1e-3))


# bf16 inputs TMA refuses, which the mma forward takes: (b, sq, skv, hq, hkv, d, pad,
# kwargs), q, k and v views of rows ``pad`` elements wider (strides no multiple of 8) or
# D no multiple of 8; the backward recomputes S as the mma kernel did
B6_BWD_MMA_CASES = [
    (1, 90, 150, 4, 2, 20, 0, dict(causal=True, cap=30.0, q_offset=-7)),
    (2, 200, 170, 8, 2, 64, 4, dict(causal=True, window=50, cap=50.0)),
    (1, 130, 130, 8, 4, 256, 4, dict(causal=True, window=40, cap=50.0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,pad,kw", B6_BWD_MMA_CASES)
def test_b6_backward_after_the_mma_forward(cuda, b, sq, skv, hq, hkv, d, pad, kw):
    from repro_torch.kernels.flash_attention import kernel

    rng = np.random.default_rng(sq + skv + d)
    wide = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
            .to(cuda) for shape in ((b, sq, hq, d + pad), (b, skv, hkv, d + pad),
                                    (b, skv, hkv, d + pad))]
    do = torch.from_numpy(rng.standard_normal((b, sq, hq, d)).astype(np.float32)).to(
        torch.bfloat16).to(cuda)
    q, k, v = (t[..., :d] for t in wide)
    assert kernel.variant(q, k, v) == "mma"
    o, lse = fa_ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = fa_ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                          do.float(), **kw)
    got = []
    for _ in range(2):
        ts = [t.clone()[..., :d].requires_grad_(True) for t in wide]
        fa_ops.reset_launches()
        got.append(torch.autograd.grad(fa_ops.flash_attention(*ts, **kw), ts, do))
        assert fa_ops.launches[fa_ops.COUNTERS["mma"]] == 1
        assert fa_ops.launches[fa_ops.BWD_COUNTERS["bwd_mma"]] == 1
    tol = B6_BWD_TOL[torch.bfloat16]
    for g, again, w in zip(*got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, again)
        scale = float(w.abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol * max(scale, 1e-3))


@pytest.mark.cuda
def test_b6_gradient_of_empty_inputs_raises(cuda):
    q = torch.randn((1, 0, 4, 16), device=cuda, requires_grad=True)
    k = torch.randn((1, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="no backward for empty"):
        fa_ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, k).shape == q.shape


def _grads(params, loss, batch):
    flat, spec = flatten(params)
    flat = [p.detach().requires_grad_(True) for p in flat]
    value = loss(unflatten(spec, flat), batch)
    return value.detach(), torch.autograd.grad(value, flat)


@pytest.mark.cuda
def test_gcn_and_dlrm_gradients_on_the_card_match_the_cpu(cuda):
    from repro_torch.configs import dlrm_rm2, gcn_cora
    from repro_torch.data import dlrm_batch, synthetic_graph_batch
    from repro_torch.models import dlrm, gcn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gcn_cora.full_config()
    params = gcn.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gb = synthetic_graph_batch(n_nodes=300, n_edges=1200, d_feat=cfg.d_in, seed=1, device="cpu")
    loss = lambda p, b: gcn.loss_fn(p, b, cfg)  # noqa: E731
    want_l, want = _grads(params, loss, gb)
    sm_ops.reset_launches()
    got_l, got = _grads(tree_map(lambda t: t.to(cuda), params), loss, gb.to(cuda))
    assert sm_ops.launches[sm_ops.SEG_MM] == 4 and sm_ops.launches[sm_ops.SEG_MM_T] == 2
    torch.testing.assert_close(got_l.cpu(), want_l, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TOL)

    cfg = dlrm_rm2.smoke_config()
    params = dlrm.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    b = dlrm_batch(0, batch=64, vocab=cfg.vocab_size, device="cpu")
    loss = lambda p, b: dlrm.loss_fn(p, b["dense"], b["sparse"], b["labels"], cfg)  # noqa: E731
    want_l, want = _grads(params, loss, b)
    got_l, got = _grads(tree_map(lambda t: t.to(cuda), params), loss,
                        {k: v.to(cuda) for k, v in b.items()})
    torch.testing.assert_close(got_l.cpu(), want_l, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gcn-cora", "dlrm-rm2", "gemma2-9b"])
def test_smoke_training_restarts_bitwise_on_the_card(cuda, arch, tmp_path):
    def run(fail_at, where):
        return train.run_training(arch, steps=12, batch=8, seq=16, ckpt_dir=str(tmp_path / where),
                                  ckpt_every=4, fail_at=fail_at, log_every=100)

    (broken, _), broken_losses = run((6,), "a")
    (whole, _), whole_losses = run((), "b")
    assert all(t.device.type == "cuda" for t in leaves(broken))
    assert broken_losses[6:] == whole_losses[4:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(broken), leaves(whole)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,policy", [("gemma2-9b", "full"), ("qwen2-72b", "full"),
                                         ("starcoder2-7b", "full"), ("gemma2-9b", "dots")])
def test_lm_step_gradients_on_the_card_match_the_cpu(cuda, arch, policy):
    """An LM smoke config's loss and gradients on the card (B6 forward and
    backward at every layer) against the CPU port (plain attention), under
    full rematerialization and under ``"dots"`` (selective checkpointing,
    which cannot see the kernel's launch and recomputes it)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), remat=True, remat_policy=policy)
    params = T.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = lm_batch(0, batch=2, seq=48, vocab=cfg.vocab, device="cpu")
    loss = lambda p, b: T.loss_fn(p, b["tokens"], b["labels"], cfg)  # noqa: E731
    want_l, want = _grads(params, loss, b)
    fa_ops.reset_launches()
    got_l, got = _grads(tree_map(lambda t: t.to(cuda), params), loss,
                        {k: v.to(cuda) for k, v in b.items()})
    # remat: every layer's forward twice (the recompute in the backward), one backward each
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == 2 * cfg.n_layers
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION_BWD] == cfg.n_layers
    torch.testing.assert_close(got_l.cpu(), want_l, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TOL)
