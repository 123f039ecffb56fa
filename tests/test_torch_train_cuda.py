"""Training on the card against the port on the CPU: the backward passes
of the kernels (B5ᵀ, B4's backward on B5) against the plain versions'
autograd on ragged shapes with out-of-range ids and empty rows, bitwise
run to run; the weight gradient B5 refuses; B6 refusing a gradient (ROADMAP
A15b); GCN and DLRM gradients at 1e-4 against the CPU port on the same
inputs; ``make_smoke_step`` on the card for GCN and DLRM, and a bitwise
GCN restart there.  Needs an NVIDIA card (marker ``cuda``; skips without
one).  Imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
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


@pytest.mark.cuda
def test_b6_refuses_a_gradient(cuda):
    q = torch.randn((1, 64, 4, 16), device=cuda, requires_grad=True)
    k = torch.randn((1, 64, 2, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="A15b"):
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
@pytest.mark.parametrize("arch", ["gcn-cora", "dlrm-rm2"])
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
def test_lm_training_on_the_card_waits_for_a15b(cuda):
    state, step_fn, _ = train.make_smoke_step("gemma2-9b", batch=1, seq=8)
    with pytest.raises(NotImplementedError, match="A15b"):
        step_fn(state, 0)
