"""The MoE LMs' and the science models' paths on the card against the port
on the CPU: B6 forward and backward at the MoE LMs' head shapes (48 query
and 8 KV heads of 128: G = 6, no softcap; ragged lengths, windows and
``q_offset``) against the plain versions; ``moe_ffn`` on the card routing
as on the CPU (experts and slots bitwise) with outputs and gradients within
1e-4; the MoE LM smoke configs' loss and gradients (B6 at every layer) and
the science models' at 1e-4 against the CPU.  Needs an NVIDIA card (marker
``cuda``; skips without one).  Imports neither JAX nor the reference
package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.nn import moe
from repro_torch.optim.tree import flatten, tree_map, unflatten

TOL = dict(rtol=1e-4, atol=1e-4)
B6_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# gradients against the plain backward, relative to the largest |gradient| (as
# test_torch_train_cuda.py's B6 backward cases)
B6_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (b, sq, skv, hq, hkv, d, kwargs): G = 6, D = 128, no softcap
MOE_B6_CASES = [
    (1, 1024, 1024, 48, 8, 128, dict(causal=True, window=512)),
    (1, 1000, 1000, 48, 8, 128, dict(causal=True)),
    (1, 200, 333, 12, 2, 128, dict(causal=True, window=150, q_offset=50)),
    (2, 97, 64, 6, 1, 128, dict(causal=True, q_offset=-20)),
    (1, 150, 250, 6, 1, 128, dict(causal=False, window=70, q_offset=100)),
]


def _qkv(rng, b, sq, skv, hq, hkv, d, dtype, device):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype).to(device)
            for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kw", MOE_B6_CASES)
def test_b6_forward_at_the_moe_shapes(cuda, b, sq, skv, hq, hkv, d, kw, dtype):
    q, k, v, _ = _qkv(np.random.default_rng(sq + hq), b, sq, skv, hq, hkv, d, dtype, cuda)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches[fa_ops.COUNTERS["simt" if dtype == torch.float32 else "sm90"]] == 1
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **B6_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kw", MOE_B6_CASES)
def test_b6_backward_at_the_moe_shapes(cuda, b, sq, skv, hq, hkv, d, kw, dtype):
    q, k, v, do = _qkv(np.random.default_rng(sq + skv), b, sq, skv, hq, hkv, d, dtype, cuda)
    o, lse = fa_ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = fa_ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                          do.float(), **kw)
    got = []
    for _ in range(2):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fa_ops.reset_launches()
        fa_ops.flash_attention(*ts, **kw).backward(do)
        assert fa_ops.launches[fa_ops.BWD_COUNTERS["bwd_simt" if dtype == torch.float32
                                                    else "bwd_sm90"]] == 1
        got.append([t.grad for t in ts])
    tol = B6_BWD_TOL[dtype]
    for g, again, w in zip(*got, want):
        assert g.dtype == dtype and torch.equal(g, again)
        scale = float(w.abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol * max(scale, 1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("renorm,cf", [("topk", 1.25), ("full", 1.25), ("topk", 0.5)])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, renorm, cf):
    """Routing (experts, slots, drops) bitwise, output and gradients within
    1e-4: f32, TF32 off, so the card's router logits round as the CPU's up
    to sum order, far from any tie on these inputs."""
    p = moe.init_moe(torch.Generator().manual_seed(0), 64, 96, 8, gated=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((256, 64)).astype(np.float32))
    x[:4] = 0  # ties: experts 0 and 1 on both devices
    kw = dict(top_k=2, capacity_factor=cf, renorm=renorm, n_groups=2)

    def run(device):
        leaves, spec = flatten(tree_map(lambda t: t.to(device), p))
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        xt = x.to(device).requires_grad_(True)
        out, aux = moe.moe_ffn(unflatten(spec, leaves), xt, **kw)
        grads = torch.autograd.grad(out.square().sum() + aux, leaves + [xt])
        r = moe.route(unflatten(spec, leaves)["router"], xt.detach().reshape(2, 128, 64),
                      n_experts=8, top_k=2, capacity_factor=cf, renorm=renorm)
        return out.detach().cpu(), [g.cpu() for g in grads], r

    out, grads, r = run("cpu")
    out_c, grads_c, r_c = run(cuda)
    for a, b in ((r.idx, r_c.idx), (r.pos, r_c.pos), (r.keep, r_c.keep)):
        assert torch.equal(a, b.cpu())
    assert int(r_c.dropped) == int(r.dropped) and (cf > 1 or int(r.dropped) > 0)
    assert r_c.idx[0, :4].tolist() == [[0, 1]] * 4
    torch.testing.assert_close(out_c, out, **TOL)
    for a, b in zip(grads_c, grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * max(float(b.abs().max()), 1e-3))


def _grads(params, loss, batch):
    flat, spec = flatten(params)
    ps = [t.detach().requires_grad_(True) for t in flat]
    value = loss(unflatten(spec, ps), batch)
    grads = torch.autograd.grad(value, ps, allow_unused=True)
    return value.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_moe_lm_gradients_on_the_card_match_the_cpu(cuda, arch):
    """The MoE smoke configs' loss and gradients on the card (B6 forward
    and backward at every layer, remat) against the CPU port."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch(arch).smoke_config(), remat=True)
    params = T.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = lm_batch(0, batch=2, seq=48, vocab=cfg.vocab, device="cpu")
    loss = lambda p, b: T.loss_fn(p, b["tokens"], b["labels"], cfg)  # noqa: E731
    want_l, want = _grads(params, loss, b)
    fa_ops.reset_launches()
    got_l, got = _grads(tree_map(lambda t: t.to(cuda), params), loss,
                        {k: v.to(cuda) for k, v in b.items()})
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == 2 * cfg.n_layers
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION_BWD] == cfg.n_layers
    torch.testing.assert_close(got_l.cpu(), want_l, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * max(float(w.abs().max()),
                                                                            1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dimenet", "mace", "graphcast"])
def test_science_gradients_on_the_card_match_the_cpu(cuda, arch):
    """A science model's smoke step-0 loss and gradients (f32) on the card
    against the CPU port; no kernel of B6 launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import synthetic_gc_batch, synthetic_graph_batch
    from repro_torch.models import dimenet, graphcast, mace

    mod = get_arch(arch)
    model = {"dimenet": dimenet, "mace": mace, "graphcast": graphcast}[mod.MODEL]
    cfg = dataclasses.replace(mod.smoke_config(), dtype=torch.float32)
    params = model.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    if arch == "graphcast":
        batch = synthetic_gc_batch(n_nodes=128, n_edges=512, n_vars=cfg.n_vars, device="cpu")
    else:
        batch = synthetic_graph_batch(n_nodes=64, n_edges=256, with_pos=True,
                                      n_species=cfg.n_species, n_graphs=4,
                                      with_triplets=arch == "dimenet", device="cpu")
    loss = lambda p, b: model.loss_fn(p, b, cfg)  # noqa: E731
    want_l, want = _grads(params, loss, batch)
    fa_ops.reset_launches()
    got_l, got = _grads(tree_map(lambda t: t.to(cuda), params), loss, batch.to(cuda))
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == 0
    torch.testing.assert_close(got_l.cpu(), want_l, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * max(float(w.abs().max()),
                                                                            1e-3))


FIRST_ON_AUTOGRADS_THREAD = """
import torch
from repro_torch.kernels.flash_attention import ops, ref
gen = torch.Generator(device="cuda").manual_seed(0)
q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((1, 128, 6, 128), (1, 128, 1, 128), (1, 128, 1, 128), (1, 128, 6, 128)))
ts = [t.requires_grad_(True) for t in (q, k, v)]
got = torch.autograd.grad(ops.flash_attention(*ts, causal=True), ts, do)
assert ops.launches[ops.BWD_COUNTERS["bwd_sm90"]] == 1
o, lse = ref.flash_attention_ref(q, k, v, causal=True, return_lse=True)
want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                   causal=True)
for g, w in zip(got, want):
    torch.testing.assert_close(g.float(), w, rtol=2e-2, atol=2e-2 * float(w.abs().max()))
print("OK")
"""


@pytest.mark.cuda
def test_b6_backward_as_the_first_cuda_work_of_autograds_thread(cuda):
    """ROADMAP C.27: in a fresh process, B6's backward is the first CUDA
    work on autograd's device thread, which then has no current context;
    the wgmma/TMA launchers bind the device's primary context before their
    driver call (``cuTensorMapEncodeTiled`` returned
    CUDA_ERROR_INVALID_CONTEXT there, and the launch raised)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", FIRST_ON_AUTOGRADS_THREAD], capture_output=True,
                         text=True, cwd=root, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-3000:]
