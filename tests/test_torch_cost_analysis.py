"""The port's cost analysis (``launch/hlo_analysis.py``, the kernels' cost
hooks in ``kernels/_cost.py``) against the reference's ``analyze_hlo`` on
the CPU.

* The reference's own cases (``tests/test_hlo_analysis.py``) on both
  packages, from the same numpy inputs: one product exact, a loop of L
  products L times, nested loops composed, a step's FLOPs linear in its
  layers: the port's ``flops`` equal ``analyze_hlo``'s exactly; a copy's
  bytes are twice its output plus its argument.
* B6's charge against the (query, key) pairs of its mask enumerated with
  numpy; B4, B5 and B6 charged once forward and once backward under a
  counter, on fake tensors (empty outputs) and on real CPU tensors (the
  plain version's answer and gradients, none of its operations counted).
* A step run on real CPU tensors and traced on fake ones counts the same
  FLOPs and kernel charges (the CPU twin of ``chip_smoke.py`` phase 3n
  (b)); remat's recompute counts once, a selective policy's saved products
  not again.
* Live bytes and their peak; AdamW's schedule bitwise unchanged on real
  counts and one update on fake tensors.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch.hlo_analysis import analyze_hlo
from repro.optim import adamw as ref_adamw
from repro_torch.configs import dlrm_rm2, gcn_cora, gemma2_9b, mixtral_8x22b
from repro_torch.configs.common import gnn_graph_specs, recsys_input_specs, sds
from repro_torch.kernels import _cost
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.seg_mm import ops as sm_ops
from repro_torch.kernels.seg_mm import ref as sm_ref
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.hlo_analysis import CostCounter, count_step
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.steps import build_cell, map_tensors
from repro_torch.optim import adamw
from repro_torch.optim.tree import leaves

ONE = AbstractMesh((1, 1), ("data", "model"))


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _both(fn_np, fn_torch, *arrays, fake: bool):
    """(analyze_hlo's flops, the port's flops) of the same function on the
    same numpy inputs; the port's on fake or real CPU tensors."""
    ref = analyze_hlo(_compile(fn_np, *arrays))["flops"]
    if fake:
        with FakeTensorMode():
            ts = [torch.empty(a.shape, dtype=torch.float32) for a in arrays]
            got = count_step(fn_torch, *ts)["flops"]
    else:
        got = count_step(fn_torch, *(torch.from_numpy(a) for a in arrays))["flops"]
    return ref, got


# ----------------------------------------------------------- the reference's cases
@pytest.mark.parametrize("fake", [False, True])
def test_single_product_exact(fake):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, 32)).astype(np.float32)
    ref, got = _both(lambda a, b: a @ b, lambda a, b: a @ b, a, b, fake=fake)
    assert ref == got == 2 * 64 * 128 * 32


@pytest.mark.parametrize("fake", [False, True])
def test_loop_of_products_counts_every_iteration(fake):
    a = np.random.default_rng(1).standard_normal((32, 32)).astype(np.float32)

    def ref_fn(x):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=7)
        return y

    def port_fn(x):
        for _ in range(7):
            x = x @ x
        return x

    ref, got = _both(ref_fn, port_fn, a, fake=fake)
    assert ref == got == 7 * 2 * 32 ** 3


@pytest.mark.parametrize("fake", [False, True])
def test_nested_loops_compose(fake):
    a = np.random.default_rng(2).standard_normal((16, 16)).astype(np.float32)

    def ref_fn(x):
        def outer(c, _):
            d, _ = jax.lax.scan(lambda d, _: (d @ d, None), c, None, length=3)
            return d, None
        y, _ = jax.lax.scan(outer, x, None, length=5)
        return y

    def port_fn(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    ref, got = _both(ref_fn, port_fn, a, fake=fake)
    assert ref == got == 15 * 2 * 16 ** 3


@pytest.mark.parametrize("fake", [False, True])
def test_layers_scale_linearly(fake):
    def flops(nl):
        rng = np.random.default_rng(nl)
        w = rng.standard_normal((nl, 32, 32)).astype(np.float32)
        x = rng.standard_normal((8, 32)).astype(np.float32)

        def ref_fn(w, x):
            y, _ = jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)
            return y

        def port_fn(w, x):
            for i in range(w.shape[0]):
                x = torch.tanh(x @ w[i])
            return x

        ref, got = _both(ref_fn, port_fn, w, x, fake=fake)
        assert ref == got
        return got

    assert flops(8) == 4 * flops(2)


@pytest.mark.parametrize("fake", [False, True])
def test_bytes_of_a_copy(fake):
    """x * 2: the argument read once, the output written and read once."""
    payload = 1024 * 1024 * 4
    if fake:
        with FakeTensorMode():
            t = count_step(lambda x: x * 2.0, torch.empty(1024, 1024))
    else:
        t = count_step(lambda x: x * 2.0, torch.ones(1024, 1024))
    assert t["bytes"] == 3 * payload
    assert t["argument_bytes"] == payload and t["peak_bytes"] == 2 * payload
    assert t["coll_bytes"] is None and t["flops"] == 0


def test_views_and_empty_allocations_move_no_bytes():
    with FakeTensorMode():
        x = torch.empty(64, 64)
        t = count_step(lambda x: (x.T[:8], x.reshape(-1)[3:], x.view(2, 32, 64).sum(1),
                                  torch.empty(1000)), x)
    assert t["bytes"] == x.numel() * 4 + 2 * (2 * 64 * 4)  # the argument and the sum
    assert t["peak_bytes"] == x.numel() * 4 + 2 * 64 * 4 + 4000


def test_live_bytes_follow_frees():
    def fn(x):
        a = x + 1  # 4 MB
        b = a * 2  # 4 MB: 12 MB live with x
        del a
        c = b + 1  # a freed: 12 MB again
        return c.sum()

    t = count_step(fn, torch.ones(1024, 1024))
    assert t["peak_bytes"] == 3 * 4 * 2**20 + 4  # x, b, c and c's sum


def test_matmul_flops_split_by_dtype():
    with FakeTensorMode():
        a = torch.empty(16, 32, dtype=torch.bfloat16)
        b = torch.empty(32, 8, dtype=torch.bfloat16)
        v = torch.empty(32)
        t = count_step(lambda a, b, v: (a @ b, torch.mv(a.float(), v),
                                        torch.bmm(a[None], b[None]), torch.dot(v, v)), a, b, v)
    mm = 2 * 16 * 32 * 8
    assert t["flops_by_dtype"] == {"bfloat16": 2 * mm, "float32": 2 * 16 * 32 + 2 * 32}
    assert t["flops_bf16"] == 2 * mm and t["flops"] == 2 * mm + 2 * 16 * 32 + 2 * 32


# -------------------------------------------------------------- kernel charges
PAIR_CASES = [  # (Sq, Skv, causal, window, q_offset)
    (1, 1, True, None, 0), (7, 7, True, None, 0), (7, 7, True, 3, 0), (5, 9, True, None, 4),
    (9, 5, False, None, 0), (9, 5, False, 2, 3), (16, 16, True, 1, 0), (16, 16, True, 0, 0),
    (6, 6, True, None, -3), (6, 6, True, 4, -2), (33, 70, True, 20, 37), (40, 12, True, 5, 0),
]


def _mask_pairs(sq, skv, causal, window, q_offset) -> int:
    d = (q_offset + np.arange(sq))[:, None] - np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return int(ok.sum())


@pytest.mark.parametrize("case", PAIR_CASES)
def test_b6_charge_counts_the_pairs_the_mask_keeps(case):
    sq, skv, causal, window, q_offset = case
    pairs = _mask_pairs(*case)
    assert fa_ops.kept_pairs(sq, skv, causal=causal, window=window, q_offset=q_offset) == pairs
    q, k = torch.empty(3, sq, 4, 16, device="meta"), torch.empty(3, skv, 2, 16, device="meta")
    kw = dict(causal=causal, window=window, cap=None, q_offset=q_offset)
    assert fa_ops.flash_attention_cost(q, k, k, kw).flops == 4 * 16 * 4 * 3 * pairs
    assert fa_ops.flash_attention_bwd_cost(q, k, k, kw).flops == 10 * 16 * 4 * 3 * pairs


def _grads(out, inputs):
    return torch.autograd.grad(out.square().sum(), [t for t in inputs if t.requires_grad])


@pytest.mark.parametrize("fake", [False, True])
def test_b6_charged_once_forward_and_backward(fake):
    rng = np.random.default_rng(3)
    kw = dict(causal=True, window=5, cap=30.0, q_offset=0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((2, 12, 4, 16), (2, 12, 2, 16),
                                                                   (2, 12, 2, 16))]
    want = _cost.Charge("flash_attention", 4 * 16 * 4 * 2 * _mask_pairs(12, 12, True, 5, 0),
                        (2 * 2 * 12 * 4 * 16 + 2 * 2 * 12 * 2 * 16) * 4)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        q, k, v = (torch.empty(a.shape) if fake else torch.from_numpy(a) for a in arrays)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        with CostCounter() as counter:
            out = fa_ops.flash_attention(q, k, v, **kw)
            got = _grads(out, (q, k, v))
    tot = counter.totals()
    assert tot["kernels"]["flash_attention"] == {"calls": 1, "flops": want.flops,
                                                 "bytes": want.bytes, "rows_from_shape": False}
    assert tot["kernels"]["flash_attention_bwd"]["calls"] == 1
    assert tot["flops"] == 0  # the plain version's products are not counted
    assert out.shape == q.shape and [g.shape for g in got] == [q.shape, k.shape, v.shape]
    if not fake:
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        plain = fa_ref.flash_attention_ref(*ts, **kw)
        assert torch.equal(out.detach(), plain.detach())
        assert all(torch.equal(g, w) for g, w in zip(got, _grads(plain, ts)))


@pytest.mark.parametrize("fake", [False, True])
@pytest.mark.parametrize("x_grad", [False, True])
def test_b5_charged_once_forward_and_backward(fake, x_grad):
    rng = np.random.default_rng(4)
    n, e, d = 10, 40, 8
    x_np = rng.standard_normal((n, d)).astype(np.float32)
    src_np, dst_np = (rng.integers(0, n, e).astype(np.int32) for _ in range(2))
    w_np = rng.random(e).astype(np.float32)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        mk = (lambda a: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype)) if fake \
            else torch.from_numpy
        x, src, dst, w = (mk(a) for a in (x_np, src_np, dst_np, w_np))
        x.requires_grad_(x_grad)
        with CostCounter() as counter:
            out = sm_ops.seg_mm(x, src, dst, n, edge_weight=w)
            if x_grad:
                (gx,) = _grads(out, (x,))
    k = counter.totals()["kernels"]
    assert k["seg_mm"] == {"calls": 1, "flops": 2 * e * d,
                           "bytes": e * (8 + 4 * d) + (n + 1) * 4 + n * d * 4,
                           "rows_from_shape": True}
    assert ("seg_mm_transposed" in k) == x_grad
    if x_grad:
        assert k["seg_mm_transposed"]["calls"] == 1 and gx.shape == x.shape
    if not fake:
        assert torch.equal(out.detach(), sm_ref.seg_mm_ref(torch.from_numpy(x_np), src, dst, n,
                                                           edge_weight=w))


@pytest.mark.parametrize("fake", [False, True])
def test_b4_charged_once_forward_and_backward(fake):
    rng = np.random.default_rng(5)
    f, v, d, b, mh = 3, 20, 8, 5, 2
    t_np = rng.standard_normal((f, v, d)).astype(np.float32)
    i_np = rng.integers(-v, v, (b, f, mh)).astype(np.int32)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        if fake:
            tables, idx = torch.empty(f, v, d), torch.empty(b, f, mh, dtype=torch.int32)
        else:
            tables, idx = torch.from_numpy(t_np), torch.from_numpy(i_np)
        tables.requires_grad_(True)
        with CostCounter() as counter:
            out = eb_ops.embedding_bag_fields(tables, idx)
            (g,) = _grads(out, (tables,))
    k = counter.totals()["kernels"]
    assert k["embedding_bag"] == {"calls": 1, "flops": b * f * mh * d,
                                  "bytes": b * f * mh * d * 4 + b * f * mh * 4 + b * f * d * 4,
                                  "rows_from_shape": True}
    assert k["embedding_bag_backward"] == {"calls": 1, "flops": b * f * mh * d,
                                           "bytes": b * f * d * 4 + b * f * mh * 4 + f * v * d * 4,
                                           "rows_from_shape": False}
    assert out.shape == (b, f, d) and g.shape == (f, v, d)
    if not fake:
        assert torch.equal(out.detach(), eb_ref.embedding_bag_ref(torch.from_numpy(t_np), idx))


def test_no_counter_leaves_the_wrappers_as_they_were():
    """With no counter, CPU tensors take the plain versions, uncharged."""
    assert _cost.counter is None
    q = torch.randn(1, 6, 2, 8)
    assert torch.equal(fa_ops.flash_attention(q, q, q), fa_ref.flash_attention_ref(q, q, q))


# ------------------------------------------------------------- steps, real vs fake
def _real(args, seed: int = 0):
    """Random real CPU tensors for abstract args: floats normal·0.02,
    integers 0, booleans True."""
    gen = torch.Generator().manual_seed(seed)

    def one(t):
        if t.is_floating_point():
            return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)
        if t.dtype == torch.bool:
            return torch.ones(t.shape, dtype=torch.bool)
        return torch.zeros(t.shape, dtype=t.dtype)

    return map_tensors(one, args)


def _lm_specs(b, s):
    return {"tokens": sds((b, s), torch.int32), "labels": sds((b, s), torch.int32)}


def _gcn_specs(cfg):
    g = gnn_graph_specs("full_graph_sm", model="gcn")
    return dataclasses.replace(g, x=sds((g.n_nodes, cfg.d_in), torch.float32))


def _dlrm_specs(cfg, rows: int):
    specs = recsys_input_specs(cfg, "train_batch")[1]
    return {k: sds((rows,) + tuple(t.shape[1:]), t.dtype) for k, t in specs.items()}


STEP_CASES = {  # (arch, shape, reduced cfg, its specs)
    "gemma2-train": ("gemma2-9b", "train_4k", gemma2_9b.smoke_config(), _lm_specs(2, 64)),
    "mixtral-train": ("mixtral-8x22b", "train_4k", mixtral_8x22b.smoke_config(),
                      _lm_specs(2, 32)),
    "gcn-train": ("gcn-cora", "full_graph_sm", gcn_cora.smoke_config(),
                  _gcn_specs(gcn_cora.smoke_config())),
    "dlrm-train": ("dlrm-rm2", "train_batch", dlrm_rm2.smoke_config(),
                   _dlrm_specs(dlrm_rm2.smoke_config(), 64)),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_real_step_counts_what_its_fake_trace_counts(name):
    arch, shape, cfg, specs = STEP_CASES[name]
    kind, step, args, _, _, _ = build_cell(arch, shape, ONE, cfg=cfg, specs=specs)
    fake = trace_step(step, args, "cpu")
    real_args = _real(args)
    with CostCounter(arguments=real_args) as counter:
        out = step(*real_args)
    real = counter.totals()
    assert real["flops"] == fake["flops"] > 0
    assert real["kernels"] == fake["kernels"] and fake["kernels"]
    assert np.isfinite(float(out[2]["loss"]))


def test_remat_recompute_counts_once():
    """A dense LM's FLOPs: ``dots`` saves every matmul output, so its
    recompute dispatches none again and it counts what no remat counts;
    ``full`` recomputes the groups' products.  B6's forward runs again in
    both recomputes (it is not a saved product)."""
    base = gemma2_9b.smoke_config()
    got = {}
    for name, kw in (("none", dict(remat=False)), ("full", dict(remat_policy="full")),
                     ("dots", dict(remat_policy="dots"))):
        cfg = dataclasses.replace(base, **kw)
        _, step, args, _, _, _ = build_cell("gemma2-9b", "train_4k", ONE, cfg=cfg,
                                            specs=_lm_specs(2, 64))
        got[name] = trace_step(step, args, "cpu")
    layers = base.n_layers
    assert got["dots"]["flops"] == got["none"]["flops"] < got["full"]["flops"]
    assert got["none"]["kernels"]["flash_attention"]["calls"] == layers
    for name in ("full", "dots"):
        assert got[name]["kernels"]["flash_attention"]["calls"] == 2 * layers
        assert got[name]["kernels"]["flash_attention_bwd"]["calls"] == layers


# ------------------------------------------------------------------------ AdamW
def test_adamw_schedule_bitwise_unchanged_on_real_counts():
    cfg = adamw.AdamWConfig()
    old_step = lambda s: int(s.item()) if torch.is_tensor(s) else int(s)  # noqa: E731
    for s in (0, 1, 7, 99, 100, 101, 5000, 9999, 10000, 12345):
        for t in (torch.tensor(s, dtype=torch.int32), torch.tensor(s), s):
            assert adamw._step(t) == old_step(t) == s
            got = adamw.cosine_schedule(cfg, t)
            assert got.tobytes() == adamw.cosine_schedule(cfg, s).tobytes()
            assert adamw.constant_schedule(cfg, t).tobytes() == \
                adamw.constant_schedule(cfg, s).tobytes()
    rng = np.random.default_rng(6)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    g = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    ref_cfg = ref_adamw.AdamWConfig()
    ref_p, ref_s, ref_m = ref_adamw.apply_updates(p, g, ref_adamw.init_state(p), ref_cfg)
    tp = {"w": torch.from_numpy(p["w"].copy())}
    new_p, new_s, m = adamw.apply_updates(tp, {"w": torch.from_numpy(g["w"])},
                                          adamw.init_state(tp), cfg)
    assert int(new_s["count"]) == int(ref_s["count"]) == 1
    assert float(m["lr"]) == float(ref_m["lr"])
    np.testing.assert_allclose(new_p["w"].numpy(), np.asarray(ref_p["w"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("donate", [False, True])
def test_adamw_update_runs_on_fake_tensors(donate):
    with FakeTensorMode():
        params = {"a": torch.empty(5, 3), "b": [torch.empty(7, dtype=torch.bfloat16)]}
        grads = {"a": torch.empty(5, 3), "b": [torch.empty(7, dtype=torch.bfloat16)]}
        state = adamw.init_state(params)
        new_p, new_s, metrics = adamw.apply_updates(params, grads, state, adamw.AdamWConfig(),
                                                    donate=donate)
    assert [(t.shape, t.dtype) for t in leaves(new_p)] == \
        [(t.shape, t.dtype) for t in leaves(params)]
    assert new_s["count"].dtype == torch.int32 and new_s["count"].shape == ()
    assert all(t.dtype == torch.float32 for t in leaves(new_s["m"]) + leaves(new_s["v"]))
    assert metrics["grad_norm"].shape == ()
