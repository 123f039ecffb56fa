"""Gradients of B6 (flash_attention) in the port against ``jax.grad`` of the
reference's trainable attention paths on the CPU.

The reference trains through ``repro.nn.attention._direct`` and
``_chunked`` (its Pallas kernel has no gradient).  The same seeded numpy q,
k, v and output weights w go to ``jax.grad`` of Σ o·w through both and to
the port's three ways of differentiating B6:

* torch autograd of the plain version ``ref.flash_attention_ref`` (the CPU
  path of ``ops.flash_attention``);
* the plain backward ``ref.flash_attention_bwd_ref`` fed the plain
  forward's output and log-sum-exp (the oracle ``chip_smoke.py`` holds the
  CUDA backward to);
* ``ops._FlashAttention`` (the card's autograd Function) with its two
  launchers replaced by the plain versions.

ROADMAP C.23: with ``q_offset < 0`` or a window no key is in reach of, some
query rows have no valid key.  The reference's -1e30 bias leaves them
uniform weights and a gradient that reaches q and k; the ``test_c23_*``
cases hold dq, dk and dv there.  Tolerances: f32 at rtol = atol = 2e-5 of
the largest |gradient| (sums in other orders); bf16 inputs at 2e-2 (the
reference's flash tolerance), against the reference run on the same
bf16-rounded inputs in f32, since the reference's bf16 path rounds P to
bf16 where the port's plain version keeps f32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as ref_attn
from repro_torch.kernels.flash_attention import kernel, ops, ref

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _rand(seed, b, sq, skv, hq, hkv, d, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, hq, d)) * scale).astype(np.float32)
    k = (rng.standard_normal((b, skv, hkv, d)) * scale).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    w = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    return q, k, v, w


def _full(kw):
    return dict(dict(causal=True, window=None, cap=None, q_offset=0), **kw)


def _divisor(skv, chunk):
    """The largest chunk size up to ``chunk`` that divides Skv (Skv itself
    where only 1 does): the reference's ``_chunked`` pads K and V to whole
    chunks, and its padded keys join the uniform weights of a row with no
    valid key (ROADMAP C.24), so rows with none are compared at whole chunks."""
    c = max(x for x in range(1, min(chunk, skv) + 1) if skv % x == 0)
    return skv if c == 1 else c


def _jax_grads(path, q, k, v, w, kw, chunk=None):
    kw = _full(kw)

    def loss(q, k, v):
        if path == "direct":
            o = ref_attn._direct(q, k, v, kv_len=None, **kw)
        else:
            o = ref_attn._chunked(q, k, v, kv_len=None, chunk=_divisor(k.shape[1], chunk), **kw)
        return jnp.sum(o * w)

    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


def _autograd(fn, q, k, v, w, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    o = fn(*ts)
    (o.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


def _plain_bwd(q, k, v, w, kw, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    do = torch.from_numpy(w).to(dtype)
    return [g.float().numpy() for g in ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)]


def _close(got, want, tol):
    for g, x in zip(got, want):
        x = np.asarray(x, np.float32)
        np.testing.assert_allclose(g, x, rtol=tol, atol=tol * max(1.0, float(np.abs(x).max())))


@pytest.fixture
def cpu_launchers(monkeypatch):
    """The card's autograd Function with its launchers replaced by the plain
    versions: the forward writes o and the row log-sum-exp, the backward
    Dᵢ, dq, dk and dv into the tensors ``ops`` allocated; the backward is
    told which forward kernel wrote its log-sum-exp, runs the backward
    kernel ``bwd_variant`` names for it (``bwd_sm90`` after ``sm90``) and,
    on ``bwd_sm90``, gets a cotangent TMA takes."""
    forwards = []

    def launch(q, k, v, o, *, causal, window, cap, q_offset, variant, lse=None):
        assert kernel.KERNEL_DTYPES[variant] == q.dtype
        forwards.append(variant)
        out, row_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap,
                                               q_offset=q_offset, return_lse=True)
        o.copy_(out)
        if lse is not None:
            lse.copy_(row_lse)

    def launch_bwd(q, k, v, o, lse, do, delta, dq, dk, dv, *, causal, window, cap, q_offset,
                   variant, forward):
        assert kernel.BWD_DTYPES[variant] == q.dtype and lse.dtype == torch.float32
        assert forward == forwards[-1] == kernel.variant(q, k, v)
        assert variant == kernel.bwd_variant(q, forward)
        assert (variant == "bwd_sm90") == (forward == "sm90")
        assert variant != "bwd_sm90" or kernel.tma_ready(do)
        assert all(t.is_contiguous() for t in (do, dq, dk, dv, delta))
        delta.copy_((o.float() * do.float()).sum(-1).transpose(1, 2))
        for out, g in zip((dq, dk, dv), ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal, window=window, cap=cap, q_offset=q_offset)):
            out.copy_(g)

    monkeypatch.setattr(kernel, "launch_flash_attention", launch)
    monkeypatch.setattr(kernel, "launch_flash_attention_bwd", launch_bwd)
    ops.reset_launches()
    yield
    ops.reset_launches()


def _function(kw):
    return lambda q, k, v: ops._FlashAttention.apply(q, k, v, _full(kw))


# ------------------------------------------------------------------ C.23
# the probe: rows 0-2 see no key (q_offset = -3, causal), window 4, cap 50
C23_PROBE = ((0, 1, 8, 8, 4, 2, 8), dict(causal=True, window=4, cap=50.0, q_offset=-3))
C23_CASES = [
    C23_PROBE,
    ((1, 1, 12, 20, 4, 2, 16), dict(causal=True, q_offset=-5)),
    ((2, 2, 9, 7, 6, 3, 8), dict(causal=True, window=3, cap=30.0, q_offset=-4)),
    # no key within the window: q_offset past Skv + window - 1 (every row, then some)
    ((3, 1, 6, 10, 2, 1, 8), dict(causal=False, window=3, q_offset=20)),
    ((4, 1, 10, 10, 4, 4, 8), dict(causal=False, window=4, cap=50.0, q_offset=9)),
]


def test_c23_reference_gradient_reaches_rows_with_no_valid_key():
    """The fact C.23 rests on: the reference's dq of a row with no valid
    key is not zero (the uniform softmax's dS = p (dP - D) reaches q)."""
    (seed, b, sq, skv, hq, hkv, d), kw = C23_PROBE
    q, k, v, w = _rand(seed, b, sq, skv, hq, hkv, d)
    dq, _, _ = _jax_grads("direct", q, k, v, w, kw)
    assert np.abs(dq[:, :3]).max() > 1e-2


def test_c24_reference_chunked_path_pads_rows_with_no_valid_key():
    """The reference's ``_chunked`` at a chunk that does not divide Skv
    gives a row with no valid key sum(V) / (chunks · chunk), not the mean
    of V that ``_direct`` (and B6) give: its padded keys carry the same
    -1e30 score as the masked ones."""
    q, k, v, _ = _rand(2, 1, 4, 7, 2, 1, 8)
    kw = _full(dict(causal=True, q_offset=-2))
    direct = np.asarray(ref_attn._direct(q, k, v, **kw))
    padded = np.asarray(ref_attn._chunked(q, k, v, chunk=4, **kw))
    np.testing.assert_allclose(direct[0, :2], np.repeat(v.mean(1), 2, axis=1)[0][None].repeat(2, 0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(padded[0, :2], direct[0, :2] * 7 / 8, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(padded[0, 2:], direct[0, 2:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", range(len(C23_CASES)))
@pytest.mark.parametrize("path", ["direct", "chunked"])
def test_c23_plain_version_gradient_matches_the_reference(case, path):
    (seed, b, sq, skv, hq, hkv, d), kw = C23_CASES[case]
    q, k, v, w = _rand(seed, b, sq, skv, hq, hkv, d)
    want = _jax_grads(path, q, k, v, w, kw, chunk=4)
    fn = lambda q, k, v: ops.flash_attention(q, k, v, **kw)  # noqa: E731  (CPU: the plain version)
    _close(_autograd(fn, q, k, v, w), want, F32_TOL)


@pytest.mark.parametrize("case", range(len(C23_CASES)))
def test_c23_plain_backward_and_function_match_the_reference(case, cpu_launchers):
    (seed, b, sq, skv, hq, hkv, d), kw = C23_CASES[case]
    q, k, v, w = _rand(seed, b, sq, skv, hq, hkv, d)
    want = _jax_grads("direct", q, k, v, w, kw)
    _close(_plain_bwd(q, k, v, w, kw), want, F32_TOL)
    _close(_autograd(_function(kw), q, k, v, w), want, F32_TOL)
    assert ops.launches[ops.FLASH_ATTENTION_BWD] == ops.launches[ops.BWD_COUNTERS["bwd_simt"]] == 1


# ------------------------------------------------------------------ the grid
GRID = [  # (seed, b, sq, skv, hq, hkv, d), kwargs
    ((10, 1, 16, 16, 2, 2, 8), dict(causal=True)),
    ((11, 2, 24, 24, 4, 2, 16), dict(causal=True, window=6, cap=50.0)),
    ((12, 1, 19, 33, 8, 2, 16), dict(causal=True, window=10, q_offset=14)),
    ((13, 1, 20, 13, 4, 1, 40), dict(causal=False, cap=30.0)),
    ((14, 1, 17, 17, 8, 8, 8), dict(causal=False, window=5, cap=50.0)),
    ((15, 2, 11, 21, 6, 3, 24), dict(causal=True, cap=50.0, q_offset=-2)),
    ((16, 1, 30, 30, 16, 8, 16), dict(causal=True, window=7, cap=50.0, q_offset=-6)),
    # D no multiple of 8: the mma forward in bf16, whose scores the backward is told of
    ((17, 1, 14, 18, 4, 2, 12), dict(causal=True, window=6, cap=30.0, q_offset=-3)),
]


@functools.lru_cache(maxsize=None)
def _grid_want(case, path):
    """``jax.grad`` of the reference for GRID[case] (f32), once per session."""
    (seed, b, sq, skv, hq, hkv, d), kw = GRID[case]
    q, k, v, w = _rand(seed, b, sq, skv, hq, hkv, d, scale=1.5)
    return _jax_grads(path, q, k, v, w, kw, chunk=8)


@pytest.mark.parametrize("case", range(len(GRID)))
@pytest.mark.parametrize("path", ["direct", "chunked"])
@pytest.mark.parametrize("how", ["autograd", "plain_backward", "function"])
def test_gradients_match_the_reference_f32(case, path, how, cpu_launchers):
    (seed, b, sq, skv, hq, hkv, d), kw = GRID[case]
    q, k, v, w = _rand(seed, b, sq, skv, hq, hkv, d, scale=1.5)
    want = _grid_want(case, path)
    if how == "autograd":
        got = _autograd(lambda q, k, v: ref.flash_attention_ref(q, k, v, **kw), q, k, v, w)
    elif how == "plain_backward":
        got = _plain_bwd(q, k, v, w, kw)
    else:
        got = _autograd(_function(kw), q, k, v, w)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("case", range(len(GRID)))
@pytest.mark.parametrize("how", ["plain_backward", "function"])
def test_gradients_match_the_reference_bf16(case, how, cpu_launchers):
    (seed, b, sq, skv, hq, hkv, d), kw = GRID[case]
    q, k, v, w = _rand(seed + 100, b, sq, skv, hq, hkv, d, scale=1.5)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (q, k, v))
    want = _jax_grads("direct", q, k, v, w, kw)
    if how == "plain_backward":
        got = _plain_bwd(q, k, v, w, kw, dtype=torch.bfloat16)
    else:
        got = _autograd(_function(kw), q, k, v, w, dtype=torch.bfloat16)
        forward, backward = ("mma", "bwd_mma") if d % 8 else ("sm90", "bwd_sm90")
        assert ops.launches[ops.COUNTERS[forward]] == ops.launches[ops.BWD_COUNTERS[backward]] == 1
    _close(got, want, BF16_TOL)


def test_plain_backward_is_autograd_of_the_plain_forward_in_f64():
    """In float64 the written-out backward equals autograd of the plain
    forward to rounding, rows with no valid key included."""
    q, k, v, w = _rand(20, 2, 13, 17, 6, 2, 12, scale=2.0)
    kw = dict(causal=True, window=5, cap=30.0, q_offset=-3)
    ts = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v)]
    o, lse = ref.flash_attention_ref(*ts, return_lse=True, **kw)
    assert o.dtype == lse.dtype == torch.float64 and lse.shape == (2, 6, 13)
    do = torch.from_numpy(w).double()
    (o * do).sum().backward()
    got = ref.flash_attention_bwd_ref(*(t.detach() for t in ts), o.detach(), lse.detach(), do,
                                      **kw)
    for g, t in zip(got, ts):
        torch.testing.assert_close(g, t.grad, rtol=1e-10, atol=1e-12)


def test_lse_is_the_row_logsumexp_and_minus_1e30_on_rows_with_no_key():
    q, k, v, _ = _rand(21, 1, 6, 9, 2, 1, 8)
    kw = dict(causal=True, window=3, q_offset=-2)
    _, lse = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), return_lse=True,
                                     **kw)
    assert torch.all(lse[:, :, :2] == ref.NEG_INF)
    s = np.einsum("qhd,khd->hqk", q[0], np.repeat(k[0], 2, axis=1)) * 8 ** -0.5
    i, j = np.arange(6)[:, None] - 2, np.arange(9)[None, :]
    s = np.where((i >= j) & (i - j < 3), s, -np.inf)
    want = np.log(np.exp(s[:, 2:]).sum(-1))
    np.testing.assert_allclose(lse[0, :, 2:].numpy(), want, rtol=1e-6, atol=1e-6)


def test_function_forward_saves_the_log_sum_exp_and_backward_casts_the_cotangent(cpu_launchers):
    """The Function launches the forward with its lse only when a gradient
    is taken, and hands the backward a contiguous cotangent in q's dtype."""
    q, k, v, w = _rand(22, 1, 10, 10, 4, 2, 16)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v)]
    o = _function(dict(causal=True, window=None, cap=None, q_offset=0))(*ts)
    assert o.dtype == torch.bfloat16 and o.grad_fn is not None
    do = torch.from_numpy(w).transpose(1, 2).contiguous().transpose(1, 2)  # f32, strided
    o.backward(do)
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16 for t in ts)
    assert ops.launches[ops.FLASH_ATTENTION] == 1 and ops.launches[ops.FLASH_ATTENTION_BWD] == 1


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_function_copies_a_cotangent_tma_refuses_for_bwd_sm90(offset, cpu_launchers):
    """A contiguous cotangent whose base lies ``offset`` bf16 elements into
    a larger buffer (not 16-byte aligned unless 0 or 8) reaches the
    ``bwd_sm90`` launcher as an aligned copy of the same values; the
    gradients equal those of an aligned cotangent."""
    q, k, v, w = _rand(23, 1, 12, 12, 4, 2, 16)
    grads = []
    for off in (0, offset):
        ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v)]
        o = _function(dict(causal=True, cap=30.0))(*ts)
        buf = torch.zeros(w.size + off, dtype=torch.bfloat16)
        do = buf[off:].view(w.shape)
        do.copy_(torch.from_numpy(w))
        assert do.is_contiguous() and (do.data_ptr() % 16 == 0) == (off % 8 == 0)
        ops.reset_launches()
        o.backward(do)
        assert ops.launches[ops.BWD_COUNTERS["bwd_sm90"]] == 1
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
