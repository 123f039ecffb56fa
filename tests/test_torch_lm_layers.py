"""The port's LM layers (``nn/layers.py``: rmsnorm, layernorm, mlp, rope,
softcap) against the reference's on the CPU.

The same seeded numpy inputs and params go to both packages; f32 results
agree within 1e-6 (rtol = atol; for ``mlp``, whose matmuls sum in another
order than XLA's, atol is 1e-6 of the output's largest magnitude), and the
bf16 paths (rmsnorm, rope and softcap cast back to the input's dtype)
within one bf16 rounding (rtol 2^-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as R
from repro_torch.nn import layers as P

TOL = dict(rtol=1e-6, atol=1e-6)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm(plus_one):
    x, s = _x(0, (3, 5, 32), 3.0), _x(1, (32,))
    want = R.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), plus_one=plus_one)
    got = P.rmsnorm({"scale": _t(s)}, _t(x), plus_one=plus_one)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert P.init_rmsnorm(32, device="cpu")["scale"].equal(torch.ones(32))


def test_rmsnorm_bf16_input_keeps_its_dtype():
    x, s = _x(2, (4, 64), 2.0), _x(3, (64,))
    want = R.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x, jnp.bfloat16), plus_one=True)
    got = P.rmsnorm({"scale": _t(s)}, _t(x).to(torch.bfloat16), plus_one=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=1e-6)


def test_layernorm():
    x, s, b = _x(4, (6, 48), 2.0), _x(5, (48,)), _x(6, (48,))
    want = R.layernorm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = P.layernorm({"scale": _t(s), "bias": _t(b)}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    init = P.init_layernorm(48, device="cpu")
    assert init["scale"].equal(torch.ones(48)) and init["bias"].equal(torch.zeros(48))


@pytest.mark.parametrize("init", [P.init_rmsnorm, P.init_layernorm])
def test_norm_inits_default_to_the_card_and_refuse_without_it(monkeypatch, init):
    """``device=None`` means the card, as at every other entry point of the
    port (ROADMAP C.15): with no card it raises instead of placing the
    params on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init(16)
    assert all(t.device.type == "cpu" for t in init(16, device="cpu").values())


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_mlp(gated, act):
    d, ff = 16, 40
    p = {"up": {"w": _x(7, (d, ff), 0.3)}, "down": {"w": _x(8, (ff, d), 0.3)}}
    if gated:
        p["gate"] = {"w": _x(9, (d, ff), 0.3)}
    x = _x(10, (2, 7, d), 2.0)
    want = R.mlp({k: {"w": jnp.asarray(v["w"])} for k, v in p.items()}, jnp.asarray(x), act=act)
    got = P.mlp({k: {"w": _t(v["w"])} for k, v in p.items()}, _t(x), act=act)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to approximate=True; the exact erf form
    differs from it by ~1e-4 near |x| = 2."""
    x = np.linspace(-5, 5, 1001).astype(np.float32)
    want = np.asarray(R._act("gelu", jnp.asarray(x)))
    np.testing.assert_allclose(P._act("gelu", _t(x)).numpy(), want, **TOL)
    assert np.abs(torch.nn.functional.gelu(_t(x)).numpy() - want).max() > 1e-4
    with pytest.raises(ValueError):
        P._act("tanh", _t(x))


def test_init_mlp_shapes():
    gen = torch.Generator().manual_seed(0)
    p = P.init_mlp(gen, 8, 24, gated=True)
    assert {k: tuple(v["w"].shape) for k, v in p.items()} == {
        "up": (8, 24), "down": (24, 8), "gate": (8, 24)}
    assert set(P.init_mlp(gen, 8, 24, gated=False)) == {"up", "down"}


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    x = _x(11, (2, 9, 3, 16))
    pos = np.arange(9)[None, :] + np.array([[0], [100]])
    want = R.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    got = P.rope(_t(x), _t(pos), theta=theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_bf16_casts_back():
    x = _x(12, (1, 5, 2, 8))
    pos = np.arange(5)[None, :]
    want = R.rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = P.rope(_t(x).to(torch.bfloat16), _t(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap(cap):
    x = _x(13, (4, 100), 40.0)
    want = R.softcap(jnp.asarray(x), cap)
    got = P.softcap(_t(x), cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_b = P.softcap(_t(x).to(torch.bfloat16), cap)
    assert got_b.dtype == torch.bfloat16
    want_b = R.softcap(jnp.asarray(x, jnp.bfloat16), cap)
    np.testing.assert_allclose(got_b.float().numpy(), np.asarray(want_b, np.float32),
                               rtol=2 ** -8, atol=1e-6)
