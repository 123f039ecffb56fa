"""The port's ``nn/attention.py::attention`` against the reference's on the
CPU, every ``impl`` over causal, window, softcap, GQA, query-offset and
``kv_len`` cases.

The same seeded numpy q, k and v go to both packages; on CPU tensors the
port takes the reference's branch (``flash`` is B6's plain version, no
launch), so each call is held to the same reference call at 2e-5 (the
reference's own agreement tolerance, ``tests/test_models.py``).  One
exception: the reference's ``flash`` drops ``kv_len`` (ROADMAP C.11); the
port honours it on the path ``auto`` picks, and is held to the
reference's ``auto`` there.  Unlike the reference's
``test_attention_impl_agreement``, the flash output is asserted: against
``direct`` on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.attention import attention as ref_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.nn.attention import attention

TOL = dict(rtol=2e-5, atol=2e-5)
IMPLS = ["auto", "direct", "chunked", "flash"]
# (name, (b, sq, skv, hq, hkv, d), kwargs)
CASES = [
    ("causal", (2, 64, 64, 4, 2, 16), dict(causal=True)),
    ("window", (2, 64, 64, 4, 2, 16), dict(causal=True, window=16)),
    ("cap", (2, 64, 64, 4, 2, 16), dict(causal=False, cap=30.0)),
    ("gqa", (1, 64, 64, 8, 2, 32), dict(causal=True, window=24, cap=50.0)),
    ("q_offset", (1, 32, 64, 4, 2, 16), dict(causal=True, window=24, q_offset=32)),
    ("kv_len", (2, 64, 64, 4, 2, 16), dict(causal=True, kv_len=40)),
    ("kv_len_window", (1, 16, 64, 4, 1, 16), dict(causal=True, window=8, q_offset=30,
                                                  kv_len=37)),
]


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, sq, hq, d)) * 0.4).astype(np.float32),
            (rng.standard_normal((b, skv, hkv, d)) * 0.4).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _port(q, k, v, **kw):
    return attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_matches_the_same_reference_call(impl, name, shape, kw):
    q, k, v = _qkv(sum(shape), *shape)
    ops.reset_launches()
    got = _port(q, k, v, impl=impl, chunk=24, **kw)  # 24 does not divide Skv: padding
    assert ops.launches[ops.FLASH_ATTENTION] == 0
    ref_impl = "auto" if (impl == "flash" and "kv_len" in kw) else impl
    want = ref_attention(*(jnp.asarray(a) for a in (q, k, v)), impl=ref_impl, chunk=24, **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("name,shape,kw", CASES[:5], ids=[c[0] for c in CASES[:5]])
def test_flash_agrees_with_direct(name, shape, kw):
    q, k, v = _qkv(sum(shape) + 1, *shape)
    np.testing.assert_allclose(_port(q, k, v, impl="flash", **kw),
                               _port(q, k, v, impl="direct", **kw), **TOL)


def test_auto_takes_chunked_past_its_threshold():
    """Sq·Skv > 1024·2048: ``auto`` is the chunked path, as the reference's."""
    q, k, v = _qkv(3, 1, 1025, 2048, 1, 1, 8)
    kw = dict(causal=True, window=700, cap=50.0)
    got = _port(q, k, v, **kw)
    want = ref_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_unknown_impl_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 8, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="unknown impl"):
        attention(q, k, v, impl="pallas")
