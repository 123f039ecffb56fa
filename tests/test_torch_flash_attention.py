"""The port's flash_attention (B6) wrapper and plain version against the
reference on the CPU.

The same seeded numpy q, k and v go to the reference's
``flash_attention_ref`` and to its Pallas kernel in interpret mode
(``flash_attention_pallas(..., interpret=True)``, as the reference's own
tests run it here), and to the port's ``ops.flash_attention`` (on CPU
tensors: the plain version, no launch).  Tolerances are the reference
test's (``tests/test_kernels.py``): 2e-5 in f32, 2e-2 in bf16.  The Pallas
kernel needs Sq and Skv divisible by its tiles, so ragged lengths are held
to ``flash_attention_ref`` only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_fa
from repro_torch.kernels.flash_attention import flash_attention, ops, ref

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# (b, sq, skv, hq, hkv, d, kwargs); the first four are test_kernels.py's
PALLAS_CASES = [
    (2, 128, 128, 4, 2, 32, dict(causal=True)),
    (1, 256, 256, 8, 8, 64, dict(causal=True, window=64)),
    (1, 128, 128, 4, 1, 32, dict(causal=False, cap=50.0)),
    (2, 128, 128, 8, 4, 64, dict(causal=True, window=32, cap=30.0)),
    (1, 64, 128, 4, 2, 32, dict(causal=True, window=48, q_offset=64)),  # q_offset > 0
    (1, 64, 64, 18, 2, 16, dict(causal=True, cap=50.0)),  # GQA, G = 9
    (1, 64, 64, 2, 1, 256, dict(causal=True, window=16, cap=50.0)),  # D = 256
]
RAGGED_CASES = [
    (1, 77, 131, 4, 2, 16, dict(causal=True)),
    (2, 33, 70, 6, 3, 40, dict(causal=True, window=9, cap=50.0, q_offset=37)),
    (1, 100, 3, 2, 2, 8, dict(causal=False, window=2)),
    (1, 5, 257, 4, 1, 24, dict(causal=True, window=100, q_offset=252)),
]


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, hq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, skv, hkv, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype=torch.float32, **kw):
    ops.reset_launches()
    out = flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), **kw)
    assert ops.launches[ops.FLASH_ATTENTION] == 0  # CPU tensors: the plain version
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kw", PALLAS_CASES)
def test_matches_reference_and_pallas_interpret(b, sq, skv, hq, hkv, d, kw):
    q, k, v = _qkv(sq + d + hq, b, sq, skv, hq, hkv, d)
    got = _port(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(ref_fa(jq, jk, jv, **kw)), **F32)
    pallas = flash_attention_pallas(jq, jk, jv, bq=64, bkv=64, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kw", RAGGED_CASES)
def test_ragged_lengths_match_reference(b, sq, skv, hq, hkv, d, kw):
    q, k, v = _qkv(sq * 3 + skv, b, sq, skv, hq, hkv, d)
    got = _port(q, k, v, **kw)
    want = np.asarray(ref_fa(*(jnp.asarray(a) for a in (q, k, v)), **kw))
    np.testing.assert_allclose(got, want, **F32)


def test_row_with_no_valid_key_is_the_mean_of_v():
    """causal, window 4, q_offset 100 over 64 keys: every row has no valid
    key; the reference (ref and Pallas) returns v's mean over all keys."""
    kw = dict(causal=True, window=4, q_offset=100)
    q, k, v = _qkv(5, 1, 64, 64, 4, 2, 32)
    got = _port(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    mean = np.repeat(v.mean(axis=1, keepdims=True), 2, axis=2)  # (1, 1, Hq, D), G = 2
    np.testing.assert_allclose(got, np.broadcast_to(mean, got.shape), **F32)
    np.testing.assert_allclose(got, np.asarray(ref_fa(jq, jk, jv, **kw)), **F32)
    pallas = flash_attention_pallas(jq, jk, jv, bq=64, bkv=64, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)


def test_some_rows_without_a_valid_key():
    """Rows past the window of the last key mix with rows that see keys."""
    kw = dict(causal=True, window=8, q_offset=60)
    q, k, v = _qkv(6, 1, 20, 64, 2, 1, 16)
    got = _port(q, k, v, **kw)
    want = np.asarray(ref_fa(*(jnp.asarray(a) for a in (q, k, v)), **kw))
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got[0, 19], np.repeat(v.mean(axis=1)[0], 2, axis=0), **F32)


@pytest.mark.parametrize("kw", [dict(), dict(causal=True, window=32, cap=50.0)])
def test_bf16_matches_reference_and_pallas_interpret(kw):
    """test_kernels.py's bf16 case: inputs rounded to bf16 on both sides."""
    rng = np.random.default_rng(1)
    shapes = ((1, 128, 4, 32), (1, 128, 2, 32), (1, 128, 2, 32))
    q, k, v = (jnp.asarray(rng.standard_normal(s), jnp.bfloat16) * sc
               for s, sc in zip(shapes, (0.3, 0.3, 1.0)))
    want = np.asarray(ref_fa(q, k, v, **kw), np.float32)
    got = flash_attention(*(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                            for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, **BF16)
    pallas = flash_attention_pallas(q, k, v, bq=64, bkv=64, interpret=True, **kw)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(pallas, np.float32),
                               **BF16)


def test_plain_version_is_the_wrapper_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 16, 16, 4, 2, 8))
    kw = dict(causal=True, window=5, cap=20.0, q_offset=3)
    assert torch.equal(flash_attention(q, k, v, bq=7, bkv=3, **kw),
                       ref.flash_attention_ref(q, k, v, **kw))


def test_plain_version_in_float64_matches_reference():
    """float64 inputs are computed in float64 (the card check of f32 B6 at
    large scores holds it to that): the same function as the reference's
    f32 evaluation within its f32 tolerance."""
    q, k, v = _qkv(9, 1, 64, 64, 4, 2, 32)
    kw = dict(causal=True, window=24, cap=30.0, q_offset=5)
    got = ref.flash_attention_ref(*(torch.from_numpy(a).double() for a in (q, k, v)), **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_fa(q, k, v, **kw)), **F32)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 16, 16, 4, 2, 8))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="want q"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="want q"):
        flash_attention(q, k, v[:, :8])
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="batch and D"):
        flash_attention(q[..., :4], k, v)
    with pytest.raises(ValueError, match="devices"):
        flash_attention(q, k.to("meta"), v)
    # inputs with no data (the dry run's meta or fake tensors): an empty output of q's shape
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
