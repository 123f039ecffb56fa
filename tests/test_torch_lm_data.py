"""The port's ``data/lm.py::lm_batch`` on the CPU: shapes, dtype, range,
the next-token label shift, and determinism per (seed, step).

The reference draws with JAX's threefry keys and the port with a
``torch.Generator``, so the tokens themselves differ (the parity tests
build tokens with numpy); the contract — int32 (batch, seq) tokens
uniform in [0, vocab), labels the tokens shifted by one, a pure function
of (seed, step) — is checked on both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.lm import lm_batch as ref_lm_batch
from repro_torch.data import lm_batch


@pytest.mark.parametrize("batch,seq,vocab", [(1, 1, 2), (4, 32, 512), (3, 257, 256000)])
def test_shapes_dtype_range_and_shift(batch, seq, vocab):
    b = lm_batch(3, batch=batch, seq=seq, vocab=vocab, seed=1, device="cpu")
    ref = ref_lm_batch(3, batch=batch, seq=seq, vocab=vocab, seed=1)
    for k in ("tokens", "labels"):
        assert b[k].shape == (batch, seq) == ref[k].shape
        assert b[k].dtype == torch.int32 and ref[k].dtype == jnp.int32
        assert int(b[k].min()) >= 0 and int(b[k].max()) < vocab
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    np.testing.assert_array_equal(np.asarray(ref["tokens"])[:, 1:],
                                  np.asarray(ref["labels"])[:, :-1])


def test_deterministic_per_seed_and_step():
    kw = dict(batch=4, seq=64, vocab=1000, device="cpu")
    a = lm_batch(5, seed=0, **kw)
    assert all(torch.equal(a[k], lm_batch(5, seed=0, **kw)[k]) for k in a)
    assert not torch.equal(a["tokens"], lm_batch(6, seed=0, **kw)["tokens"])
    assert not torch.equal(a["tokens"], lm_batch(5, seed=1, **kw)["tokens"])


def test_tokens_cover_the_vocab_uniformly():
    toks = lm_batch(0, batch=64, seq=1024, vocab=16, device="cpu")["tokens"]
    counts = torch.bincount(toks.flatten().long(), minlength=16).numpy()
    expected = toks.numel() / 16
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 37.7  # chi-square, 15 degrees of freedom, p = 0.001


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_batch(0, batch=1, seq=4, vocab=8)
