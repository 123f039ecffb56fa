"""Port ``repro_torch.core.bitplane`` against ``repro.core.bitplane``: the
same seeded bits packed and unpacked by both, bitwise; tail bits zero; the
OR reduction."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro.core import bitplane as rbp
from repro_torch.core import bitplane as tbp

SIZES = [1, 5, 31, 32, 33, 64, 100, 1000]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_unpack_matches_reference(n, lead):
    bits = np.random.default_rng(n).random(lead + (n,)) < 0.4
    ref_words = np.asarray(rbp.pack_mask(jnp.asarray(bits)))
    words = tbp.pack_mask(torch.from_numpy(bits))
    assert words.dtype == torch.int32 and tuple(words.shape) == lead + (tbp.n_words(n),)
    np.testing.assert_array_equal(as_np(words, words=True), ref_words)
    np.testing.assert_array_equal(tbp.pack_bits_host(bits), rbp.pack_bits_host(bits))
    np.testing.assert_array_equal(tbp.unpack_mask(words, n).numpy(), bits)
    np.testing.assert_array_equal(tbp.unpack_bits_host(ref_words, n), bits)
    np.testing.assert_array_equal(tbp.unpack_bits_host(as_np(words), n), bits)


@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_tail_bits_zero(n):
    words = as_np(tbp.pack_mask(torch.ones(n, dtype=torch.bool)), words=True)
    tail = n % tbp.WORD
    if tail:
        assert words[-1] == (1 << tail) - 1
    assert (words[:-1] == 0xFFFFFFFF).all()
    assert tbp.pack_bits_host(np.ones(n, bool))[-1] == words[-1]


def test_bit31_round_trips():
    """Bit 31 is the int32 sign bit: the pack must not overflow on it and
    the unpack must not smear it (arithmetic shift + ``& 1``)."""
    bits = np.zeros(64, bool)
    bits[31] = bits[63] = bits[32] = True
    words = tbp.pack_mask(torch.from_numpy(bits))
    np.testing.assert_array_equal(as_np(words, words=True),
                                  np.array([1 << 31, (1 << 31) | 1], np.uint32))
    np.testing.assert_array_equal(tbp.unpack_mask(words, 64).numpy(), bits)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_or_reduce_matches_reference(dim):
    words = np.random.default_rng(dim).integers(0, 2**32, (4, 5, 7), dtype=np.uint32)
    ref = np.asarray(rbp.or_reduce(jnp.asarray(words), axis=dim))
    got = tbp.or_reduce(torch.from_numpy(words.view(np.int32)), dim=dim)
    np.testing.assert_array_equal(as_np(got, words=True), ref)
    np.testing.assert_array_equal(as_np(got, words=True), np.bitwise_or.reduce(words, axis=dim))


def test_n_words_and_layout_flag(monkeypatch):
    assert [tbp.n_words(n) for n in (0, 1, 32, 33)] == [rbp.n_words(n) for n in (0, 1, 32, 33)]
    monkeypatch.delenv("REPRO_PG_BYTE_MASKS", raising=False)
    assert tbp.packed_default()
    with tbp.byte_masks():
        assert not tbp.packed_default()
        with tbp.byte_masks(False):
            assert tbp.packed_default()
    monkeypatch.setenv("REPRO_PG_BYTE_MASKS", "1")
    assert not tbp.packed_default()
