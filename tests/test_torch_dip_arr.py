"""Port ``repro_torch.core.dip_arr`` against ``repro.core.dip_arr``: the
same seeded (entity, attribute) pairs through both packages, every query
impl on both layouts, bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro.core import dip_arr as rda
from repro_torch.core import dip_arr as tda

K, N = 12, 333


def _pairs(seed, nnz=900):
    rng = np.random.default_rng(seed)
    ent = rng.integers(-2, N + 2, nnz)  # out-of-range pairs are dropped
    att = rng.integers(0, K + 1, nnz)
    return ent, att


def _stores(packed, seed=0):
    ent, att = _pairs(seed)
    return (rda.build_dip_arr(ent, att, k=K, n=N, packed=packed),
            tda.build_dip_arr(ent, att, k=K, n=N, packed=packed, device="cpu"))


def _masks(q, seed=1):
    m = np.random.default_rng(seed).random((q, K)) < 0.3
    m[:, 0] = True
    m[-1] = False  # an empty query row
    return m


@pytest.mark.parametrize("packed", [True, False])
def test_build_matches_reference(packed):
    ref, port = _stores(packed)
    assert (port.k, port.n, port.packed) == (ref.k, ref.n, ref.packed)
    np.testing.assert_array_equal(as_np(port.bitmap, words=True), as_np(ref.bitmap))
    ent, att = _pairs(0)
    host = tda.build_dip_arr_host(ent, att, k=K, n=N, packed=packed)
    np.testing.assert_array_equal(host.bitmap, as_np(rda.build_dip_arr_host(
        ent, att, k=K, n=N, packed=packed).bitmap))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("impl", ["scan", "matvec", "kernel"])
def test_query_any_every_impl(packed, impl):
    ref, port = _stores(packed)
    for row in _masks(3):
        np.testing.assert_array_equal(
            as_np(tda.query_any(port, torch.from_numpy(row), impl=impl)),
            as_np(rda.query_any(ref, jnp.asarray(row), impl=impl)))
    masks = _masks(4)
    np.testing.assert_array_equal(
        as_np(tda.query_any_batched(port, torch.from_numpy(masks), impl=impl)),
        as_np(rda.query_any_batched(ref, jnp.asarray(masks), impl=impl)))


def test_packed_words_queries():
    ref, port = _stores(True)
    masks = _masks(5)
    np.testing.assert_array_equal(
        as_np(tda.query_any_batched_words(port, torch.from_numpy(masks)), words=True),
        as_np(rda.query_any_batched_words(ref, jnp.asarray(masks))))
    np.testing.assert_array_equal(
        as_np(tda.query_any_words(port, torch.from_numpy(masks[0])), words=True),
        as_np(rda.query_any_words(ref, jnp.asarray(masks[0]))))
    _, byte = _stores(False)
    with pytest.raises(ValueError, match="packed"):
        tda.query_any_words(byte, torch.from_numpy(masks[0]))
    with pytest.raises(ValueError, match="unknown impl"):
        tda.query_any(port, torch.from_numpy(masks[0]), impl="nope")


@pytest.mark.parametrize("packed", [True, False])
def test_row_and_column_reads(packed):
    ref, port = _stores(packed)
    for e in (0, 31, 32, 200, N - 1):
        np.testing.assert_array_equal(as_np(tda.attrs_of_entity(port, e)),
                                      as_np(rda.attrs_of_entity(ref, jnp.int32(e))))
    for a in range(K):
        np.testing.assert_array_equal(as_np(tda.entities_of_attr(port, a)),
                                      as_np(rda.entities_of_attr(ref, jnp.int32(a))))


@pytest.mark.parametrize("packed", [True, False])
def test_insert_matches_reference(packed):
    ref, port = _stores(packed)
    ent, att = _pairs(5, nnz=50)
    ent, att = ent.clip(0, N - 1), att.clip(0, K - 1)
    np.testing.assert_array_equal(
        as_np(tda.insert(port, ent, att).bitmap, words=True),
        as_np(rda.insert(ref, ent, att).bitmap))
    np.testing.assert_array_equal(as_np(port.bitmap, words=True), as_np(ref.bitmap))  # functional
