"""Port ``repro_torch.kernels.bitmap_query`` against the reference: the
plain versions (the CPU route of every wrapper) against
``repro.kernels.bitmap_query.ref`` and against the Pallas ops run in
interpret mode, bitwise; and the wrappers' checks.  The CUDA kernels are
held to these plain versions on the card in test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro.kernels.bitmap_query import ops as rops
from repro.kernels.bitmap_query import ref as rref
from repro_torch.kernels.bitmap_query import ops, ref

CASES = [(q, k, n) for q in (1, 3, 8) for k in (1, 40) for n in (1, 333, 1000)]


def _inputs(q, k, n, seed=0):
    rng = np.random.default_rng(seed + 7 * q + 13 * k + n)
    bitmap = (rng.random((k, n)) < 0.1).astype(np.int8)
    words = rng.integers(0, 2**32, (k, (n + 31) // 32), dtype=np.uint32)
    masks = rng.random((q, k)) < 0.3
    masks[0, 0] = True  # at least one selected row
    return bitmap, words, masks


@pytest.mark.parametrize("q,k,n", CASES)
def test_byte_plain_matches_reference_and_pallas(q, k, n):
    bitmap, _, masks = _inputs(q, k, n)
    got = as_np(ops.bitmap_query_batched(torch.from_numpy(bitmap), torch.from_numpy(masks)))
    assert got.dtype == bool and got.shape == (q, n)
    np.testing.assert_array_equal(got, as_np(rref.bitmap_query_batched_ref(
        jnp.asarray(bitmap), jnp.asarray(masks))))
    np.testing.assert_array_equal(got, as_np(rops.bitmap_query_batched(
        jnp.asarray(bitmap), jnp.asarray(masks))))
    one = as_np(ops.bitmap_query(torch.from_numpy(bitmap), torch.from_numpy(masks[0])))
    np.testing.assert_array_equal(one, as_np(rref.bitmap_query_ref(
        jnp.asarray(bitmap), jnp.asarray(masks[0]))))


@pytest.mark.parametrize("q,k,n", CASES)
def test_packed_plain_matches_reference_and_pallas(q, k, n):
    _, words, masks = _inputs(q, k, n)
    plane = torch.from_numpy(words.view(np.int32))
    got = as_np(ops.bitmap_query_batched_packed(plane, torch.from_numpy(masks)), words=True)
    assert got.shape == (q, words.shape[1])
    np.testing.assert_array_equal(got, as_np(rref.bitmap_query_batched_packed_ref(
        jnp.asarray(words), jnp.asarray(masks))))
    np.testing.assert_array_equal(got, as_np(rops.bitmap_query_batched_packed(
        jnp.asarray(words), jnp.asarray(masks))))
    one = as_np(ops.bitmap_query_packed(plane, torch.from_numpy(masks[0])), words=True)
    np.testing.assert_array_equal(one, as_np(rops.bitmap_query_packed(
        jnp.asarray(words), jnp.asarray(masks[0]))))


def test_cpu_route_launches_nothing():
    ops.reset_launches()
    _, words, masks = _inputs(2, 5, 64)
    ops.bitmap_query_batched_packed(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(masks))
    assert ops.launches == {ops.PACKED: 0, ops.BYTE: 0}


def test_wrappers_reject_bad_inputs():
    plane = torch.zeros((4, 3), dtype=torch.int32)
    masks = torch.zeros((2, 4), dtype=torch.bool)
    with pytest.raises(TypeError, match="int32"):
        ops.bitmap_query_batched_packed(plane.to(torch.int64), masks)
    with pytest.raises(TypeError, match="bool"):
        ops.bitmap_query_batched_packed(plane, masks.to(torch.uint8))
    with pytest.raises(ValueError, match="select the rows"):
        ops.bitmap_query_batched_packed(plane, masks[:, :3])
    with pytest.raises(ValueError, match="contiguous"):
        ops.bitmap_query_batched_packed(torch.zeros((3, 4), dtype=torch.int32).t(), masks)
    with pytest.raises(TypeError, match="int8"):
        ops.bitmap_query_batched(plane, masks)


def test_bucketed_q_matches_reference():
    assert ops.Q_BUCKETS == rops.Q_BUCKETS
    assert [ops.bucketed_q(q) for q in range(1, 200)] == [rops.bucketed_q(q)
                                                          for q in range(1, 200)]
    with pytest.raises(ValueError):
        ops.bucketed_q(0)

