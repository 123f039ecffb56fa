"""Port ``repro_torch.kernels.bitmap_query`` against the reference: the
plain versions (the CPU route of every wrapper) against
``repro.kernels.bitmap_query.ref`` and against the Pallas ops run in
interpret mode, bitwise; and the wrappers' checks.  The CUDA kernels are
held to these plain versions on the card in test_torch_kernels_cuda.py.

ROADMAP C.16: on bytes other than 0 and 1 the reference splits.  Its
plain ``bitmap_query_batched_ref`` and the store's ``query_any_scan`` OR
the nonzero bytes (the paper's §VI semantics); its Pallas kernel counts
(``mask @ bitmap > 0.5``).  The port keeps the OR; the split is pinned
here, not hidden."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np
from repro.core import dip_arr as rdip
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


def _sparse_selects(how, q, k, rng):
    """(Q, K) selects of a few rows, as on the main path (1-3 of 50):
    ``one`` row for all, ``none``, rows only past the first 256, or
    ``per_group``: each group of 8 queries its own 3 rows (some queries
    none)."""
    masks = np.zeros((q, k), bool)
    if how == "one":
        masks[:, rng.integers(0, k)] = True
    elif how == "second_tile":
        rows = 256 + rng.permutation(k - 256)[:3]
        masks[:, rows] = rng.random((q, 3)) < 0.7
        masks[0, rows[0]] = True
    elif how == "per_group":
        for g in range(0, q, 8):
            masks[g:g + 8, rng.permutation(k)[:3]] = rng.random((min(8, q - g), 3)) < 0.5
    return masks


@pytest.mark.parametrize("cols", [1, 31, 1000])
@pytest.mark.parametrize("how,q,k", [("one", 1, 50), ("one", 2, 50), ("none", 2, 50),
                                     ("second_tile", 3, 300), ("per_group", 9, 50),
                                     ("per_group", 64, 300)])
def test_plain_versions_match_reference_on_sparse_selects(how, q, k, cols):
    rng = np.random.default_rng(q * 31 + k + cols)
    masks = _sparse_selects(how, q, k, rng)
    words = rng.integers(0, 2**32, (k, cols), dtype=np.uint32)
    bitmap = (rng.random((k, cols)) < 0.1).astype(np.int8)
    got = as_np(ops.bitmap_query_batched_packed(torch.from_numpy(words.view(np.int32)),
                                                torch.from_numpy(masks)), words=True)
    np.testing.assert_array_equal(got, as_np(rref.bitmap_query_batched_packed_ref(
        jnp.asarray(words), jnp.asarray(masks))))
    assert (got[~masks.any(1)] == 0).all()  # a query selecting nothing gives zeros
    got = as_np(ops.bitmap_query_batched(torch.from_numpy(bitmap), torch.from_numpy(masks)))
    np.testing.assert_array_equal(got, as_np(rref.bitmap_query_batched_ref(
        jnp.asarray(bitmap), jnp.asarray(masks))))


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



# ROADMAP C.16: the input on which the reference's byte queries split
C16_BITMAP = np.array([[-1, 2, 0, 1], [1, -1, 0, 0]], np.int8)
C16_MASKS = np.array([[True, False], [True, True]])


def _byte_answers(bitmap, masks):
    """The port's byte query, the reference's plain version, its store's
    ``query_any_scan`` (one query at a time) and its Pallas kernel in
    interpret mode, as numpy bool arrays."""
    port = as_np(ops.bitmap_query_batched(torch.from_numpy(bitmap), torch.from_numpy(masks)))
    jb, jm = jnp.asarray(bitmap), jnp.asarray(masks)
    dip = rdip.DIPArr(bitmap=jb, k=bitmap.shape[0], n=bitmap.shape[1], packed=False)
    scan = np.stack([as_np(rdip.query_any_scan(dip, jm[i])) for i in range(masks.shape[0])])
    return (port, as_np(rref.bitmap_query_batched_ref(jb, jm)), scan,
            as_np(rops.bitmap_query_batched(jb, jm)))


def _c16_inputs(case):
    if case == "roadmap":
        return C16_BITMAP, C16_MASKS
    rng = np.random.default_rng(16)
    q, k, n = (3, 7, 300) if case == "wide" else (2, 50, 1000)
    values = np.array([0, 0, 0, 0, -128, -1, 2] if case == "wide" else [0, 0, 0, 1], np.int8)
    masks = rng.random((q, k)) < 0.4
    masks[0, 0] = True
    return rng.choice(values, size=(k, n)), masks


@pytest.mark.parametrize("case", ["roadmap", "wide"])
def test_c16_bytes_beyond_0_and_1_follow_the_or_of_nonzero_bytes(case):
    """On bytes -128, -1 and 2 the port equals the reference's plain version
    and ``query_any_scan``, and differs from its Pallas kernel exactly
    where the selected bytes are nonzero but their sum is not above 0.5."""
    bitmap, masks = _c16_inputs(case)
    port, plain, scan, pallas = _byte_answers(bitmap, masks)
    np.testing.assert_array_equal(port, plain)
    np.testing.assert_array_equal(port, scan)
    counts = masks.astype(np.float32) @ bitmap.astype(np.float32)
    np.testing.assert_array_equal(pallas, counts > 0.5)
    assert not np.array_equal(port, pallas)  # the split is recorded, not hidden
    np.testing.assert_array_equal(port & ~pallas, port != (counts > 0.5))
    if case == "roadmap":
        np.testing.assert_array_equal(port, [[1, 1, 0, 1], [1, 1, 0, 1]])
        np.testing.assert_array_equal(pallas, [[0, 1, 0, 1], [0, 1, 0, 1]])


@pytest.mark.parametrize("case", ["store_bytes"])
def test_c16_store_bytes_agree_everywhere(case):
    """On the bytes the store writes (0 and 1) every byte query agrees."""
    bitmap, masks = _c16_inputs(case)
    port, plain, scan, pallas = _byte_answers(bitmap, masks)
    for other in (plain, scan, pallas):
        np.testing.assert_array_equal(port, other)
