"""The port's embedding_bag (B4) plain version and its wrapper against the
reference's ``embedding_bag_ref`` on the CPU.

The same seeded numpy tables and indices go to both packages; results
agree at rtol 1e-5, atol 1e-6 (the reference test's tolerance; both sum
in f32, perhaps in another order), NaN where and only where the reference
has NaN.  The reference's Pallas kernel does not run on this JAX (ROADMAP
C.1), so its ``ref`` is the oracle; its index semantics are kept: indices
in [-V, -1] wrap, others outside [0, V) give NaN bags, MH = 0 is 0/0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ref import embedding_bag_ref as ref_bag
from repro_torch.kernels import embedding_bag_fields
from repro_torch.kernels.embedding_bag import ops, ref

TOL = dict(rtol=1e-5, atol=1e-6)
REF_SHAPES = [(8, 4, 3, 100, 16), (16, 26, 1, 500, 64), (32, 2, 8, 50, 32)]


def _inputs(seed, b, f, mh, v, d, *, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((f, v, d)).astype(np.float32)
    idx = rng.integers(lo, v if hi is None else hi, (b, f, mh)).astype(np.int32)
    return tables, idx


def _both(tables, idx, dtype=np.float32):
    want = np.asarray(ref_bag(jnp.asarray(tables).astype(dtype), jnp.asarray(idx)),
                      np.float32)
    t = torch.from_numpy(tables)
    if dtype != np.float32:
        t = t.to(torch.bfloat16)
    got = ref.embedding_bag_ref(t, torch.from_numpy(idx))
    return got, want


def _assert_close(got, want):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, **TOL)


@pytest.mark.parametrize("b,f,mh,v,d", REF_SHAPES)
def test_reference_shapes(b, f, mh, v, d):
    got, want = _both(*_inputs(b + f + mh, b, f, mh, v, d))
    assert got.shape == (b, f, d) and got.dtype == torch.float32
    _assert_close(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_seeded_sweep(seed):
    rng = np.random.default_rng(100 + seed)
    b, f, mh = (int(x) for x in rng.integers(1, 20, 3))
    v, d = int(rng.integers(1, 300)), int(rng.integers(1, 70))
    _assert_close(*_both(*_inputs(seed, b, f, mh, v, d)))


def test_repeated_indices_in_long_bags():
    tables, idx = _inputs(3, 12, 5, 9, 4, 16)  # V = 4: every bag repeats rows
    got, want = _both(tables, idx)
    _assert_close(got, want)
    np.testing.assert_allclose(got[0, 0].numpy(), tables[0, idx[0, 0]].mean(0), rtol=1e-6)


def test_wrapped_and_out_of_range_indices():
    v = 30
    tables, idx = _inputs(4, 64, 3, 2, v, 8, lo=-v - 5, hi=v + 5)
    got, want = _both(tables, idx)
    bad = ((idx < -v) | (idx >= v)).any(-1)
    assert bad.any() and (~bad).any() and ((idx < 0) & (idx >= -v)).any()
    assert np.array_equal(np.isnan(got.numpy()).all(-1), bad)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    _assert_close(got, want)
    neg = np.argwhere((idx[..., 0] < 0) & ~bad)[0]
    row = idx[neg[0], neg[1]]
    np.testing.assert_allclose(got[neg[0], neg[1]].numpy(),
                               tables[neg[1], np.where(row < 0, row + v, row)].mean(0), rtol=1e-6)


def test_empty_bags_are_nan_and_empty_batch_is_empty():
    tables, idx = _inputs(5, 3, 2, 0, 10, 4)
    got, want = _both(tables, idx)
    assert np.isnan(want).all() and torch.isnan(got).all()
    got, want = _both(*_inputs(6, 0, 26, 1, 10, 8))
    assert got.shape == want.shape == (0, 26, 8)


@pytest.mark.parametrize("mh", [1, 3])
def test_bfloat16_tables(mh):
    import ml_dtypes

    tables, idx = _inputs(7, 16, 4, mh, 50, 32)
    got, want = _both(tables, idx, ml_dtypes.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want)


@pytest.mark.parametrize("b,f,mh,v,d", REF_SHAPES)
def test_wrapper_on_cpu_tensors_is_the_plain_version(b, f, mh, v, d):
    tables, idx = (torch.from_numpy(a) for a in _inputs(9, b, f, mh, v, d, lo=-v, hi=v + 2))
    ops.reset_launches()
    got = embedding_bag_fields(tables, idx, bt=8)
    want = ref.embedding_bag_ref(tables, idx)
    assert ops.launches[ops.EMBEDDING_BAG] == 0
    assert got.isnan().equal(want.isnan()) and got[~got.isnan()].equal(want[~want.isnan()])


def test_wrapper_rejects_bad_inputs():
    tables, idx = (torch.from_numpy(a) for a in _inputs(10, 4, 2, 1, 10, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        embedding_bag_fields(tables.half(), idx)
    with pytest.raises(TypeError, match="int32"):
        embedding_bag_fields(tables, idx.long())
    with pytest.raises(ValueError, match="want tables"):
        embedding_bag_fields(tables, idx[:, :1])
    with pytest.raises(ValueError, match="want tables"):
        embedding_bag_fields(tables[0], idx)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_fields(tables.transpose(1, 2), idx)
    with pytest.raises(ValueError, match="devices|device"):
        embedding_bag_fields(tables.to("meta"), idx)
