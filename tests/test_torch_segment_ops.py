"""The port's message-passing primitives (``graph/segment_ops.py``) against
the reference package on the CPU: every function and every ``agg`` and
``mode``, with empty segments (ids that never occur, and segments past
the largest id).  Same seeded numpy inputs through both; float results at
rtol = atol = 1e-6 (the scatters may add in another order), integer and
non-finite results exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import segment_ops as R
from repro_torch.graph import segment_ops as P

TOL = dict(rtol=1e-6, atol=1e-6)
N_SEG = 23  # ids drawn from [0, 17) with holes: segments 17..22 and the holes are empty


def _data(seed, e=120, trailing=(5,), dtype=np.float32, sorted_ids=False):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.array([0, 1, 2, 4, 5, 7, 9, 12, 13, 16]), e).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    if np.issubdtype(dtype, np.integer):
        data = rng.integers(-50, 50, (e,) + trailing).astype(dtype)
    else:
        data = rng.standard_normal((e,) + trailing).astype(dtype)
    return data, ids


def _port(fn, data, ids, *args, **kw):
    return fn(torch.from_numpy(data), torch.from_numpy(ids), *args, **kw).numpy()


def _ref(fn, data, ids, *args, **kw):
    return np.asarray(fn(jnp.asarray(data), jnp.asarray(ids), *args, **kw))


def test_segment_count_equals_segment_sum_of_ones():
    _, ids = _data(9)
    ids = ids.copy()
    ids[::11] = -2  # out-of-range ids are dropped by both
    ids[5::13] = N_SEG
    got = P.segment_count(torch.from_numpy(ids), N_SEG)
    want = R.segment_sum_sorted(jnp.ones(len(ids), jnp.float32), jnp.asarray(ids), N_SEG)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_sum_sorted():
    data, ids = _data(0, sorted_ids=True)
    got = _port(P.segment_sum_sorted, data, ids, N_SEG)
    np.testing.assert_allclose(got, _ref(R.segment_sum_sorted, data, ids, N_SEG), **TOL)
    assert (got[17:] == 0).all() and (got[3] == 0).all()


@pytest.mark.parametrize("trailing", [(), (5,), (2, 3)])
@pytest.mark.parametrize("sorted_ids", [False, True])
def test_segment_mean(trailing, sorted_ids):
    data, ids = _data(1, trailing=trailing, sorted_ids=sorted_ids)
    got = _port(P.segment_mean, data, ids, N_SEG, sorted_ids=sorted_ids)
    want = _ref(R.segment_mean, data, ids, N_SEG, sorted_ids=sorted_ids)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["segment_max", "segment_min"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("trailing", [(), (4,)])
def test_segment_extremes_with_empty_segments(name, dtype, trailing):
    """Empty segments give ∓inf for floats and the integer extremes for
    integers, as ``jax.ops.segment_max/min`` do."""
    data, ids = _data(2, trailing=trailing, dtype=dtype)
    got = _port(getattr(P, name), data, ids, N_SEG)
    want = _ref(getattr(R, name), data, ids, N_SEG)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
    empty = -np.inf if dtype == np.float32 else info.min
    if name == "segment_min":
        empty = np.inf if dtype == np.float32 else info.max
    assert (got[20] == empty).all() and (got[3] == empty).all()


@pytest.mark.parametrize("heads", [None, 3])
def test_segment_softmax(heads):
    data, ids = _data(3, trailing=() if heads is None else (heads,))
    if heads is None:
        want = _ref(R.segment_softmax, data, ids, N_SEG)
    else:  # the reference runs one softmax per head (vmap, as GAT does)
        want = np.asarray(jax.vmap(lambda s: R.segment_softmax(s, jnp.asarray(ids), N_SEG),
                                   in_axes=1, out_axes=1)(jnp.asarray(data)))
    got = _port(P.segment_softmax, data, ids, N_SEG)
    np.testing.assert_allclose(got, want, **TOL)


def test_segment_softmax_of_all_masked_segment():
    """A segment whose scores are all -1e30 (GAT's masked logits) gets a
    uniform softmax in both packages."""
    data, ids = _data(4, trailing=())
    data[ids == 5] = -1e30
    np.testing.assert_allclose(_port(P.segment_softmax, data, ids, N_SEG),
                               _ref(R.segment_softmax, data, ids, N_SEG), **TOL)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_msg_fn", [False, True])
def test_gather_scatter(agg, weighted, with_msg_fn):
    rng = np.random.default_rng(5)
    n, e, d = 30, 90, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, 20, e).astype(np.int32)  # nodes 20.. receive nothing
    w = rng.random(e).astype(np.float32) if weighted else None
    got = P.gather_scatter(torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst), n,
                           msg_fn=torch.tanh if with_msg_fn else None,
                           edge_weight=None if w is None else torch.from_numpy(w), agg=agg)
    want = R.gather_scatter(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), n,
                            msg_fn=jnp.tanh if with_msg_fn else None,
                            edge_weight=None if w is None else jnp.asarray(w), agg=agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[20:] == 0).all()


@pytest.mark.parametrize("mode", ["sym", "rw"])
def test_degree_norm(mode):
    rng = np.random.default_rng(6)
    src = rng.integers(0, 40, 150).astype(np.int32)
    dst = rng.integers(0, 40, 150).astype(np.int32)
    got = P.degree_norm(torch.from_numpy(src), torch.from_numpy(dst), 45, mode=mode)
    want = R.degree_norm(jnp.asarray(src), jnp.asarray(dst), 45, mode=mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["segment", "kernel"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_di(impl, weighted):
    rng = np.random.default_rng(7)
    n, e, d = 50, 200, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    src = np.sort(rng.integers(0, n, e)).astype(np.int32)
    dst = rng.integers(0, n - 5, e).astype(np.int32)
    w = rng.random(e).astype(np.float32) if weighted else None
    t = torch.from_numpy
    got = P.spmm_di(t(x), t(src), t(dst), n, edge_weight=None if w is None else t(w), impl=impl)
    want = R.spmm_di(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), n,
                     edge_weight=None if w is None else jnp.asarray(w), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unknown_agg_and_mode_raise():
    x = torch.zeros((3, 2))
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="agg"):
        P.gather_scatter(x, idx, idx, 3, agg="median")
    with pytest.raises(ValueError, match="mode"):
        P.degree_norm(idx, idx, 3, mode="both")


def test_out_of_range_ids_are_dropped():
    data, ids = _data(8)
    ids = ids.copy()
    ids[::9] = -1
    ids[4::13] = N_SEG + 3
    np.testing.assert_allclose(_port(P.segment_sum_sorted, data, ids, N_SEG),
                               _ref(R.segment_sum_sorted, data, ids, N_SEG), **TOL)
    np.testing.assert_array_equal(_port(P.segment_max, data, ids, N_SEG),
                                  _ref(R.segment_max, data, ids, N_SEG))
