"""The port's ``seg_mm`` (B5) and its layout against the reference package
on the CPU.

On the CPU ``seg_mm`` runs its plain version (``ref.seg_mm_ref``); it is
held to the reference's Pallas ``seg_mm`` (interpret mode, as the
reference's own tests run it) and to its ``seg_mm_ref`` at rtol = atol =
1e-5: the sums run in another order than the one-hot matmul's.  Inputs are
seeded numpy arrays handed to both packages.  The layout (the row
pointers of the stable dst order, and src and w in that order) is what the
CUDA kernel reads; its cache is held to never serving a stale layout and
to a bound on its size.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.seg_mm import seg_mm as ref_seg_mm
from repro.kernels.seg_mm.ref import seg_mm_ref as ref_seg_mm_ref
from repro_torch.kernels.seg_mm import ops
from repro_torch.kernels.seg_mm.ref import seg_mm_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, n_src, e, d, *, n_dst=None, sorted_dst=True, weighted=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    src = rng.integers(0, n_src, e).astype(np.int32)
    dst = rng.integers(0, n_src if n_dst is None else n_dst, e).astype(np.int32)
    if sorted_dst:
        dst = np.sort(dst)
    w = rng.random(e).astype(np.float32) if weighted else None
    return x, src, dst, w


def _both(x, src, dst, n, w, **ref_kw):
    """(port seg_mm, reference seg_mm, reference seg_mm_ref) as numpy."""
    t = torch.from_numpy
    got = ops.seg_mm(t(x), t(src), t(dst), n, edge_weight=None if w is None else t(w))
    j = jnp.asarray
    jw = None if w is None else j(w)
    return (got.numpy(), np.asarray(ref_seg_mm(j(x), j(src), j(dst), n, edge_weight=jw, **ref_kw)),
            np.asarray(ref_seg_mm_ref(j(x), j(src), j(dst), n, edge_weight=jw)))


@pytest.mark.parametrize("n,e,d", [(64, 256, 16), (500, 2000, 64), (37, 91, 8),
                                   (1000, 5000, 128)])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_mm_matches_reference(n, e, d, weighted):
    x, src, dst, w = _inputs(n * 7 + e + d, n, e, d, weighted=weighted)
    got, pallas, plain = _both(x, src, dst, n, w, nt=64, ec=64)
    assert got.shape == (n, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_unsorted_dst(weighted):
    x, src, dst, w = _inputs(3, 50, 200, 32, sorted_dst=False, weighted=weighted)
    got, pallas, plain = _both(x, src, dst, 50, w, nt=32, ec=32)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_empty_rows_are_zero():
    x, src, dst, w = _inputs(4, 40, 120, 7, weighted=True)
    dst = (dst // 5) * 5  # only every fifth row receives edges
    got, pallas, plain = _both(x, src, dst, 40, w, nt=16, ec=16)
    empty = np.setdiff1d(np.arange(40), dst)
    assert len(empty) > 20 and (got[empty] == 0).all()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_n_nodes_beyond_max_dst():
    x, src, dst, w = _inputs(5, 30, 100, 16, n_dst=10)
    got, pallas, plain = _both(x, src, dst, 75, w, nt=32, ec=32)
    assert got.shape == (75, 16) and (got[10:] == 0).all()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_zero_edges(weighted):
    """Held to the reference's ``seg_mm_ref`` only: its Pallas wrapper's
    host layout (``build_layout``) raises IndexError on an empty edge list."""
    x, src, dst, w = _inputs(6, 12, 0, 5, weighted=weighted)
    t = torch.from_numpy
    got = ops.seg_mm(t(x), t(src), t(dst), 12, edge_weight=None if w is None else t(w)).numpy()
    plain = np.asarray(ref_seg_mm_ref(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), 12,
                                      edge_weight=None if w is None else jnp.asarray(w)))
    assert got.shape == (12, 5) and (got == 0).all()
    np.testing.assert_array_equal(got, plain)


def test_out_of_range_dst_is_dropped():
    """The reference's segment_sum drops edges whose dst is negative or
    past n_nodes; so do the plain version and the layout."""
    x, src, dst, w = _inputs(7, 20, 80, 4, weighted=True)
    dst = dst.copy()
    dst[::7] = -1
    dst[3::11] = 25
    got, pallas, plain = _both(x, src, dst, 20, w, nt=8, ec=8)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)
    layout = ops.build_layout(torch.from_numpy(dst), 20)
    kept = int(((dst >= 0) & (dst < 20)).sum())
    assert int(layout.row_ptr[-1] - layout.row_ptr[0]) == kept


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_is_stable_csr(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    dst = rng.integers(0, n, int(rng.integers(0, 2000))).astype(np.int32)
    layout = ops.build_layout(torch.from_numpy(dst), n)
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(layout.order.numpy(), order)
    np.testing.assert_array_equal(layout.row_ptr.numpy(),
                                  np.searchsorted(dst[order], np.arange(n + 1)))
    assert layout.order.dtype == torch.int32 and layout.row_ptr.dtype == torch.int32


def test_layout_cache_reuses_the_same_tensor_only():
    cache = ops.LayoutCache()
    dst = torch.from_numpy(np.array([3, 1, 1, 0], np.int32))
    first = cache.get(dst, 5)
    assert cache.get(dst, 5) is first and cache.builds == 1
    assert cache.get(dst.clone(), 5) is not first  # equal contents, another tensor
    assert cache.get(dst, 6) is not first  # another row count
    dst[0] = 2  # an in-place write bumps the version
    fresh = cache.get(dst, 5)
    assert fresh is not first and cache.builds == 4
    np.testing.assert_array_equal(fresh.order.numpy(), [3, 1, 2, 0])


def test_layout_cache_never_serves_a_freed_tensors_layout():
    """Fresh ``dst`` tensors of one shape, each dropped after use (so a
    later one may reuse a freed one's id): every lookup gets the layout of
    its own contents, and the cache never holds more than the last one."""
    cache = ops.LayoutCache()
    rng = np.random.default_rng(0)
    seen_ids = set()
    reused = 0
    for _ in range(40):
        dst = torch.from_numpy(rng.integers(0, 16, 64).astype(np.int32))
        reused += id(dst) in seen_ids
        seen_ids.add(id(dst))
        layout = cache.get(dst, 16)
        np.testing.assert_array_equal(layout.order.numpy(),
                                      np.argsort(dst.numpy(), kind="stable"))
        assert len(cache) == 1
        del dst, layout
        gc.collect()
    assert cache.builds == 40
    assert reused > 0  # the hazard was exercised: some tensor had a freed one's id


def test_seg_mm_on_cpu_launches_nothing():
    x, src, dst, w = _inputs(8, 10, 30, 3, weighted=True)
    ops.reset_launches()
    ops.seg_mm(torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst), 10,
               edge_weight=torch.from_numpy(w))
    assert ops.launches[ops.SEG_MM] == 0


def test_seg_mm_rejects_bad_inputs():
    x, src, dst, w = (torch.from_numpy(a) for a in _inputs(9, 10, 30, 3, weighted=True))
    with pytest.raises(TypeError, match="float32"):
        ops.seg_mm(x.double(), src, dst, 10)
    with pytest.raises(TypeError, match="int32"):
        ops.seg_mm(x, src.long(), dst, 10)
    with pytest.raises(TypeError, match="edge_weight"):
        ops.seg_mm(x, src, dst, 10, edge_weight=w.double())
    with pytest.raises(ValueError, match="edges"):
        ops.seg_mm(x, src, dst, 10, edge_weight=w[:-1])
    with pytest.raises(ValueError, match="want x"):
        ops.seg_mm(x[:, 0], src, dst, 10)
    with pytest.raises(ValueError, match="contiguous"):
        ops.seg_mm(x.t().contiguous().t(), src, dst, 10)
    with pytest.raises(ValueError, match="n_nodes"):
        ops.seg_mm(x, src, dst, -1)


def test_plain_version_equals_segment_sum_order():
    """The plain version sums each row's messages in ascending edge order
    (``index_add_`` on the CPU), the order the CUDA kernel walks: the two
    agree with a sequential numpy loop bit for bit."""
    x, src, dst, w = _inputs(10, 25, 300, 6, sorted_dst=False, weighted=True)
    want = np.zeros((25, 6), np.float32)
    for e in range(len(src)):
        want[dst[e]] += w[e] * x[src[e]]
    got = seg_mm_ref(torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst), 25,
                     edge_weight=torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_layout_carries_src_and_w_in_dst_order(seed, weighted):
    """What the kernel reads: ``src`` (in the layout) and ``w`` (permuted on
    each call) in the stable dst order, so row v's edges are positions
    row_ptr[v]:row_ptr[v+1] of them, in ascending edge id."""
    x, src, dst, w = _inputs(20 + seed, 60, 400, 4, sorted_dst=False, weighted=weighted)
    dst[::9] = -1  # dropped edges sit outside every row
    t = torch.from_numpy
    layout = ops.build_layout(t(dst), 60, t(src))
    order = layout.order.numpy()
    assert layout.src_sorted.dtype == torch.int32
    np.testing.assert_array_equal(layout.src_sorted.numpy(), src[order])
    w_sorted = ops.weights_in_dst_order(layout, None if w is None else t(w))
    if weighted:
        assert w_sorted.dtype == torch.float32
        np.testing.assert_array_equal(w_sorted.numpy(), w[order])
    else:
        assert w_sorted is None
    row_ptr = layout.row_ptr.numpy()
    for v in range(60):
        np.testing.assert_array_equal(layout.src_sorted.numpy()[row_ptr[v]:row_ptr[v + 1]],
                                      src[dst == v])


@pytest.mark.parametrize("change", ["src_other", "src_in_place", "w_other", "w_in_place",
                                    "w_dropped"])
def test_layout_cache_rebuilds_when_src_or_w_changes(change):
    """The cache reuses a layout only for the same ``src`` and ``dst``
    objects, each unmodified since: another ``src`` tensor or an in-place
    write to it builds the layout again.  The weights are not part of it:
    whichever ``w`` a call passes is permuted into the kept order."""
    cache = ops.LayoutCache()
    dst = torch.tensor([3, 1, 1, 0], dtype=torch.int32)
    src = torch.tensor([0, 2, 4, 1], dtype=torch.int32)
    w = torch.tensor([0.5, 0.25, 1.0, 2.0])
    first = cache.get(dst, 5, src)
    assert cache.get(dst, 5, src) is first and cache.builds == 1  # both the same
    if change == "src_other":
        src = src.clone()
    elif change == "src_in_place":
        src[0] = 3
    elif change == "w_other":
        w = w.clone()
    elif change == "w_in_place":
        w[1] = 4.0
    else:
        w = None
    fresh = cache.get(dst, 5, src)
    assert (fresh is first) == change.startswith("w_")
    assert cache.builds == (1 if change.startswith("w_") else 2)
    assert cache.get(dst, 5, src) is fresh
    order = fresh.order.numpy()
    np.testing.assert_array_equal(fresh.src_sorted.numpy(), src.numpy()[order])
    w_sorted = ops.weights_in_dst_order(fresh, w)
    if w is None:
        assert w_sorted is None
    else:
        np.testing.assert_array_equal(w_sorted.numpy(), w.numpy()[order])


@pytest.mark.parametrize("which", ["w", "src", "dst"])
def test_layout_cache_never_reuses_what_it_built_from_an_inference_tensor(which):
    """A tensor made under ``torch.inference_mode`` (the GCN's weights when
    it serves) tracks no version, so an in-place write to it cannot be
    seen: a layout built from an inference ``src`` or ``dst`` is built
    again on every call, and the weights are permuted on every call, so
    each is right after such a write."""
    cache = ops.LayoutCache()
    with torch.inference_mode():
        t = {"dst": torch.tensor([3, 1, 1, 0], dtype=torch.int32),
             "src": torch.tensor([0, 2, 4, 1], dtype=torch.int32),
             "w": torch.tensor([0.5, 0.25, 1.0, 2.0])}
        inference = t[which].clone()
    t = {k: v.clone() for k, v in t.items()}  # normal tensors, versioned
    t[which] = inference
    first = cache.get(t["dst"], 5, t["src"])
    with torch.inference_mode():
        t[which][1] = 2  # unseen by any version counter
        second = cache.get(t["dst"], 5, t["src"])
    assert (second is first) == (which == "w")
    assert cache.builds == (1 if which == "w" else 2)
    order = np.argsort(t["dst"].numpy(), kind="stable")
    np.testing.assert_array_equal(second.order.numpy(), order)
    np.testing.assert_array_equal(second.src_sorted.numpy(), t["src"].numpy()[order])
    np.testing.assert_array_equal(ops.weights_in_dst_order(second, t["w"]).numpy(),
                                  t["w"].numpy()[order])
