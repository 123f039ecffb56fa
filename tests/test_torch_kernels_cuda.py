"""The hand-written CUDA kernels (bitmap_query B1/B2, neighbor_sample B3,
seg_mm B5) against their plain PyTorch versions on the card, with their
launch counts: bitwise, or for B5's float sums within a bound on
reordered summation (and bitwise run to run).  Needs an NVIDIA
card (marker ``cuda``; skips without one).  Imports neither JAX nor the
reference package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import random_csr
from repro_torch.core import bitplane
from repro_torch.kernels.bitmap_query import ops, ref
from repro_torch.kernels.neighbor_sample import ops as ns_ops
from repro_torch.kernels.neighbor_sample import ref as ns_ref
from repro_torch.kernels.seg_mm import ops as sm_ops
from repro_torch.kernels.seg_mm import ref as sm_ref

CASES = ([(q, k, n) for q in (1, 2, 3, 8, 64) for k in (1, 50, 129) for n in (1, 333, 40_001)]
         + [(9, 300, 100_003), (2, 257, 4099)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _inputs(q, k, n, device):
    rng = np.random.default_rng(q * 1000 + k * 7 + n)
    bitmap = (rng.random((k, n)) < 0.05).astype(np.int8)
    words = rng.integers(0, 2**32, (k, bitplane.n_words(n)), dtype=np.uint32).view(np.int32)
    masks = rng.random((q, k)) < 0.3
    return (torch.from_numpy(bitmap).to(device), torch.from_numpy(words).to(device),
            torch.from_numpy(masks).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("q,k,n", CASES)
def test_kernels_match_plain_versions(cuda, q, k, n):
    bitmap, plane, masks = _inputs(q, k, n, cuda)
    ops.reset_launches()
    got = ops.bitmap_query_batched_packed(plane, masks)
    assert ops.launches[ops.PACKED] == 1
    assert got.equal(ref.bitmap_query_batched_packed_ref(plane, masks))
    got = ops.bitmap_query_batched(bitmap, masks)
    assert ops.launches[ops.BYTE] == 1
    assert got.equal(ref.bitmap_query_batched_ref(bitmap, masks))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_or_reduce_on_card_uses_the_kernel(cuda):
    words = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**32, (6, 5, 7), dtype=np.uint32).view(np.int32))
    ops.reset_launches()
    got = bitplane.or_reduce(words.to(cuda), dim=1)
    assert ops.launches[ops.PACKED] == 1
    assert got.cpu().equal(bitplane.or_reduce(words, dim=1))


B3_CASES = [(r, s, w, f) for r in (1, 3) for s in (1, 17, 1024) for w in (8, 16, 64, 1024)
            for f in (1, 10) if f <= w]


def _window_inputs(r, s, w, ties, device):
    seg, dst, _ok, words, = random_csr(r * 7 + s + w, 500, w)
    rng = np.random.default_rng(s * 31 + w)
    seeds = rng.integers(0, 500, (r, s))
    start = seg[seeds].astype(np.int32)
    deg = np.where(rng.random((r, s)) < 0.9, seg[seeds + 1] - seg[seeds], 0).astype(np.int32)
    pri = rng.random((r, s, w)).astype(np.float32)
    if ties:
        pri = (np.floor(pri * 3) / 3).astype(np.float32)
    row_words = np.stack([np.roll(words, i) for i in range(r)]).view(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(start), t(deg), t(dst), t(words.view(np.int32)), t(row_words), t(pri)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("r,s,w,fanout", B3_CASES)
def test_window_select_matches_plain_version(cuda, r, s, w, fanout, ties):
    start, deg, dst, words, row_words, pri = _window_inputs(r, s, w, ties, cuda)
    for ew in (None, words, row_words):
        ns_ops.reset_launches()
        got = ns_ops.window_select(start, deg, dst, ew, pri, fanout=fanout)
        assert ns_ops.launches[ns_ops.WINDOW_SELECT] == 1
        want = ns_ref.window_select_ref(start, deg, dst, ew, pri, fanout=fanout)
        for g, p in zip(got, want):
            assert g.equal(p)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_neighbor_sample_on_card_equals_cpu_given_the_same_priorities(cuda, monkeypatch):
    seg, dst, _ok, words = random_csr(3, 300, 16)
    drawn = {}

    def draw(key, shape, device):  # the CPU's draw, handed to both devices
        if key not in drawn:
            gen = torch.Generator().manual_seed(int(key))
            drawn[key] = torch.rand(shape, generator=gen)
        return drawn[key].to(device)

    monkeypatch.setattr(ns_ops, "_draw_priorities", draw)
    outs = []
    for device in ("cpu", cuda):
        t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
        ns_ops.reset_launches()
        outs.append(ns_ops.neighbor_sample(t(seg), t(dst), 300, len(dst), np.arange(200), 5,
                                           fanout=6, edge_words=words))
        assert ns_ops.launches[ns_ops.WINDOW_SELECT] == (device != "cpu")
    for a, b in zip(*outs):
        assert a.equal(b.cpu())


B5_CASES = [(d, n, e) for d in (1, 7, 16, 64, 128) for n, e in ((1, 5), (333, 1000), (4000, 30_000))]


def _seg_mm_inputs(d, n, e, device, *, hub=False):
    """Ragged DI edges: unsorted dst with every third row left empty, and
    with ``hub`` a row of degree >= 10,000."""
    rng = np.random.default_rng(d * 1009 + n + e)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[dst % 3 == 2] = dst[dst % 3 == 2] - 1
    if hub:
        dst[: max(10_000, e // 3)] = n // 2 - n // 2 % 3
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.random(e).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(x), t(src), t(dst), t(w)


def _sums_close(got, want, x, src, dst, n, w):
    """Within 1e-5 of the row's Σ|terms|: the bound a reordered float sum
    keeps (the card's plain version adds with atomics, in any order)."""
    scale = sm_ref.seg_mm_ref(x.abs(), src, dst, n, edge_weight=None if w is None else w.abs())
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d,n,e", B5_CASES)
def test_seg_mm_matches_plain_version(cuda, d, n, e, weighted):
    x, src, dst, w = _seg_mm_inputs(d, n, e, cuda)
    w = w if weighted else None
    sm_ops.reset_launches()
    got = sm_ops.seg_mm(x, src, dst, n, edge_weight=w)
    assert sm_ops.launches[sm_ops.SEG_MM] == 1
    assert got.shape == (n, d) and got.dtype == torch.float32
    assert _sums_close(got, sm_ref.seg_mm_ref(x, src, dst, n, edge_weight=w), x, src, dst, n, w)
    empty = torch.ones(n, dtype=torch.bool, device=cuda)
    empty[dst.long()] = False
    assert (got[empty] == 0).all()
    assert got.equal(sm_ops.seg_mm(x, src, dst, n, edge_weight=w))  # run to run: same bits
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 16, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_mm_hub_rows(cuda, d, weighted):
    x, src, dst, w = _seg_mm_inputs(d, 3000, 40_000, cuda, hub=True)
    w = w if weighted else None
    got = sm_ops.seg_mm(x, src, dst, 3000, edge_weight=w)
    assert _sums_close(got, sm_ref.seg_mm_ref(x, src, dst, 3000, edge_weight=w),
                       x, src, dst, 3000, w)
    assert got.equal(sm_ops.seg_mm(x, src, dst, 3000, edge_weight=w))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [7, 16, 128])
def test_seg_mm_on_card_sums_in_the_cpu_plain_versions_order(cuda, d):
    """The kernel walks each row's edges in ascending edge id and rounds
    each product before the add, as ``index_add_`` on the CPU does."""
    x, src, dst, w = _seg_mm_inputs(d, 500, 4000, "cpu")
    want = sm_ref.seg_mm_ref(x, src, dst, 500, edge_weight=w)
    got = sm_ops.seg_mm(x.to(cuda), src.to(cuda), dst.to(cuda), 500, edge_weight=w.to(cuda))
    assert got.cpu().equal(want)


@pytest.mark.cuda
def test_seg_mm_layout_cache_on_card(cuda):
    x, src, dst, w = _seg_mm_inputs(16, 333, 1000, cuda)
    builds = sm_ops.LAYOUTS.builds
    first = sm_ops.seg_mm(x, src, dst, 333, edge_weight=w)
    second = sm_ops.seg_mm(x, src, dst, 333, edge_weight=w)  # the same dst: a cache hit
    assert sm_ops.LAYOUTS.builds == builds + 1 and first.equal(second)
    dst[:10] = 0  # in place: the version moves, the layout is rebuilt
    third = sm_ops.seg_mm(x, src, dst, 333, edge_weight=w)
    assert sm_ops.LAYOUTS.builds == builds + 2
    assert _sums_close(third, sm_ref.seg_mm_ref(x, src, dst, 333, edge_weight=w),
                       x, src, dst, 333, w)


@pytest.mark.cuda
def test_seg_mm_raises_on_the_card_instead_of_falling_back(cuda):
    x, src, dst, w = _seg_mm_inputs(8, 50, 100, cuda)
    with pytest.raises(TypeError):
        sm_ops.seg_mm(x.half(), src, dst, 50)
    with pytest.raises(TypeError):
        sm_ops.seg_mm(x, src.long(), dst, 50)
    with pytest.raises(ValueError, match="devices"):
        sm_ops.seg_mm(x, src.cpu(), dst, 50)


@pytest.mark.cuda
def test_gcn_forward_on_card_matches_cpu(cuda):
    """The slice's model on the card (B5 in both layers, one layout) against
    the port on the CPU, at 1e-4: cuBLAS and CPU matmuls round differently."""
    from repro_torch.configs import gcn_cora
    from repro_torch.data import synthetic_graph_batch
    from repro_torch.models import gcn

    cfg = dataclasses.replace(gcn_cora.full_config(), spmm_impl="kernel")
    b = synthetic_graph_batch(n_nodes=2000, n_edges=9000, d_feat=1433, device="cpu")
    params = gcn.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = gcn.forward(params, b, cfg)
    sm_ops.reset_launches()
    builds = sm_ops.LAYOUTS.builds
    got = gcn.forward({"layers": [{k: v.to(cuda) for k, v in lp.items()}
                                  for lp in params["layers"]]}, b.to(cuda), cfg)
    assert sm_ops.launches[sm_ops.SEG_MM] == 2 and sm_ops.LAYOUTS.builds == builds + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
