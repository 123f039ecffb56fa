"""The hand-written CUDA kernels (bitmap_query B1/B2, neighbor_sample B3,
embedding_bag B4, seg_mm B5, flash_attention B6) against their plain
PyTorch versions on the card, with their launch counts: bitwise, or for
B5's float sums within a bound on reordered summation (and bitwise run to
run), or for B6 within the reference's attention tolerances (2e-5 in f32,
2e-2 in bf16; f32 scores at the softcap's scale are held to the plain
version in float64), each B6 case on the kernel ``kernel.variant`` names
(wgmma/TMA, mma.sync or SIMT) and counted under its name; B5 on src ids
outside [0, N), which read the reference's rows; DLRM's retrieval ties in
index order; and the routing that sends the card's GCN (B5), attention
(B6) and transformer through them.  Needs an NVIDIA
card (marker ``cuda``; skips without one).  Imports neither JAX nor the
reference package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import random_csr
from repro_torch.core import bitplane
from repro_torch.kernels.bitmap_query import ops, ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.neighbor_sample import ops as ns_ops
from repro_torch.kernels.neighbor_sample import ref as ns_ref
from repro_torch.kernels.seg_mm import ops as sm_ops
from repro_torch.kernels.seg_mm import ref as sm_ref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

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
@pytest.mark.parametrize("cols", [1, 31, 4099, 100_003])
@pytest.mark.parametrize("how,q,k", chip_smoke.SPARSE_SELECT_CASES)
def test_kernels_with_few_selected_rows(cuda, how, q, k, cols):
    """B1 compacts the rows some query of a group selects and reads only
    those; B2 reads all: both bitwise equal to their plain versions."""
    gen = torch.Generator().manual_seed(q * 7 + k + cols)
    masks = chip_smoke.sparse_selects(how, q, k, gen).to(cuda)
    rng = np.random.default_rng(cols)
    plane = torch.from_numpy(rng.integers(0, 2**32, (k, cols), dtype=np.uint32)
                             .view(np.int32)).to(cuda)
    bitmap = torch.from_numpy((rng.random((k, cols)) < 0.05).astype(np.int8)).to(cuda)
    ops.reset_launches()
    assert ops.bitmap_query_batched_packed(plane, masks).equal(
        ref.bitmap_query_batched_packed_ref(plane, masks))
    assert ops.bitmap_query_batched(bitmap, masks).equal(
        ref.bitmap_query_batched_ref(bitmap, masks))
    assert ops.launches == {ops.PACKED: 1, ops.BYTE: 1}
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
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("w", [16, 1024, 2048])
@pytest.mark.parametrize("r,s", [(1, 1), (1, 300), (8, 300), (1, 65_536), (8, 4096)])
def test_window_select_mixed_windows(cuda, r, s, w, ties):
    """One call mixing Poisson(1) windows (one thread each), mid-size ones
    and hubs (a warp each: held in registers up to 1,024 lanes, re-read
    past that), windows cut by m and fully filtered ones."""
    gen = torch.Generator().manual_seed(r * 100_003 + s + w)
    start, deg, dst, words, pri = (t.to(cuda) for t in chip_smoke.mixed_windows(r, s, w, gen,
                                                                                ties))
    for ew in (None, words[0].contiguous(), words):
        for fanout in (f for f in (1, 10, 15, 16, 17) if f <= w):  # staged rows up to 16
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
@pytest.mark.parametrize("bad", [500, 505, -502, -1])
def test_seg_mm_out_of_range_src_reads_the_reference_rows(cuda, bad):
    """src ids outside [0, N) read what the reference's gather reads (wrap
    in [-N, -1], else clamp), as the plain version does: the card never
    reads outside x, and the sums equal the CPU plain version's bits."""
    x, src, dst, w = _seg_mm_inputs(16, 500, 4000, "cpu")
    src[::97] = bad
    for weight in (None, w):
        want = sm_ref.seg_mm_ref(x, src, dst, 500, edge_weight=weight)
        got = sm_ops.seg_mm(x.to(cuda), src.to(cuda), dst.to(cuda), 500,
                            edge_weight=None if weight is None else weight.to(cuda))
        torch.cuda.synchronize()
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


B4_CASES = [(8, 4, 3, 100, 16), (16, 26, 1, 500, 64), (32, 2, 8, 50, 32),  # the reference test's
            (1, 1, 1, 1, 1), (5, 3, 2, 40, 7), (7, 5, 4, 30, 300), (600, 26, 1, 1000, 64),
            (3, 2, 0, 10, 8), (0, 26, 1, 10, 64)]


def _bag_inputs(b, f, mh, v, d, dtype, device, *, wild=False):
    rng = np.random.default_rng(b * 131 + f * 17 + mh * 5 + v + d)
    tables = torch.from_numpy(rng.standard_normal((f, v, d)).astype(np.float32)).to(dtype)
    lo, hi = (-v - 3, v + 3) if wild else (0, v)
    idx = torch.from_numpy(rng.integers(lo, hi, (b, f, mh)).astype(np.int32))
    return tables.to(device), idx.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("b,f,mh,v,d", B4_CASES)
def test_embedding_bag_matches_plain_version_bitwise(cuda, b, f, mh, v, d, wild, dtype):
    """Wrapped negatives, out-of-range → NaN, MH = 0, B = 0, odd D (scalar
    loads), D past one pass of the group, both table types."""
    tables, idx = _bag_inputs(b, f, mh, v, d, dtype, cuda, wild=wild)
    eb_ops.reset_launches()
    got = eb_ops.embedding_bag_fields(tables, idx)
    assert eb_ops.launches[eb_ops.EMBEDDING_BAG] == (1 if got.numel() else 0)
    assert chip_smoke.same_bits(got, eb_ref.embedding_bag_ref(tables, idx))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_embedding_bag_on_card_equals_the_cpu_plain_version(cuda):
    tables, idx = _bag_inputs(64, 26, 3, 2000, 64, torch.float32, "cpu", wild=True)
    want = eb_ref.embedding_bag_ref(tables, idx)
    got = eb_ops.embedding_bag_fields(tables.to(cuda), idx.to(cuda))
    assert chip_smoke.same_bits(got.cpu(), want)


@pytest.mark.cuda
def test_embedding_bag_unaligned_rows_take_scalar_loads(cuda):
    """A table view that starts 4 bytes into its storage is not 16-byte
    aligned: the kernel must fall back to scalar loads and stay exact."""
    tables, idx = _bag_inputs(40, 3, 2, 100, 64, torch.float32, cuda)
    shifted = torch.empty(tables.numel() + 1, device=cuda)[1:].view(tables.shape)
    shifted.copy_(tables)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert chip_smoke.same_bits(eb_ops.embedding_bag_fields(shifted, idx),
                      eb_ref.embedding_bag_ref(tables, idx))


@pytest.mark.cuda
def test_embedding_bag_raises_on_the_card_instead_of_falling_back(cuda):
    tables, idx = _bag_inputs(4, 2, 1, 10, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        eb_ops.embedding_bag_fields(tables.half(), idx)
    with pytest.raises(TypeError):
        eb_ops.embedding_bag_fields(tables, idx.long())
    with pytest.raises(ValueError, match="devices"):
        eb_ops.embedding_bag_fields(tables, idx.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        eb_ops.embedding_bag_fields(tables.transpose(1, 2), idx)


@pytest.mark.cuda
def test_retrieval_scores_on_card_order_ties_by_index(cuda):
    """300 all-zero candidates tie everywhere: the top 10 are ids 0..9, as
    ``lax.top_k`` orders ties, on the card as on the CPU."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.models import dlrm

    cfg = dlrm_rm2.smoke_config()
    params = dlrm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    dense = torch.from_numpy(rng.standard_normal((1, cfg.n_dense)).astype(np.float32))
    sparse = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, cfg.n_sparse, 1)).astype(np.int32))
    on_card = chip_smoke.moved(params, cuda)
    cands = torch.zeros((300, cfg.embed_dim))
    vals, ids = dlrm.retrieval_scores(on_card, dense.to(cuda), sparse.to(cuda), cands.to(cuda),
                                      cfg, top_k=10)
    assert ids.cpu().tolist() == list(range(10)) and not vals.any()


@pytest.mark.cuda
@pytest.mark.parametrize("mh", [1, 3])
def test_dlrm_forward_on_card_matches_cpu(cuda, mh):
    """RM2's widths with small tables: B4 once per forward on the card,
    logits within 1e-4 of the port on the CPU (cuBLAS and CPU matmuls
    round differently; TF32 off)."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import dlrm_batch
    from repro_torch.models import dlrm

    cfg = dataclasses.replace(dlrm_rm2.full_config(), vocab_size=5000, multi_hot=mh)
    params = dlrm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = dlrm_batch(0, batch=512, vocab=cfg.vocab_size, multi_hot=mh, device="cpu")
    want = dlrm.forward(params, b["dense"], b["sparse"], cfg)
    on_card = {"tables": params["tables"].to(cuda),
               **{k: [{n: t.to(cuda) for n, t in lp.items()} for lp in params[k]]
                  for k in ("bot", "top")}}
    eb_ops.reset_launches()
    got = dlrm.forward(on_card, b["dense"].to(cuda), b["sparse"].to(cuda), cfg)
    assert eb_ops.launches[eb_ops.EMBEDDING_BAG] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_gcn_default_config_runs_b5_on_card(cuda):
    """``GCNConfig()`` (``spmm_impl='segment'``) on CUDA tensors: both
    layers run B5, and ``spmm_di`` routes either impl to it."""
    from repro_torch.data import synthetic_graph_batch
    from repro_torch.graph.segment_ops import spmm_di
    from repro_torch.models import gcn

    cfg = gcn.GCNConfig()
    assert cfg.spmm_impl == "segment"
    b = synthetic_graph_batch(n_nodes=500, n_edges=3000, d_feat=cfg.d_in, device="cpu")
    params = gcn.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = gcn.forward(params, b, cfg)
    sm_ops.reset_launches()
    got = gcn.forward({"layers": [{k: v.to(cuda) for k, v in lp.items()}
                                  for lp in params["layers"]]}, b.to(cuda), cfg)
    assert sm_ops.launches[sm_ops.SEG_MM] == 2
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    x, src, dst, w = _seg_mm_inputs(8, 50, 100, cuda)
    for impl in ("segment", "kernel"):
        sm_ops.reset_launches()
        spmm_di(x, src, dst, 50, edge_weight=w, impl=impl)
        assert sm_ops.launches[sm_ops.SEG_MM] == 1
    with pytest.raises(ValueError, match="impl"):
        spmm_di(x, src, dst, 50, impl="dense")


# (b, sq, skv, hq, hkv, d, kwargs)
B6_CASES = [
    (2, 128, 128, 4, 2, 32, dict(causal=True)),
    (1, 256, 256, 8, 8, 64, dict(causal=True, window=64)),
    (1, 128, 128, 4, 1, 32, dict(causal=False, cap=50.0)),
    (2, 128, 128, 8, 4, 64, dict(causal=True, window=32, cap=30.0)),
    (1, 77, 131, 4, 2, 16, dict(causal=True)),
    (2, 65, 300, 18, 2, 128, dict(causal=True, window=40, cap=50.0, q_offset=200)),
    (1, 200, 200, 4, 2, 256, dict(causal=True, window=33, cap=50.0)),
    (1, 300, 300, 16, 8, 256, dict(causal=True, cap=50.0)),
    (1, 33, 70, 2, 2, 40, dict(causal=False, window=20)),
    (1, 1, 517, 4, 2, 128, dict(causal=True, q_offset=516)),  # one decode-like row
    (3, 9, 5, 3, 1, 20, dict(causal=True, window=3, q_offset=2)),  # D % 8 != 0: scalar loads
    (1, 64, 64, 4, 2, 256, dict(causal=True, window=4, q_offset=100)),  # no valid key anywhere
    (1, 100, 64, 2, 1, 16, dict(causal=True, window=8, q_offset=30)),  # some rows without one
]


def _attn_inputs(b, sq, skv, hq, hkv, d, dtype, device, scale=0.3):
    """q and k entries of std ``scale`` (scores of std ``scale``²), V of std 1."""
    rng = np.random.default_rng(b * 31 + sq * 7 + skv + d)
    q = torch.from_numpy((rng.standard_normal((b, sq, hq, d)) * scale).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((b, skv, hkv, d)) * scale).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, skv, hkv, d)).astype(np.float32))
    return tuple(t.to(dtype).to(device) for t in (q, k, v))


B6_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kw", B6_CASES)
def test_flash_attention_matches_plain_version(cuda, b, sq, skv, hq, hkv, d, kw, dtype):
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, d, dtype, cuda)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == 1
    assert got.shape == q.shape and got.dtype == dtype
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **B6_TOL[dtype])
    torch.cuda.synchronize()


# (b, sq, skv, hq, hkv, d, kwargs) with a softcap, at q and k scales whose scores
# (of std scale²) reach it; f32 is held to the plain version in float64 there
# (chip_smoke.QK_SCALE)
B6_CAP_CASES = [
    (1, 256, 256, 16, 8, 256, dict(causal=True, window=64, cap=30.0)),
    (2, 300, 300, 8, 4, 128, dict(causal=True, window=100, cap=50.0)),
    (1, 128, 128, 4, 1, 32, dict(causal=False, cap=50.0)),
]
B6_CAP_SCALES = [(torch.float32, 3.0), (torch.bfloat16, 3.0), (torch.bfloat16, 5.0)]


# (b, sq, skv, hq, hkv, d, kwargs) for the wgmma/TMA kernel: interior and edge
# tiles, window and none, causal off, G = 1, 2, 4 and odd, D = 8..256, Sq and Skv
# not multiples of 64, q_offset, rows without a valid key
B6_SM90_CASES = [
    (1, 8192, 8192, 16, 8, 256, dict(causal=True, window=4096, cap=50.0)),
    (1, 1000, 1000, 16, 8, 256, dict(causal=True, cap=50.0)),
    (1, 300, 300, 4, 4, 256, dict(causal=True, window=100)),
    (2, 200, 333, 8, 2, 128, dict(causal=False, cap=30.0)),
    (1, 130, 250, 6, 3, 64, dict(causal=True, window=70, q_offset=120)),
    (2, 65, 300, 18, 2, 128, dict(causal=True, window=40, q_offset=200)),
    (1, 100, 130, 4, 4, 8, dict(causal=True)),
    (1, 200, 200, 4, 2, 192, dict(causal=True, window=100)),
    (3, 77, 91, 6, 3, 40, dict(causal=True, q_offset=-20)),
    (1, 128, 256, 16, 8, 256, dict(causal=True, window=64, q_offset=400)),  # no valid key
    (1, 100, 64, 2, 1, 16, dict(causal=True, window=8, q_offset=30)),  # some rows without
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kw", B6_SM90_CASES)
def test_flash_attention_sm90_kernel_matches_plain_version(cuda, b, sq, skv, hq, hkv, d, kw):
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, d, torch.bfloat16, cuda,
                           3.0 if kw.get("cap") else 0.3)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches[fa_ops.COUNTERS["sm90"]] == fa_ops.launches[fa_ops.FLASH_ATTENTION] == 1
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **B6_TOL[torch.bfloat16])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_attention_kernels_by_input(cuda):
    """Strided views TMA takes run the sm90 kernel; a misaligned H stride
    the mma.sync kernel; f32 the SIMT kernel; each counted under its name."""
    packed, _, _ = _attn_inputs(1, 300, 300, 8, 8, 128, torch.bfloat16, cuda)
    odd = torch.zeros((1, 300, 4, 132), dtype=torch.bfloat16, device=cuda)[..., :128]
    odd.copy_(packed[:, :, :4])
    kw = dict(causal=True, window=100, cap=50.0)
    fa_ops.reset_launches()
    for (q, k, v), name in [((packed[:, :, :4], packed[:, :, 4:6], packed[:, :, 6:]), "sm90"),
                            ((odd, packed[:, :, 4:6], packed[:, :, 6:]), "mma"),
                            ((packed[:, :, :4].float(), packed[:, :, 4:6].float(),
                              packed[:, :, 6:].float()), "simt")]:
        before = fa_ops.launches[fa_ops.COUNTERS[name]]
        got = fa_ops.flash_attention(q, k, v, **kw)
        assert fa_ops.launches[fa_ops.COUNTERS[name]] == before + 1
        want = fa_ref.flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        torch.testing.assert_close(got.float(), want.float(), **B6_TOL[q.dtype])
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scale", B6_CAP_SCALES)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,kw", B6_CAP_CASES)
def test_flash_attention_softcap_at_its_scale(cuda, b, sq, skv, hq, hkv, d, kw, dtype, scale):
    """Scores at the cap's scale: the kernel matches the capped plain
    version, and the kernel without the cap fails the same tolerance, so
    the check tells the softcap from none."""
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, d, dtype, cuda, scale)
    wide = (t.double() if dtype == torch.float32 else t for t in (q, k, v))
    want = fa_ref.flash_attention_ref(*wide, **kw).double()
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got.double(), want, **B6_TOL[dtype])
    uncapped = fa_ops.flash_attention(q, k, v, **{**kw, "cap": None})
    assert not torch.allclose(uncapped.double(), want, **B6_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_no_valid_key_is_the_mean_of_v(cuda, dtype):
    q, k, v = _attn_inputs(1, 70, 64, 4, 2, 128, dtype, cuda)
    got = fa_ops.flash_attention(q, k, v, causal=True, window=4, q_offset=100)
    mean = v.float().mean(dim=1, keepdim=True).repeat_interleave(2, dim=2)
    torch.testing.assert_close(got.float(), mean.expand_as(got), **B6_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_reads_strided_inputs(cuda):
    """q, k and v as views of one packed (B, S, Hq + 2·Hkv, D) projection:
    the kernel reads their strides, nothing is copied."""
    for dtype in (torch.float32, torch.bfloat16):
        qkv, _, _ = _attn_inputs(2, 96, 96, 8, 8, 64, dtype, cuda)
        q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:8]
        assert not q.is_contiguous()
        got = fa_ops.flash_attention(q, k, v, causal=True, window=30, cap=50.0)
        want = fa_ref.flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                                          causal=True, window=30, cap=50.0)
        torch.testing.assert_close(got.float(), want.float(), **B6_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_raises_on_the_card_instead_of_falling_back(cuda):
    q, k, v = _attn_inputs(1, 16, 16, 4, 2, 8, torch.bfloat16, cuda)
    fa_ops.reset_launches()
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="devices"):
        fa_ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="D <= 256"):
        big = torch.zeros((1, 4, 2, 264), dtype=torch.bfloat16, device=cuda)
        fa_ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((1, 4, 2, 16), dtype=torch.bfloat16, device=cuda)[..., ::2]
        fa_ops.flash_attention(wide, wide, wide)
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == 0
    empty = fa_ops.flash_attention(q, k[:, :0], v[:, :0])
    assert empty.shape == q.shape and not empty.any()


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "direct", "chunked", "flash"])
def test_attention_on_card_runs_b6_for_every_impl(cuda, impl):
    from repro_torch.nn.attention import attention

    q, k, v = _attn_inputs(2, 64, 64, 4, 2, 16, torch.float32, "cpu")
    kw = dict(causal=True, window=16, cap=50.0)
    want = attention(q, k, v, impl=impl, **kw)
    fa_ops.reset_launches()
    got = attention(q.to(cuda), k.to(cuda), v.to(cuda), impl=impl, **kw)
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    # kv_len: the plain paths on either device, no launch
    got = attention(q.to(cuda), k.to(cuda), v.to(cuda), impl=impl, kv_len=40, **kw)
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == 1
    torch.testing.assert_close(got.cpu(), attention(q, k, v, impl=impl, kv_len=40, **kw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2_9b", "starcoder2_7b", "qwen2_72b"])
def test_transformer_on_card_matches_cpu(cuda, arch):
    """A smoke config's forward, prefill and decode loop on the card (B6
    once per layer of a forward) against the port on the CPU at 1e-4
    (cuBLAS and CPU matmuls round differently; TF32 off)."""
    import importlib

    from repro_torch.models import transformer as T

    cfg = importlib.import_module(f"repro_torch.configs.{arch}").smoke_config()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    on_card = chip_smoke.moved(params, cuda)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    fa_ops.reset_launches()
    got = T.prefill(on_card, toks.to(cuda), cfg)
    assert fa_ops.launches[fa_ops.FLASH_ATTENTION] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), T.prefill(params, toks, cfg), rtol=1e-4, atol=1e-4)
    caches = [T.init_cache(cfg, 2, 24, device=d) for d in ("cpu", cuda)]
    for t in range(20):
        lg_cpu, caches[0] = T.decode_step(params, caches[0], toks[:, t:t + 1], cfg)
        lg_card, caches[1] = T.decode_step(on_card, caches[1], toks[:, t:t + 1].to(cuda), cfg)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
