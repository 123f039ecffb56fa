"""The hand-written CUDA kernels (bitmap_query B1/B2, neighbor_sample B3)
against their plain PyTorch versions on the card, bitwise, with their
launch counts.  Needs an NVIDIA
card (marker ``cuda``; skips without one).  Imports neither JAX nor the
reference package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import random_csr
from repro_torch.core import bitplane
from repro_torch.kernels.bitmap_query import ops, ref
from repro_torch.kernels.neighbor_sample import ops as ns_ops
from repro_torch.kernels.neighbor_sample import ref as ns_ref

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
