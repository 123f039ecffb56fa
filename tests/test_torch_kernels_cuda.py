"""The hand-written CUDA bitmap_query kernels against their plain PyTorch
versions on the card, bitwise, with their launch counts.  Needs an NVIDIA
card (marker ``cuda``; skips without one).  Imports neither JAX nor the
reference package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitplane
from repro_torch.kernels.bitmap_query import ops, ref

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
