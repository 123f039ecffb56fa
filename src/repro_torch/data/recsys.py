"""Synthetic recsys pipeline — step-addressed DLRM batches (Criteo-like).

The reference draws with JAX's threefry keys; the port draws with a
``torch.Generator`` seeded from (seed, step), so the same (seed, step,
device) gives the same batch and steps differ, but the bits are not the
reference's.  Tests that compare the two packages build the batch with
numpy and hand it to both.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = ["dlrm_batch", "batch_seed"]


def batch_seed(seed: int, step: int) -> int:
    """The generator seed of batch ``step`` in the stream ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0])


def dlrm_batch(step: int, *, batch: int, n_dense: int = 13, n_sparse: int = 26,
               vocab: int = 1_000_000, multi_hot: int = 1, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """{"dense": (batch, n_dense) f32 normal, "sparse": (batch, n_sparse,
    multi_hot) int32 uniform in [0, vocab), "labels": (batch,) int32
    Bernoulli(0.3)}, drawn on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(batch_seed(seed, step))
    return {
        "dense": torch.randn((batch, n_dense), generator=gen, device=device),
        "sparse": torch.randint(0, vocab, (batch, n_sparse, multi_hot), generator=gen,
                                device=device, dtype=torch.int32),
        "labels": (torch.rand((batch,), generator=gen, device=device) < 0.3).to(torch.int32),
    }
