"""Synthetic LM data pipeline — deterministic, step-addressed token batches.

The batch for step k is a pure function of (seed, k), so a job restored at
step k sees the data it would have seen.  The reference draws with JAX's
threefry keys; the port draws with a ``torch.Generator`` seeded from
(seed, step) (``data/recsys.py``'s ``batch_seed``), so the same (seed,
step, device) gives the same batch and steps differ, but the tokens are
not the reference's.  Tests that compare the two packages build tokens
with numpy and hand them to both.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.recsys import batch_seed

__all__ = ["lm_batch"]


def lm_batch(step: int, *, batch: int, seq: int, vocab: int, seed: int = 0,
             device=None) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int32 uniform in [0, vocab), the
    labels shifted one token ahead, drawn on ``device`` (None: the CUDA
    card)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(batch_seed(seed, step))
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=gen, device=device,
                         dtype=torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
