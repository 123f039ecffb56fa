"""Public wrapper for the embedding_bag kernel (B4): DLRM's pooled lookup.

``embedding_bag_fields(tables, idx)`` computes the (B, F, D) mean bags of
(B, F, MH) indices into (F, V, D) tables.  It checks its inputs, sends CPU
tensors to the plain version (``ref.embedding_bag_ref``) and launches the
CUDA kernel (``kernel.py``) on CUDA tensors — there is no fallback from the
card to the plain version.  ``launches`` counts kernel launches (never
plain-version calls); ``reset_launches()`` zeroes it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.embedding_bag import kernel, ref

__all__ = ["embedding_bag_fields", "launches", "reset_launches"]

EMBEDDING_BAG = "embedding_bag"  # B4
launches: Dict[str, int] = {EMBEDDING_BAG: 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(tables: torch.Tensor, idx: torch.Tensor) -> None:
    name = EMBEDDING_BAG
    if tables.dtype not in kernel.DTYPES:
        raise TypeError(f"{name}: tables must be float32 or bfloat16, got {tables.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if tables.dim() != 3 or idx.dim() != 3 or idx.shape[1] != tables.shape[0]:
        raise ValueError(f"{name}: want tables (F, V, D) and idx (B, F, MH); got "
                         f"{tuple(tables.shape)}, {tuple(idx.shape)}")
    if tables.device != idx.device:
        raise ValueError(f"{name}: inputs on several devices {[tables.device, idx.device]}")
    if tables.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tables.device}")
    if not (tables.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if tables.shape[1] >= 2**31 or idx.shape[0] * idx.shape[1] >= 2**31:
        raise ValueError(f"{name}: V and B * F must lie below 2**31")


def embedding_bag_fields(tables: torch.Tensor, idx: torch.Tensor, *, bt: int = 256) -> torch.Tensor:
    """(F, V, D) tables × (B, F, MH) int32 multi-hot indices → (B, F, D)
    mean bags in ``tables.dtype`` (f32 sums).  Indices in [-V, -1] wrap;
    others outside [0, V) give NaN bags, as the reference does.  ``bt`` (the
    reference's batch tile) is accepted and ignored: the card has no tile
    rule."""
    del bt
    _check(tables, idx)
    if tables.device.type == "cpu":
        return ref.embedding_bag_ref(tables, idx)
    out = torch.empty((idx.shape[0], idx.shape[1], tables.shape[2]), dtype=tables.dtype,
                      device=tables.device)
    if out.numel():
        kernel.launch_embedding_bag(tables, idx, out)
        launches[EMBEDDING_BAG] += 1
    return out
