"""Plain version of the embedding_bag kernel (B4): gather, then a mean.

The CPU path of ``ops.py`` runs it, the tests hold the port to the
reference through it, and ``chip_smoke.py`` holds the kernel to it on the
card, bit for bit: the sum is a fold over the bag in index order, in f32,
then one IEEE division by MH, then a cast to the tables' type, as the
kernel computes it.  It repeats the kernel's arithmetic and is no measure
of speed.

Index semantics are the reference's (``jnp.take`` in its default fill
mode, then ``jnp.mean``): an index in [-V, -1] wraps to V + i, any other
index outside [0, V) makes its bag NaN, an empty bag (MH = 0) is 0/0 = NaN.

A row window ``(V, row_lo)``: the tables hold rows [row_lo, row_lo +
tables.shape[1]) of V-row tables (one device's slice of row-split
tables).  A valid index whose row lies outside the window adds 0; V, the
NaN rule and the divisor MH are the global ones, so the windows' bags over
a split of [0, V) sum to the whole lookup's.  No window (None) is the
whole table: the same bits as before windows existed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["embedding_bag_ref"]


def embedding_bag_ref(tables: torch.Tensor, idx: torch.Tensor,
                      window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """tables (F, R, D), idx (B, F, MH) integer → (B, F, D) mean bags in
    ``tables.dtype``; the tables are rows [row_lo, row_lo + R) of V-row
    tables for ``window`` = (V, row_lo), the whole tables (V = R) for None."""
    f, r, d = tables.shape
    v, lo = (r, 0) if window is None else (int(window[0]), int(window[1]))
    b, _, mh = idx.shape
    i = idx.to(torch.int64)
    valid = (i >= -v) & (i < v)
    i = torch.where(valid, torch.where(i < 0, i + v, i), 0) - lo
    inside = valid & (i >= 0) & (i < r)
    field = torch.arange(f, device=tables.device).view(1, f, 1)
    if r:
        rows = tables[field, torch.where(inside, i, 0)].to(torch.float32)  # (B, F, MH, D)
        if window is not None:
            rows = rows.masked_fill(~inside[..., None], 0.0)
    else:
        rows = torch.zeros((b, f, mh, d), dtype=torch.float32, device=tables.device)
    rows = rows.masked_fill(~valid[..., None], float("nan"))
    acc = torch.zeros((b, f, d), dtype=torch.float32, device=tables.device)
    for h in range(mh):
        acc = acc + rows[:, :, h]
    # a tensor divisor: a Python scalar would let CUDA multiply by 1/MH instead
    mean = acc / torch.tensor(float(mh), dtype=torch.float32, device=tables.device)
    return mean.to(tables.dtype)
