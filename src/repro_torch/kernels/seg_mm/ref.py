"""Plain version of the seg_mm kernel (B5): gather, weight, ``index_add_``.

The CPU path of ``ops.py`` runs it, the tests hold the port to the
reference through it, and ``chip_smoke.py`` holds the kernel to it on the
card.  It repeats the kernel's arithmetic and is no measure of speed.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["seg_mm_ref"]


def seg_mm_ref(x: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor, n_nodes: int,
               *, edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[v] = Σ_{e: dst_e = v} w_e · x[src_e]; (n_nodes, D), empty rows 0.
    Edges whose dst lies outside [0, n_nodes) are dropped, as the
    reference's ``segment_sum`` drops them: they land in a spare last row."""
    n = int(n_nodes)
    msgs = x[src_idx.to(torch.int64)]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    dst = dst_idx.to(torch.int64)
    dst = torch.where((dst >= 0) & (dst < n), dst, n)
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=msgs.dtype, device=x.device)
    return out.index_add_(0, dst, msgs)[:n]
