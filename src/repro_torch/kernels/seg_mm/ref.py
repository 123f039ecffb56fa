"""Plain version of the seg_mm kernel (B5): gather, weight, ``index_add_``.

The CPU path of ``ops.py`` runs it, the tests hold the port to the
reference through it, and ``chip_smoke.py`` holds the kernel to it on the
card.  It repeats the kernel's arithmetic and is no measure of speed.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["seg_mm_ref", "gather_ids", "gather_rows", "in_range"]


def gather_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 row ids that read what the reference's gathers read from n
    rows: an id in [-n, -1] wraps, an id >= n reads row n - 1 and an id
    below -n reads row 0."""
    idx = ids.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp_(0, max(n - 1, 0))


def in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Which ids the reference's gathers pass a gradient back to: those in
    [-n, n).  Its forward reads a row for every id (``gather_ids``), but the
    transpose of its gather drops the ids outside that range."""
    idx = ids.to(torch.int64)
    return (idx >= -n) & (idx < n)


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[gather_ids(ids, len(x))]`` with the reference's gradient: rows
    read for ids in [-n, n) pass their gradient back (those in [-n, -1] to
    the row they wrap to), rows read for any other id pass none.  The
    forward is the plain gather, bit for bit."""
    n = x.shape[0]
    rows = x[gather_ids(ids, n)]
    if not (torch.is_grad_enabled() and x.requires_grad):
        return rows
    ok = in_range(ids, n).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(ok, rows, rows.detach())


def seg_mm_ref(x: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor, n_nodes: int,
               *, edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[v] = Σ_{e: dst_e = v} w_e · x[src_e]; (n_nodes, D), empty rows 0.
    Edges whose dst lies outside [0, n_nodes) are dropped, as the
    reference's ``segment_sum`` drops them: they land in a spare last row.
    ``src`` ids outside [0, N_src) read the rows ``gather_ids`` names, and
    pass a gradient back only from [-N_src, N_src) (``gather_rows``)."""
    n = int(n_nodes)
    msgs = gather_rows(x, src_idx)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    dst = dst_idx.to(torch.int64)
    dst = torch.where((dst >= 0) & (dst < n), dst, n)
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=msgs.dtype, device=x.device)
    return out.index_add_(0, dst, msgs)[:n]
