"""Sparse embedding-table updates: rowwise AdaGrad on the touched rows only.

The port of ``src/repro/optim/sparse_tables.py``.  A dense optimizer step
on DLRM touches every row of every table (26 × 10⁶ × 64 parameters), but a
batch names at most batch × fields × multi-hot rows.  ``sparse_table_update``
takes the batch's indices and the gradient of the gathered rows
(``pulled_grad``), sums each row's duplicates first (``index_add_`` per
field, over the batch's own distinct rows, never a V-row buffer) and moves
only the touched rows: ``row -= lr · g / sqrt(acc + mean(g²))`` with one f32
accumulator a row (rowwise AdaGrad, the DLRM/FBGEMM standard).  Ids outside
[0, V) are dropped, as the reference's ``segment_sum`` drops them.
``dense_rowwise_update`` is the dense form the sparse one is held to.  Both
are functional: they return new tables and accumulators.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["init_rowwise_state", "sparse_table_update", "dense_rowwise_update"]


def init_rowwise_state(tables: torch.Tensor) -> torch.Tensor:
    """(F, V) f32 accumulator, one scalar a row."""
    return torch.zeros(tables.shape[:-1], dtype=torch.float32, device=tables.device)


def _scale(lr: float, acc: torch.Tensor, eps: float) -> torch.Tensor:
    # a tensor numerator: ``lr / t`` would multiply by t's reciprocal
    return torch.full((), lr, dtype=torch.float32, device=acc.device) / torch.sqrt(acc + eps)


def sparse_table_update(tables: torch.Tensor, acc: torch.Tensor, idx: torch.Tensor,
                        pulled_grad: torch.Tensor, *, lr: float = 0.01,
                        eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rowwise AdaGrad on only the rows ``idx`` (B, F, MH) names; tables
    (F, V, D), acc (F, V), pulled_grad (B, F, MH, D).  Returns (new tables,
    new acc); untouched rows keep their bits."""
    with torch.no_grad():
        b, f, mh, d = pulled_grad.shape
        v = tables.shape[1]
        new_t, new_acc = tables.clone(), acc.clone()
        for j in range(f):
            ids = idx[:, j].reshape(-1).to(torch.int64)
            g = pulled_grad[:, j].reshape(-1, d)
            ok = (ids >= 0) & (ids < v)
            rows, inv = torch.unique(ids[ok], return_inverse=True)
            g_rows = torch.zeros((rows.shape[0], d), dtype=g.dtype,
                                 device=g.device).index_add_(0, inv, g[ok])
            a = acc[j, rows] + torch.mean(g_rows * g_rows, dim=-1)
            upd = g_rows * _scale(lr, a, eps)[:, None]
            new_t[j, rows] = tables[j, rows] - upd.to(tables.dtype)
            new_acc[j, rows] = a
        return new_t, new_acc


def dense_rowwise_update(tables: torch.Tensor, acc: torch.Tensor, dense_grad: torch.Tensor, *,
                         lr: float = 0.01, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense form: rowwise AdaGrad on every row with a nonzero gradient."""
    with torch.no_grad():
        g2 = torch.mean(dense_grad * dense_grad, dim=-1)
        touched = torch.any(dense_grad != 0, dim=-1)
        acc_new = acc + torch.where(touched, g2, 0.0)
        upd = dense_grad * _scale(lr, acc_new, eps)[..., None]
        return tables - torch.where(touched[..., None], upd, 0.0).to(tables.dtype), acc_new
