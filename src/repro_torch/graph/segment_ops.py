"""Message-passing primitives over DI edge arrays.

Message passing is a scatter from the edge index onto the nodes:
``index_add_`` for sums, ``scatter_reduce`` (``include_self=False``) for
maxima and minima, and ``bincount`` for counts (degrees).  Edges whose segment id lies outside
[0, num_segments) are dropped, as the reference's ``segment_*`` drop them.
An empty segment's maximum is -inf and its minimum +inf (the integer
extremes for integer data); ``gather_scatter(agg="max")`` and
``segment_softmax`` then map non-finite values to 0, as the reference does.
Gathers by id (``x[src]``, a degree or a segment's maximum read back per
edge) read what the reference's read: ids in [-n, -1] wrap, ids >= n read
row n - 1 and ids below -n row 0 (``kernels/seg_mm/ref.gather_ids``),
and pass a gradient back only from ids in [-n, n), as the transpose of
the reference's gather does (``ref.gather_rows``).

``gather_scatter`` is the generic MPNN primitive; ``spmm_di`` the GCN-style
Ã·X product, which runs the CUDA kernel B5 (``kernels/seg_mm``) on CUDA
tensors whatever ``impl`` says; on CPU tensors ``impl='segment'`` is the
plain scatter and ``impl='kernel'`` B5's plain version.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.seg_mm.ref import gather_rows

__all__ = [
    "segment_sum_sorted",
    "segment_sum",
    "segment_count",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "gather_scatter",
    "spmm_di",
    "degree_norm",
]


def _ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with every out-of-range id sent to the spare row
    ``num_segments`` (sliced off by the callers)."""
    ids = segment_ids.to(torch.int64)
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(E, ...) data summed per segment → (num_segments, ...); empty → 0."""
    n = int(num_segments)
    out = torch.zeros((n + 1,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, _ids(segment_ids, n), data)[:n]


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Edges per segment, as ``segment_sum`` of ones gives it (exact below
    2**24 in float32), counted by ``bincount``: no ``index_add_``."""
    n = int(num_segments)
    return torch.bincount(_ids(segment_ids, n), minlength=n + 1)[:n].to(dtype)


def segment_sum_sorted(data, segment_ids, num_segments: int):
    """segment_sum with the DI sortedness promise (the sum does not use it)."""
    return segment_sum(data, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments: int, *, sorted_ids: bool = False):
    del sorted_ids
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_count(segment_ids, num_segments, data.dtype)
    return s / torch.clamp(cnt, min=1)[(...,) + (None,) * (data.dim() - 1)]


def _extreme(data: torch.Tensor, segment_ids, num_segments: int, reduce: str) -> torch.Tensor:
    n = int(num_segments)
    if data.dtype.is_floating_point:
        fill = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        fill = info.min if reduce == "amax" else info.max
    out = torch.full((n + 1,) + tuple(data.shape[1:]), fill, dtype=data.dtype,
                     device=data.device)
    idx = _ids(segment_ids, n).reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce=reduce, include_self=False)[:n]


def segment_max(data, segment_ids, num_segments: int, *, sorted_ids: bool = False):
    """Per-segment maximum; an empty segment gives -inf (integer minimum)."""
    del sorted_ids
    return _extreme(data, segment_ids, num_segments, "amax")


def segment_min(data, segment_ids, num_segments: int, *, sorted_ids: bool = False):
    """Per-segment minimum; an empty segment gives +inf (integer maximum)."""
    del sorted_ids
    return _extreme(data, segment_ids, num_segments, "amin")


def segment_softmax(scores, segment_ids, num_segments: int):
    """Numerically-stable per-segment softmax (GAT edge softmax); ``scores``
    (E,) or (E, H), one softmax per trailing index."""
    seg_max = segment_max(scores, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(scores - gather_rows(seg_max, segment_ids))
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(gather_rows(denom, segment_ids), min=1e-30)


def gather_scatter(
    x: torch.Tensor,
    src_idx: torch.Tensor,
    dst_idx: torch.Tensor,
    num_nodes: int,
    *,
    msg_fn: Optional[Callable] = None,
    edge_weight: Optional[torch.Tensor] = None,
    agg: str = "sum",
) -> torch.Tensor:
    """The MPNN primitive: m_e = msg(x[src_e]); h_v = ⨁_{e: dst_e=v} m_e.

    x: (n, d) node features; src_idx/dst_idx: (m,) DI edge arrays.
    """
    msgs = gather_rows(x, src_idx)
    if msg_fn is not None:
        msgs = msg_fn(msgs)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    if agg == "sum":
        return segment_sum(msgs, dst_idx, num_nodes)
    if agg == "mean":
        return segment_mean(msgs, dst_idx, num_nodes)
    if agg == "max":
        out = segment_max(msgs, dst_idx, num_nodes)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(f"unknown agg {agg!r}")


def degree_norm(src_idx, dst_idx, num_nodes: int, *, mode: str = "sym") -> torch.Tensor:
    """GCN normalization coefficients per edge.

    sym:  1/sqrt((1+deg_out(u))·(1+deg_in(v)))  (self-loop-adjusted, Kipf §2)
    rw:   1/(1+deg_in(v))
    """
    d_out = segment_count(src_idx, num_nodes) + 1.0
    d_in = segment_count(dst_idx, num_nodes) + 1.0
    if mode == "sym":
        return torch.rsqrt(gather_rows(d_out, src_idx) * gather_rows(d_in, dst_idx))
    if mode == "rw":
        return 1.0 / gather_rows(d_in, dst_idx)
    raise ValueError(f"unknown mode {mode!r}")


def spmm_di(
    x: torch.Tensor,
    src_idx: torch.Tensor,
    dst_idx: torch.Tensor,
    num_nodes: int,
    *,
    edge_weight: Optional[torch.Tensor] = None,
    impl: str = "segment",
) -> torch.Tensor:
    """Ã @ X over DI edges.  On CUDA tensors both ``impl`` values run B5
    (``kernels/seg_mm``); on CPU tensors ``'segment'`` is the plain scatter
    (``gather_scatter``) and ``'kernel'`` B5's plain version.  ``impl`` is
    kept, and checked, for parity with the reference's config."""
    if impl not in ("segment", "kernel"):
        raise ValueError(f"impl must be 'segment' or 'kernel', got {impl!r}")
    if impl == "kernel" or x.device.type == "cuda":
        from repro_torch.kernels.seg_mm import ops as _ops

        return _ops.seg_mm(x, src_idx, dst_idx, num_nodes, edge_weight=edge_weight)
    return gather_scatter(x, src_idx, dst_idx, num_nodes, edge_weight=edge_weight, agg="sum")
