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

Over DTensors (one rank's program on a device mesh, ``launch/dryrun.py``)
``gather_rows``, ``segment_sum``, ``segment_count`` and ``spmm_di`` (so
``degree_norm``, ``segment_mean`` and ``gather_scatter`` too) run as
``nn/partition.local_call``s placed by ``partition.gather_plan`` and
``scatter_plan``: each rank gathers from the node table made whole along
its rows, scatters its own edges into a ``Partial`` (n, ...) table, and
that table is reduced to ``partition.node_placements``' rule.  No index
crosses a collective: the ids keep their split, or take a local chunk of
it.  ``spmm_di`` hands B5 the edges' local tensors themselves
(``DTensor._local_tensor``), the same objects on every call, so both GCN
layers and the backward find B5's layouts in its cache as on one device.
A plain tensor takes none of these paths.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.core.device import holds_data
from repro_torch.kernels import _cost
from repro_torch.kernels.seg_mm import ref
from repro_torch.nn.partition import (as_dtensor, contiguous_stride, gather_plan, local_call,
                                      mesh_of, node_placements, scatter_plan)

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
    "gather_rows",
]


def _summed(local_fn, args, in_placements, in_grad_placements, out, shape, mesh):
    """``local_fn`` on the local shards (``local_call``), its ``Partial``
    (n, ...) table reduced to ``node_placements``' rule."""
    table = local_call(local_fn, args, in_placements, in_grad_placements, out, shape)
    return table.redistribute(mesh, node_placements(mesh, shape[0], out))


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``kernels/seg_mm/ref.gather_rows`` (the reference's ids and
    gradient); over DTensors a ``local_call`` placed by ``gather_plan``."""
    mesh = mesh_of(x, ids)
    if mesh is None:
        return ref.gather_rows(x, ids)
    x, ids = as_dtensor(x, mesh), as_dtensor(ids, mesh)
    x_in, grad, out = gather_plan(x, ids)
    return local_call(ref.gather_rows, (x, ids), (x_in, ids.placements), (grad, None), out,
                      tuple(ids.shape) + tuple(x.shape[1:]))


def _ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with every out-of-range id sent to the spare row
    ``num_segments`` (sliced off by the callers)."""
    ids = segment_ids.to(torch.int64)
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(E, ...) data summed per segment → (num_segments, ...); empty → 0."""
    n = int(num_segments)
    mesh = mesh_of(data, segment_ids)
    if mesh is not None:
        data, ids = as_dtensor(data, mesh), as_dtensor(segment_ids, mesh)
        data_in, ids_in, out = scatter_plan(data, ids)
        return _summed(lambda d, i: segment_sum(d, i, n), (data, ids), (data_in, ids_in),
                       (data_in, None), out, (n,) + tuple(data.shape[1:]), mesh)
    out = torch.zeros((n + 1,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, _ids(segment_ids, n), data)[:n]


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Edges per segment, as ``segment_sum`` of ones gives it (exact below
    2**24 in float32), counted by ``bincount``: no ``index_add_``.  Ids
    that hold no data (the dry run's fake tensors) have no values to bound
    ``bincount``'s length, so they are counted by an int64 ``index_add_``
    into the same n + 1 slots."""
    n = int(num_segments)
    mesh = mesh_of(segment_ids)
    if mesh is not None:
        _, ids_in, out = scatter_plan(segment_ids, segment_ids)
        return _summed(lambda i: segment_count(i, n, dtype), (segment_ids,), (ids_in,), (None,),
                       out, (n,), mesh)
    ids = _ids(segment_ids, n)
    if holds_data(ids):
        counts = torch.bincount(ids, minlength=n + 1)
    else:
        counts = torch.zeros(n + 1, dtype=torch.int64, device=ids.device).index_add_(
            0, ids, torch.ones_like(ids))
    return counts[:n].to(dtype)


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
    (``gather_scatter``) and ``'kernel'`` B5's plain version; under a cost
    counter every device takes B5's wrapper, which charges the kernel.
    ``impl`` is kept, and checked, for parity with the reference's config."""
    if impl not in ("segment", "kernel"):
        raise ValueError(f"impl must be 'segment' or 'kernel', got {impl!r}")
    mesh = mesh_of(x, src_idx, dst_idx, edge_weight)
    if mesh is not None:
        return _sharded_spmm(x, src_idx, dst_idx, int(num_nodes), edge_weight, impl, mesh)
    if impl == "kernel" or x.device.type == "cuda" or _cost.counter is not None:
        from repro_torch.kernels.seg_mm import ops as _ops

        return _ops.seg_mm(x, src_idx, dst_idx, num_nodes, edge_weight=edge_weight)
    return gather_scatter(x, src_idx, dst_idx, num_nodes, edge_weight=edge_weight, agg="sum")


def _sharded_spmm(x, src_idx, dst_idx, n: int, edge_weight, impl: str, mesh) -> DTensor:
    """``spmm_di`` over DTensors (module docstring): the table whole along
    its rows where the edges are split, B5 (or its plain version) on this
    rank's edges into a ``Partial`` (n, D) table, reduced as a segment sum's."""
    x, src, dst = (as_dtensor(t, mesh) for t in (x, src_idx, dst_idx))
    if src.placements != dst.placements:
        raise ValueError(f"spmm_di: src placed {src.placements}, dst {dst.placements}: the "
                         "edges are split alike")
    x_in, grad, rows = gather_plan(x, src)
    # a Partial sum where the edges are split, else the gathered rows' feature split
    out = tuple(Partial() if isinstance(e, Shard) else r for r, e in zip(rows, src.placements))
    x_local = x.redistribute(mesh, x_in).to_local(grad_placements=grad)
    w_local = None
    if edge_weight is not None:
        w_local = as_dtensor(edge_weight, mesh).redistribute(mesh, src.placements).to_local()
    local = spmm_di(x_local, src._local_tensor, dst._local_tensor, n, edge_weight=w_local,
                    impl=impl)
    shape = (n,) + tuple(x.shape[1:])
    table = DTensor.from_local(local, mesh, out, run_check=False, shape=torch.Size(shape),
                               stride=contiguous_stride(shape))
    return table.redistribute(mesh, node_placements(mesh, n, out))
