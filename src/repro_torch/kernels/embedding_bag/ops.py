"""Public wrapper for the embedding_bag kernel (B4): DLRM's pooled lookup.

``embedding_bag_fields(tables, idx)`` computes the (B, F, D) mean bags of
(B, F, MH) indices into (F, V, D) tables.  With ``window=(V, row_lo)`` the
tables are rows [row_lo, row_lo + R) of V-row tables (one device's slice
of row-split tables, ``models/dlrm.py``'s partitioned lookup): a row
outside the window adds nothing, while V's NaN rule and the divisor MH stay
global, so the bags of the windows of a split of [0, V) sum to the whole
lookup's; the backward writes the window's R rows.  No window is the whole
table, as before windows existed.  It checks its inputs, sends CPU
tensors to the plain version (``ref.embedding_bag_ref``) and launches the
CUDA kernel (``kernel.py``) on CUDA tensors — there is no fallback from the
card to the plain version.  ``launches`` counts kernel launches (never
plain-version calls); ``reset_launches()`` zeroes it.

Gradients: on CUDA tables that need one, the lookup runs through
``_EmbeddingBag`` (a ``torch.autograd.Function``).  Its backward is
``grad_tables[f, r] = Σ_{(b, h): idx[b, f, h] wraps to r} grad_out[b, f] / MH``:
a segment sum of the (B·F, D) bag gradients into F·V rows, which it runs
on B5 (``kernels/seg_mm``) over a layout whose rows are the (field, row)
pairs and whose sources are the bags.  Ids outside [-V, V) get no
gradient, as the transpose of the reference's gather drops them; MH = 0
gives none.  The bag gradients are divided by MH first (an IEEE division,
as the plain version's backward divides), summed in f32 in ascending bag
order with no atomics, so the result is the same bits run to run, and
written in the tables' dtype.  Each backward adds one to
``launches[EMBEDDING_BAG_BACKWARD]`` and to B5's own count.

Cost: under a cost counter (``kernels/_cost.py``) each forward launch is
charged ``embedding_bag_cost`` and each backward ``embedding_bag_bwd_cost``,
phase 5's bounds of ``chip_smoke.py`` from shapes alone: the forward's
bound reads each distinct (field, row) pair once, which needs the data, so
every row gathered is charged (marked ``rows_from_shape``); the backward's
is exact.  Fake and meta inputs, and CPU inputs under a counter, take
``_cost.charged``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _cost
from repro_torch.kernels.embedding_bag import kernel, ref
from repro_torch.kernels.seg_mm import ops as seg_mm_ops

__all__ = ["embedding_bag_fields", "backward_layout", "bag_gradient", "launches",
           "reset_launches", "embedding_bag_cost", "embedding_bag_bwd_cost"]

EMBEDDING_BAG = "embedding_bag"  # B4
EMBEDDING_BAG_BACKWARD = "embedding_bag_backward"  # B4's backward, on B5
launches: Dict[str, int] = {EMBEDDING_BAG: 0, EMBEDDING_BAG_BACKWARD: 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def embedding_bag_cost(table_shape, idx_shape, esize: int) -> _cost.Charge:
    """One forward launch: every gathered row (B·F·MH of D elements of
    ``esize`` bytes), the indices and the (B, F, D) output; an add per
    gathered element."""
    _, _, d = table_shape
    b, f, mh = idx_shape
    return _cost.Charge(EMBEDDING_BAG, b * f * mh * d,
                        b * f * mh * d * esize + b * f * mh * 4 + b * f * d * esize,
                        rows_from_shape=True)


def embedding_bag_bwd_cost(table_shape, idx_shape, esize: int) -> _cost.Charge:
    """One backward launch: the (B, F, D) f32 bag gradients and the indices
    read once, the dense (F, V, D) gradient written once; an add per
    gathered element."""
    f, v, d = table_shape
    b, _, mh = idx_shape
    return _cost.Charge(EMBEDDING_BAG_BACKWARD, b * f * mh * d,
                        b * f * d * 4 + b * f * mh * 4 + f * v * d * esize)


def _charged(tables: torch.Tensor, idx: torch.Tensor, window) -> torch.Tensor:
    """B4 under a cost counter on inputs that launch no kernel (module
    docstring): what the card's call returns, its backward charged."""
    b, f, mh = idx.shape
    d = tables.shape[2]
    if b * f * d == 0:  # no launch on the card either
        return tables.new_zeros((b, f, d))
    es = tables.element_size()
    backward = (embedding_bag_bwd_cost(tables.shape, idx.shape, es)
                if mh and tables.numel() else None)
    return _cost.charged(lambda t, i: ref.embedding_bag_ref(t, i, window), (tables, idx),
                         empty=lambda t, i: t.new_empty((b, f, d)),
                         forward=embedding_bag_cost(tables.shape, idx.shape, es),
                         backward=backward, keep=lambda inputs, out: (inputs[1],))


def _check(tables: torch.Tensor, idx: torch.Tensor, window) -> None:
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
    if tables.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {tables.device}")
    if not (tables.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if tables.shape[1] >= 2**31 or idx.shape[0] * idx.shape[1] >= 2**31:
        raise ValueError(f"{name}: V and B * F must lie below 2**31")
    if window is not None:
        v, lo = window
        if not (0 <= lo and lo + tables.shape[1] <= v < 2**31):
            raise ValueError(f"{name}: rows [{lo}, {lo + tables.shape[1]}) are no window of "
                             f"{v}-row tables below 2**31")


def backward_layout(idx: torch.Tensor, v: int, window=None) -> seg_mm_ops.SegMMLayout:
    """B5's layout for the gradient of (F, v, D) tables read by ``idx``
    (B, F, MH): rows are the F·v (field, row) pairs, edge (b, f, h) in
    ascending order reads bag b·F + f, and ids outside [-V, V) fall outside
    every row, as do rows outside the ``window`` (V, row_lo) (None: V = v,
    row_lo = 0)."""
    b, f, mh = idx.shape
    big_v, lo = (v, 0) if window is None else window
    i64 = idx.to(torch.int64)
    field = torch.arange(f, dtype=torch.int64, device=idx.device).view(1, f, 1) * v
    r = torch.where((i64 >= -big_v) & (i64 < big_v), torch.where(i64 < 0, i64 + big_v, i64) - lo,
                    -1)
    rows = torch.where((r >= 0) & (r < v), r + field, -1)
    bags = torch.arange(b * f, dtype=torch.int32, device=idx.device).view(b, f, 1)
    return seg_mm_ops.build_layout(rows.reshape(-1).to(torch.int32), f * v,
                                   bags.expand(b, f, mh).reshape(-1))


class _EmbeddingBag(torch.autograd.Function):
    """B4 forward, its segment-sum backward on B5 (module docstring); CUDA
    tensors only."""

    @staticmethod
    def forward(ctx, tables, idx, *window):
        """``window``: nothing (the whole tables) or the one (V, row_lo)."""
        ctx.table_shape, ctx.table_dtype = tables.shape, tables.dtype
        ctx.window, ctx.n_window = (window[0] if window else None), len(window)
        ctx.save_for_backward(idx)
        return _launch(tables, idx, ctx.window)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return (bag_gradient(grad_out, idx, ctx.table_shape, ctx.table_dtype, ctx.window),
                None, *(None,) * ctx.n_window)


def bag_gradient(grad_out: torch.Tensor, idx: torch.Tensor, table_shape, dtype,
                 window=None) -> torch.Tensor:
    """The gradient of (F, V, D) tables of ``dtype`` read by ``idx`` (B, F,
    MH) under the bags' gradient ``grad_out`` (B, F, D), on B5 (module
    docstring); CUDA tensors.  With ``window`` the tables are its rows
    (``table_shape``'s V of them)."""
    f, v, d = table_shape
    b, _, mh = idx.shape
    if f * v >= 2**31 or b * f * mh >= 2**31:
        raise ValueError(f"{EMBEDDING_BAG}: the backward takes F * V and B * F * MH below 2**31")
    if not (mh and f * v * d):
        return torch.zeros((f, v, d), dtype=dtype, device=idx.device)
    # a tensor divisor: a Python scalar would let CUDA multiply by 1/MH instead
    bags = grad_out.to(torch.float32) / torch.full((), float(mh), device=idx.device)
    charge_as = (embedding_bag_bwd_cost(table_shape, idx.shape, dtype.itemsize)
                 if _cost.counter is not None else None)
    # every row written: empty rows as zeros
    grad = seg_mm_ops._launch(bags.reshape(b * f, d).contiguous(),
                              backward_layout(idx, v, window), None, f * v, charge_as=charge_as)
    launches[EMBEDDING_BAG_BACKWARD] += 1
    return grad.view(f, v, d).to(dtype)


def _launch(tables: torch.Tensor, idx: torch.Tensor, window) -> torch.Tensor:
    out = torch.empty((idx.shape[0], idx.shape[1], tables.shape[2]), dtype=tables.dtype,
                      device=tables.device)
    if out.numel():
        if window is None:
            kernel.launch_embedding_bag(tables, idx, out)
        else:
            kernel.launch_embedding_bag(tables, idx, out, window)
        launches[EMBEDDING_BAG] += 1
        if _cost.counter is not None:
            _cost.charge(embedding_bag_cost(tables.shape, idx.shape, tables.element_size()))
    return out


def embedding_bag_fields(tables: torch.Tensor, idx: torch.Tensor, *, bt: int = 256,
                         window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(F, V, D) tables × (B, F, MH) int32 multi-hot indices → (B, F, D)
    mean bags in ``tables.dtype`` (f32 sums).  Indices in [-V, -1] wrap;
    others outside [0, V) give NaN bags, as the reference does.  ``window``
    = (V, row_lo): the tables are rows [row_lo, row_lo + R) of V-row tables
    (module docstring).  ``bt`` (the reference's batch tile) is accepted
    and ignored: the card has no tile rule.  Differentiable in ``tables``
    (on the card through B5)."""
    del bt
    if window is not None:
        window = (int(window[0]), int(window[1]))
    _check(tables, idx, window)
    if _cost.counter is not None and not _cost.launches_kernel(tables):
        return _charged(tables, idx, window)
    if tables.device.type != "cuda":
        if tables.device.type == "meta":
            return _charged(tables, idx, window)
        return ref.embedding_bag_ref(tables, idx, window)
    if torch.is_grad_enabled() and tables.requires_grad:
        return _EmbeddingBag.apply(tables, idx, *(() if window is None else (window,)))
    return _launch(tables, idx, window)
