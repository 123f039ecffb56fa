"""Public wrapper for the embedding_bag kernel (B4): DLRM's pooled lookup.

``embedding_bag_fields(tables, idx)`` computes the (B, F, D) mean bags of
(B, F, MH) indices into (F, V, D) tables.  It checks its inputs, sends CPU
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
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.embedding_bag import kernel, ref
from repro_torch.kernels.seg_mm import ops as seg_mm_ops

__all__ = ["embedding_bag_fields", "backward_layout", "bag_gradient", "launches",
           "reset_launches"]

EMBEDDING_BAG = "embedding_bag"  # B4
EMBEDDING_BAG_BACKWARD = "embedding_bag_backward"  # B4's backward, on B5
launches: Dict[str, int] = {EMBEDDING_BAG: 0, EMBEDDING_BAG_BACKWARD: 0}


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


def backward_layout(idx: torch.Tensor, v: int) -> seg_mm_ops.SegMMLayout:
    """B5's layout for the gradient of (F, V, D) tables read by ``idx``
    (B, F, MH): rows are the F·V (field, row) pairs, edge (b, f, h) in
    ascending order reads bag b·F + f, and ids outside [-V, V) fall outside
    every row."""
    b, f, mh = idx.shape
    i64 = idx.to(torch.int64)
    field = torch.arange(f, dtype=torch.int64, device=idx.device).view(1, f, 1) * v
    rows = torch.where((i64 >= -v) & (i64 < v), torch.where(i64 < 0, i64 + v, i64) + field, -1)
    bags = torch.arange(b * f, dtype=torch.int32, device=idx.device).view(b, f, 1)
    return seg_mm_ops.build_layout(rows.reshape(-1).to(torch.int32), f * v,
                                   bags.expand(b, f, mh).reshape(-1))


class _EmbeddingBag(torch.autograd.Function):
    """B4 forward, its segment-sum backward on B5 (module docstring); CUDA
    tensors only."""

    @staticmethod
    def forward(ctx, tables, idx):
        ctx.table_shape, ctx.table_dtype = tables.shape, tables.dtype
        ctx.save_for_backward(idx)
        return _launch(tables, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return bag_gradient(grad_out, idx, ctx.table_shape, ctx.table_dtype), None


def bag_gradient(grad_out: torch.Tensor, idx: torch.Tensor, table_shape, dtype) -> torch.Tensor:
    """The gradient of (F, V, D) tables of ``dtype`` read by ``idx`` (B, F,
    MH) under the bags' gradient ``grad_out`` (B, F, D), on B5 (module
    docstring); CUDA tensors."""
    f, v, d = table_shape
    b, _, mh = idx.shape
    if f * v >= 2**31 or b * f * mh >= 2**31:
        raise ValueError(f"{EMBEDDING_BAG}: the backward takes F * V and B * F * MH below 2**31")
    if not (mh and f * v * d):
        return torch.zeros((f, v, d), dtype=dtype, device=idx.device)
    # a tensor divisor: a Python scalar would let CUDA multiply by 1/MH instead
    bags = grad_out.to(torch.float32) / torch.full((), float(mh), device=idx.device)
    grad = seg_mm_ops._launch(bags.reshape(b * f, d).contiguous(), backward_layout(idx, v), None,
                              f * v)  # every row written: empty rows as zeros
    launches[EMBEDDING_BAG_BACKWARD] += 1
    return grad.view(f, v, d).to(dtype)


def _launch(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = torch.empty((idx.shape[0], idx.shape[1], tables.shape[2]), dtype=tables.dtype,
                      device=tables.device)
    if out.numel():
        kernel.launch_embedding_bag(tables, idx, out)
        launches[EMBEDDING_BAG] += 1
    return out


def embedding_bag_fields(tables: torch.Tensor, idx: torch.Tensor, *, bt: int = 256) -> torch.Tensor:
    """(F, V, D) tables × (B, F, MH) int32 multi-hot indices → (B, F, D)
    mean bags in ``tables.dtype`` (f32 sums).  Indices in [-V, -1] wrap;
    others outside [0, V) give NaN bags, as the reference does.  ``bt`` (the
    reference's batch tile) is accepted and ignored: the card has no tile
    rule.  Differentiable in ``tables`` (on the card through B5)."""
    del bt
    _check(tables, idx)
    if tables.device.type == "cpu":
        return ref.embedding_bag_ref(tables, idx)
    if torch.is_grad_enabled() and tables.requires_grad:
        return _EmbeddingBag.apply(tables, idx)
    return _launch(tables, idx)
