"""Public wrapper for the seg_mm kernel (B5): DI neighbourhood aggregation.

``seg_mm(x, src, dst, n)`` computes ``out[v] = Σ_{e: dst_e = v} w_e ·
x[src_e]``.  It checks its inputs, sends CPU tensors to the plain version
(``ref.seg_mm_ref``) and launches the CUDA kernel (``kernel.py``) on CUDA
tensors — there is no fallback from the card to the plain version.
``launches`` counts kernel launches (never plain-version calls);
``reset_launches()`` zeroes it.

The kernel reads a CSR layout of the edges: the row pointers of their
stable order by dst, and ``src`` permuted into that order, so a row's
edges are contiguous and the kernel needs no permutation of its own.
:func:`get_layout` builds the layout on the device (one stable
sort, one ``searchsorted`` and one gather; no host loop over tiles).

Gradients: on CUDA tensors that need one, ``seg_mm`` runs through
``_SegMM`` (a ``torch.autograd.Function``), whose backward is B5ᵀ: the
same kernel launched on the transposed layout (rows are the source ids),
``grad_x[s] = Σ_{e: src_e = s} w_e · grad_out[dst_e]``.  It follows the
reference's gradient (``ref.gather_rows``): an edge whose src lies outside
[-N_src, N_src), or whose dst the forward dropped, is left out of the
transposed layout; other src ids wrap.  The weights get no gradient on the
card (the GCN derives them from the indices): a weight that requires one
raises rather than getting a wrong zero.  ``launches[SEG_MM]`` counts
every launch, ``launches[SEG_MM_T]`` those of the backward.

The cache keeps one layout per orientation (``FORWARD``, ``TRANSPOSE``),
so a training step builds each once: both GCN layers pass one ``src`` and
``dst``, forward and backward.  It never serves a layout stale: it holds
the ``dst`` and ``src`` tensors the layout was built from and matches only
those tensor objects, each unmodified since (its ``_version``), at the same
``n_nodes`` (and N_src); a tensor made under ``torch.inference_mode``
tracks no version and is never matched.  Keying on ``id(dst)`` alone, as
the reference does, would hand a layout to whatever tensor next reuses a
freed one's id.  The
weights are permuted into dst order on every call (one gather of E
floats), never cached: the GCN makes them under ``torch.inference_mode``
when it serves, so they could never be matched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.seg_mm import kernel, ref

__all__ = ["SegMMLayout", "LayoutCache", "get_layout", "build_layout", "build_transposed_layout",
           "transposed_edges", "weights_in_dst_order", "seg_mm", "launches", "reset_launches",
           "FORWARD", "TRANSPOSE"]

SEG_MM = "seg_mm"  # B5, every launch
SEG_MM_T = "seg_mm_transposed"  # B5ᵀ: B5's launches for the gradient of x
launches: Dict[str, int] = {SEG_MM: 0, SEG_MM_T: 0}
FORWARD, TRANSPOSE = "forward", "transpose"  # the layout cache's orientations


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass(frozen=True)
class SegMMLayout:
    """CSR view of DI edges by destination.

    n_nodes:     the rows
    order:       (E,) int32 edge ids, stably sorted by dst
    row_ptr:     (n_nodes + 1,) int32; row v's edges are
                 ``order[row_ptr[v]:row_ptr[v + 1]]``.  Edges whose dst lies
                 outside [0, n_nodes) fall outside every row and are dropped.
    src_sorted:  ``src[order]`` (int32), what the kernel reads; None
                 without ``src``
    """

    n_nodes: int
    order: torch.Tensor
    row_ptr: torch.Tensor
    src_sorted: Optional[torch.Tensor] = None


def build_layout(dst_idx: torch.Tensor, n_nodes: int,
                 src_idx: Optional[torch.Tensor] = None) -> SegMMLayout:
    """The layout of ``dst_idx`` on its own device, uncached; with
    ``src_idx`` also that in dst order."""
    d64 = dst_idx.to(torch.int64)
    sorted_dst, order = torch.sort(d64, stable=True)
    bounds = torch.arange(int(n_nodes) + 1, dtype=torch.int64, device=dst_idx.device)
    row_ptr = torch.searchsorted(sorted_dst, bounds)
    order = order.to(torch.int32)
    return SegMMLayout(n_nodes=int(n_nodes), order=order, row_ptr=row_ptr.to(torch.int32),
                       src_sorted=None if src_idx is None else
                       torch.index_select(src_idx, 0, order))


def transposed_edges(dst_idx: torch.Tensor, n_nodes: int, src_idx: torch.Tensor,
                     n_src: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) int32 of the transposed edges, edge for edge: each edge
    feeds its (wrapped) src row from the forward's dst row.  Edges the
    forward dropped (dst outside [0, n_nodes)) and edges whose src lies
    outside [-n_src, n_src), which get no gradient, get dst -1, outside
    every row (and src 0, never read)."""
    s64, d64 = src_idx.to(torch.int64), dst_idx.to(torch.int64)
    ok = (d64 >= 0) & (d64 < n_nodes) & ref.in_range(s64, n_src)
    rows = torch.where(ok, torch.where(s64 < 0, s64 + n_src, s64), -1)
    return torch.where(ok, d64, 0).to(torch.int32), rows.to(torch.int32)


def build_transposed_layout(dst_idx: torch.Tensor, n_nodes: int, src_idx: torch.Tensor,
                            n_src: int) -> SegMMLayout:
    """The layout of the transposed edges (``transposed_edges``), uncached:
    rows are the ``n_src`` source ids, each edge's source the dst it feeds
    (B5ᵀ reads rows of the forward's output gradient).  Its ``order``
    indexes the forward's edges, so ``weights_in_dst_order`` permutes the
    forward's weights."""
    t_src, t_dst = transposed_edges(dst_idx, n_nodes, src_idx, n_src)
    return build_layout(t_dst, n_src, t_src)


def weights_in_dst_order(layout: SegMMLayout,
                         edge_weight: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``edge_weight`` permuted into ``layout``'s dst order (None stays None)."""
    return None if edge_weight is None else torch.index_select(edge_weight, 0, layout.order)


def _version(t: torch.Tensor) -> Optional[int]:
    """``t._version``; None for a tensor that tracks no version (made under
    ``torch.inference_mode``)."""
    return None if t.is_inference() else t._version


def _same(held: Optional[torch.Tensor], version: Optional[int],
          t: Optional[torch.Tensor]) -> bool:
    """``t`` is the tensor object held (or both None), unmodified since; a
    tensor that tracks no version never matches."""
    if t is None:
        return held is None
    return held is t and version is not None and _version(t) == version


@dataclasses.dataclass(frozen=True)
class _Key:
    """What a cached layout was built from: the ``dst`` and ``src`` tensor
    objects (held, so their ids cannot be reused while the entry lives) and
    their ``_version``s (None for an inference tensor), ``n_nodes`` and,
    transposed, N_src."""

    dst: torch.Tensor
    version: Optional[int]
    src: Optional[torch.Tensor]
    src_version: Optional[int]
    n_nodes: int
    n_src: Optional[int]

    def matches(self, dst, src, n_nodes: int, n_src: Optional[int]) -> bool:
        return (self.n_nodes == n_nodes and self.n_src == n_src
                and _same(self.dst, self.version, dst) and _same(self.src, self.src_version, src))


class LayoutCache:
    """The last layout built in each orientation, reused for the same
    ``dst`` and ``src`` tensor objects, each unmodified since, and the same
    ``n_nodes`` (and N_src); ``builds_by_orientation`` counts the misses by
    orientation, ``builds`` all of them."""

    def __init__(self):
        self.builds_by_orientation = {FORWARD: 0, TRANSPOSE: 0}
        self._held: Dict[str, Tuple[_Key, SegMMLayout]] = {}

    @property
    def builds(self) -> int:
        return sum(self.builds_by_orientation.values())

    def __len__(self) -> int:
        return len(self._held)

    def get(self, dst_idx: torch.Tensor, n_nodes: int, src_idx: Optional[torch.Tensor] = None,
            *, n_src: Optional[int] = None) -> SegMMLayout:
        """The forward layout, or with ``n_src`` the transposed one
        (:func:`build_transposed_layout`; ``src_idx`` required)."""
        n_nodes = int(n_nodes)
        orientation = FORWARD if n_src is None else TRANSPOSE
        held = self._held.get(orientation)
        if held is not None and held[0].matches(dst_idx, src_idx, n_nodes, n_src):
            return held[1]
        if n_src is None:
            layout = build_layout(dst_idx, n_nodes, src_idx)
        else:
            layout = build_transposed_layout(dst_idx, n_nodes, src_idx, int(n_src))
        key = _Key(dst_idx, _version(dst_idx), src_idx,
                   None if src_idx is None else _version(src_idx), n_nodes, n_src)
        self._held[orientation] = (key, layout)
        self.builds_by_orientation[orientation] += 1
        return layout


LAYOUTS = LayoutCache()


def get_layout(dst_idx: torch.Tensor, n_nodes: int,
               src_idx: Optional[torch.Tensor] = None) -> SegMMLayout:
    """The (cached) layout of ``dst_idx`` for ``n_nodes`` rows, with
    ``src_idx`` in dst order."""
    return LAYOUTS.get(dst_idx, n_nodes, src_idx)


def _check(x, src_idx, dst_idx, n_nodes: int, edge_weight) -> None:
    name = SEG_MM
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    if src_idx.dtype != torch.int32 or dst_idx.dtype != torch.int32:
        raise TypeError(f"{name}: src and dst must be int32, got {src_idx.dtype}, "
                        f"{dst_idx.dtype}")
    if x.dim() != 2 or src_idx.dim() != 1 or src_idx.shape != dst_idx.shape:
        raise ValueError(f"{name}: want x (N, D), src and dst (E,); got {tuple(x.shape)}, "
                         f"{tuple(src_idx.shape)}, {tuple(dst_idx.shape)}")
    tensors = [x, src_idx, dst_idx]
    if edge_weight is not None:
        if edge_weight.dtype != torch.float32:
            raise TypeError(f"{name}: edge_weight must be float32, got {edge_weight.dtype}")
        if edge_weight.shape != src_idx.shape:
            raise ValueError(f"{name}: edge_weight {tuple(edge_weight.shape)} does not match "
                             f"{tuple(src_idx.shape)} edges")
        tensors.append(edge_weight)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs on several devices {[t.device for t in tensors]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if n_nodes < 0 or max(n_nodes, src_idx.shape[0], x.shape[0]) >= 2**31:
        raise ValueError(f"{name}: n_nodes, edges and rows must lie in [0, 2**31)")
    if x.shape[0] == 0 and src_idx.shape[0] > 0:
        raise ValueError(f"{name}: x has no rows for the {src_idx.shape[0]} edges to read")


def _launch(x: torch.Tensor, layout: SegMMLayout, edge_weight: Optional[torch.Tensor],
            n_rows: int, *, transposed: bool = False) -> torch.Tensor:
    """B5 over ``layout`` into a new (n_rows, D) f32; a launch on the
    transposed layout counts as B5's and as B5ᵀ's."""
    out = torch.empty((n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    if out.numel():
        kernel.launch_seg_mm(x, layout.src_sorted, weights_in_dst_order(layout, edge_weight),
                             layout.row_ptr, out)
        launches[SEG_MM] += 1
        if transposed:
            launches[SEG_MM_T] += 1
    return out


class _SegMM(torch.autograd.Function):
    """B5 forward, B5ᵀ backward (module docstring); CUDA tensors only."""

    @staticmethod
    def forward(ctx, x, src_idx, dst_idx, n_nodes: int, edge_weight):
        ctx.n_nodes, ctx.n_src = n_nodes, x.shape[0]
        ctx.save_for_backward(src_idx, dst_idx, edge_weight)
        return _launch(x, get_layout(dst_idx, n_nodes, src_idx), edge_weight, n_nodes)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        src_idx, dst_idx, edge_weight = ctx.saved_tensors
        grad_x = None
        if ctx.needs_input_grad[0]:
            layout = LAYOUTS.get(dst_idx, ctx.n_nodes, src_idx, n_src=ctx.n_src)
            grad_x = _launch(grad_out.to(torch.float32).contiguous(), layout, edge_weight,
                             ctx.n_src, transposed=True)
        return grad_x, None, None, None, None


def seg_mm(x: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor, n_nodes: int, *,
           edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[v] = Σ_{e: dst_e = v} w_e · x[src_e] (B5 on the card).  ``x``
    (N_src, D) f32, ``src_idx``/``dst_idx`` (E,) int32 (a src id outside
    [0, N_src) reads the row the reference's gather reads, ``ref.gather_ids``;
    dst outside [0, n_nodes) is dropped), ``edge_weight`` (E,) f32 or None.
    Returns (n_nodes, D) f32; rows with no edge are zero.  Any order of
    ``dst_idx`` works; the last layout of each orientation is kept for the
    same ``src_idx`` and ``dst_idx``.  Differentiable in ``x`` (B5ᵀ on the
    card); on the card a weight that requires a gradient raises."""
    n_nodes = int(n_nodes)
    _check(x, src_idx, dst_idx, n_nodes, edge_weight)
    if x.device.type == "cpu":
        return ref.seg_mm_ref(x, src_idx, dst_idx, n_nodes, edge_weight=edge_weight)
    if torch.is_grad_enabled():
        if edge_weight is not None and edge_weight.requires_grad:
            raise NotImplementedError(
                "seg_mm: no gradient for edge_weight on the card (B5ᵀ computes the gradient of "
                "x only); pass edge_weight.detach()")
        if x.requires_grad:
            return _SegMM.apply(x, src_idx, dst_idx, n_nodes, edge_weight)
    return _launch(x, get_layout(dst_idx, n_nodes, src_idx), edge_weight, n_nodes)
