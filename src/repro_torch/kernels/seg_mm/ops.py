"""Public wrapper for the seg_mm kernel (B5): DI neighbourhood aggregation.

``seg_mm(x, src, dst, n)`` computes ``out[v] = Σ_{e: dst_e = v} w_e ·
x[src_e]``.  It checks its inputs, sends CPU tensors to the plain version
(``ref.seg_mm_ref``) and launches the CUDA kernel (``kernel.py``) on CUDA
tensors — there is no fallback from the card to the plain version.
``launches`` counts kernel launches (never plain-version calls);
``reset_launches()`` zeroes it.

The kernel reads a CSR layout of the edges: their stable order by dst and
the (n + 1,) row pointers, both built on the device by :func:`get_layout`
(one stable sort and one ``searchsorted``; no host loop over tiles).  The
cache keeps the last layout only, which is all a batch reuses (both GCN
layers pass one ``dst``), and never serves it stale: it holds the ``dst``
tensor the layout was built from and matches only that tensor object,
unmodified since (its ``_version``), at the same ``n_nodes``.  Keying on
``id(dst)`` alone, as the reference does, would hand a layout to whatever
tensor next reuses a freed one's id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.kernels.seg_mm import kernel, ref

__all__ = ["SegMMLayout", "LayoutCache", "get_layout", "build_layout", "seg_mm",
           "launches", "reset_launches"]

SEG_MM = "seg_mm"  # B5
launches: Dict[str, int] = {SEG_MM: 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass(frozen=True)
class SegMMLayout:
    """CSR view of DI edges by destination.

    dst:     the (E,) int32 tensor the layout was built from (held, so its
             id cannot be reused while the entry lives)
    version: ``dst._version`` at build time
    order:   (E,) int32 edge ids, stably sorted by dst
    row_ptr: (n_nodes + 1,) int32; row v's edges are
             ``order[row_ptr[v]:row_ptr[v + 1]]``.  Edges whose dst lies
             outside [0, n_nodes) fall outside every row and are dropped.
    """

    dst: torch.Tensor
    version: int
    n_nodes: int
    order: torch.Tensor
    row_ptr: torch.Tensor


def build_layout(dst_idx: torch.Tensor, n_nodes: int) -> SegMMLayout:
    """The layout of ``dst_idx`` on its own device, uncached."""
    d64 = dst_idx.to(torch.int64)
    sorted_dst, order = torch.sort(d64, stable=True)
    bounds = torch.arange(int(n_nodes) + 1, dtype=torch.int64, device=dst_idx.device)
    row_ptr = torch.searchsorted(sorted_dst, bounds)
    return SegMMLayout(dst=dst_idx, version=dst_idx._version, n_nodes=int(n_nodes),
                       order=order.to(torch.int32), row_ptr=row_ptr.to(torch.int32))


class LayoutCache:
    """The last layout built; ``builds`` counts the misses."""

    def __init__(self):
        self.builds = 0
        self._last: Optional[SegMMLayout] = None

    def __len__(self) -> int:
        return int(self._last is not None)

    def get(self, dst_idx: torch.Tensor, n_nodes: int) -> SegMMLayout:
        n_nodes = int(n_nodes)
        last = self._last
        if (last is not None and last.dst is dst_idx and last.version == dst_idx._version
                and last.n_nodes == n_nodes):
            return last
        self._last = layout = build_layout(dst_idx, n_nodes)
        self.builds += 1
        return layout


LAYOUTS = LayoutCache()


def get_layout(dst_idx: torch.Tensor, n_nodes: int) -> SegMMLayout:
    """The (cached) layout of ``dst_idx`` for ``n_nodes`` rows."""
    return LAYOUTS.get(dst_idx, n_nodes)


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


def seg_mm(x: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor, n_nodes: int, *,
           edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[v] = Σ_{e: dst_e = v} w_e · x[src_e] (B5 on the card).  ``x``
    (N_src, D) f32, ``src_idx``/``dst_idx`` (E,) int32 (a src id outside
    [0, N_src) reads the row the reference's gather reads, ``ref.gather_ids``;
    dst outside [0, n_nodes) is dropped), ``edge_weight`` (E,) f32 or None.
    Returns (n_nodes, D) f32; rows with no edge are zero.  Any order of
    ``dst_idx`` works; the last layout is kept for the same ``dst_idx``."""
    n_nodes = int(n_nodes)
    _check(x, src_idx, dst_idx, n_nodes, edge_weight)
    if x.device.type == "cpu":
        return ref.seg_mm_ref(x, src_idx, dst_idx, n_nodes, edge_weight=edge_weight)
    out = torch.empty((n_nodes, x.shape[1]), dtype=torch.float32, device=x.device)
    if out.numel():
        layout = get_layout(dst_idx, n_nodes)
        kernel.launch_seg_mm(x, src_idx, edge_weight, layout.order, layout.row_ptr, out)
        launches[SEG_MM] += 1
    return out
