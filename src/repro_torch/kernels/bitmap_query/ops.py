"""Public wrappers for the bitmap_query kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, then routes by where the tensors lie: CPU tensors go to the
plain version (``ref.py``); CUDA tensors launch the hand-written kernel
(``kernel.py``) — there is no fallback from the card to the plain version.

``launches`` counts kernel launches per kernel (never plain-version calls),
so a run can show that its main path went through the kernels;
``reset_launches()`` zeroes it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.bitmap_query import kernel, ref

PACKED = "bitmap_query_packed"  # B1
BYTE = "bitmap_query_byte"  # B2

launches: Dict[str, int] = {PACKED: 0, BYTE: 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# Q-dimension buckets for the batched entries (the service layer pads
# coalesced mask batches to these sizes; all-False pad rows give all-zero
# output rows, sliced off by the caller).
Q_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucketed_q(q: int) -> int:
    """Smallest bucket ≥ ``q`` (multiples of the largest bucket beyond it)."""
    if q < 1:
        raise ValueError(f"q must be ≥ 1, got {q}")
    for b in Q_BUCKETS:
        if q <= b:
            return b
    top = Q_BUCKETS[-1]
    return -(-q // top) * top


def _check(name: str, plane: torch.Tensor, masks: torch.Tensor, dtype: torch.dtype) -> None:
    if plane.dtype != dtype or plane.dim() != 2:
        raise TypeError(f"{name}: plane must be 2-D {dtype}, got {plane.dim()}-D {plane.dtype}")
    if masks.dtype != torch.bool or masks.dim() != 2:
        raise TypeError(f"{name}: masks must be 2-D bool, got {masks.dim()}-D {masks.dtype}")
    if masks.shape[1] != plane.shape[0]:
        raise ValueError(f"{name}: masks {tuple(masks.shape)} do not select the rows of "
                         f"plane {tuple(plane.shape)}")
    if plane.device != masks.device:
        raise ValueError(f"{name}: plane on {plane.device}, masks on {masks.device}")
    if plane.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {plane.device}")
    if not (plane.is_contiguous() and masks.is_contiguous()):
        raise ValueError(f"{name}: plane and masks must be contiguous")
    if max(plane.shape[0], plane.shape[1], masks.shape[0]) >= 2**31:
        raise ValueError(f"{name}: dimensions must fit in int32")


def bitmap_query_batched_packed(plane: torch.Tensor, attr_masks: torch.Tensor) -> torch.Tensor:
    """(K, W) int32 word plane × (Q, K) bool queries → (Q, W) int32 word
    masks, one launch for all Q (B1)."""
    _check(PACKED, plane, attr_masks, torch.int32)
    if plane.device.type == "cpu":
        return ref.bitmap_query_batched_packed_ref(plane, attr_masks)
    q, w = attr_masks.shape[0], plane.shape[1]
    out = torch.empty((q, w), dtype=torch.int32, device=plane.device)
    if q * w:
        kernel.launch_packed(plane, attr_masks, out)
        launches[PACKED] += 1
    return out


def bitmap_query_packed(plane: torch.Tensor, attr_mask: torch.Tensor) -> torch.Tensor:
    """(K, W) int32 word plane × (K,) bool query → (W,) int32 word mask."""
    return bitmap_query_batched_packed(plane, attr_mask[None, :])[0]


def bitmap_query_batched(bitmap: torch.Tensor, attr_masks: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 bitmap × (Q, K) bool queries → (Q, N) bool entity masks,
    one launch for all Q (B2)."""
    _check(BYTE, bitmap, attr_masks, torch.int8)
    if bitmap.device.type == "cpu":
        return ref.bitmap_query_batched_ref(bitmap, attr_masks)
    q, n = attr_masks.shape[0], bitmap.shape[1]
    out = torch.empty((q, n), dtype=torch.bool, device=bitmap.device)
    if q * n:
        kernel.launch_byte(bitmap, attr_masks, out)
        launches[BYTE] += 1
    return out


def bitmap_query(bitmap: torch.Tensor, attr_mask: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 bitmap × (K,) bool query → (N,) bool entity mask."""
    return bitmap_query_batched(bitmap, attr_mask[None, :])[0]
