"""Public wrappers for the bitmap_query kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, then routes by where the tensors lie: CPU tensors go to the
plain version (``ref.py``); CUDA tensors launch the hand-written kernel
(``kernel.py``) — there is no fallback from the card to the plain version.

``launches`` counts kernel launches per kernel (never plain-version calls),
so a run can show that its main path went through the kernels;
``reset_launches()`` zeroes it.

The ``*_sharded`` wrappers run the same kernels over a plane split across
an entity mesh (``launch/mesh.py``): a tuple of P contiguous shards, shard
``i`` on the mesh's ``devices[i]``.  Each launches its kernel once per
shard, on that shard's (K, N/P) bytes or (K, W/P) words, with the (Q, K)
selects copied to the shard's device; the output stays sharded (a tuple,
one part per shard) and no collective runs.  Each shard launch counts in
``launches``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

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


def _sharded(name: str, fn, shards: Sequence[torch.Tensor], masks: torch.Tensor,
             mesh) -> Tuple[torch.Tensor, ...]:
    """``fn(shard_i, masks on shard_i's device)`` for every shard; a shard
    not on its mesh device raises (no fallback to another device)."""
    from repro_torch.launch.collectives import broadcast

    shards = tuple(shards)
    if len(shards) != mesh.size:
        raise ValueError(f"{name}: {len(shards)} shards for a mesh of P={mesh.size}")
    for i, (shard, dev) in enumerate(zip(shards, mesh.devices)):
        if shard.device != dev:
            raise ValueError(f"{name}: shard {i} on {shard.device}, its mesh device is {dev}")
    masks = broadcast(masks, mesh.devices)
    return tuple(fn(shard, m) for shard, m in zip(shards, masks))


def bitmap_query_sharded(shards: Sequence[torch.Tensor], attr_mask: torch.Tensor, *,
                         mesh) -> Tuple[torch.Tensor, ...]:
    """Sharded single-mask query (B2 per shard): P (K, N/P) int8 shards ×
    (K,) bool → P (N/P,) bool parts, entity-sharded."""
    return _sharded(BYTE, bitmap_query, shards, attr_mask, mesh)


def bitmap_query_batched_sharded(shards: Sequence[torch.Tensor], attr_masks: torch.Tensor, *,
                                 mesh) -> Tuple[torch.Tensor, ...]:
    """Sharded multi-mask query (B2 per shard): (Q, K) selects on every
    shard → P (Q, N/P) bool parts, entity-sharded on N — the planner's
    fusion and the paper's distribution compose."""
    return _sharded(BYTE, bitmap_query_batched, shards, attr_masks, mesh)


def bitmap_query_packed_sharded(shards: Sequence[torch.Tensor], attr_mask: torch.Tensor, *,
                                mesh) -> Tuple[torch.Tensor, ...]:
    """Sharded packed query (B1 per shard): P (K, W/P) int32 word shards ×
    (K,) bool → P (W/P,) int32 parts, word-sharded (entity ownership stays
    word-aligned)."""
    return _sharded(PACKED, bitmap_query_packed, shards, attr_mask, mesh)


def bitmap_query_batched_packed_sharded(shards: Sequence[torch.Tensor],
                                        attr_masks: torch.Tensor, *,
                                        mesh) -> Tuple[torch.Tensor, ...]:
    """Sharded packed multi-mask query (B1 per shard): → P (Q, W/P) int32
    parts, word-sharded on W."""
    return _sharded(PACKED, bitmap_query_batched_packed, shards, attr_masks, mesh)
