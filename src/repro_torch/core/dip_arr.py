"""DIP-ARR — the 2-D Boolean attribute store (§IV-C of the paper).

For each attribute there is a Boolean row over the ``n`` entities (vertices
or edges); storing an attribute sets the entities that carry it.  Space
Θ(N·K); query O(N).  Two layouts, chosen at build time
(``bitplane.packed_default``):

  * packed — ``(k, ceil(n/32))`` int32 words holding the uint32 bit plane
    (entity ``e`` ↔ bit ``e & 31`` of word ``e >> 5``), tail bits zero;
  * byte   — ``(k, n)`` int8 in {0, 1}, the paper's byte Boolean array.

Query formulations:
  * ``query_any_scan``   — OR of the selected rows.
  * ``query_any_matvec`` — ``(mask @ bitmap) > 0`` as a ``torch.matmul`` on
    a byte store; on a packed store there is no matmul form of a word OR,
    so it is the word scan.
  * ``query_any_words``  — packed result, no unpack.

Every OR of selected rows goes through the ``bitmap_query`` wrappers: on
CUDA tensors they launch the hand-written kernels (packed B1, byte B2), on
CPU tensors they run the plain fold.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitplane
from repro_torch.core.device import resolve_device
from repro_torch.kernels.bitmap_query import ops as _ops

__all__ = [
    "DIPArr",
    "build_dip_arr",
    "build_dip_arr_host",
    "insert",
    "query_any_scan",
    "query_any_matvec",
    "query_any",
    "query_any_words",
    "query_any_batched",
    "query_any_batched_words",
    "query_any_batched_matvec",
    "attrs_of_entity",
    "entities_of_attr",
]


@dataclasses.dataclass(frozen=True)
class DIPArr:
    """(k attributes × n entities) presence bitmap, packed or byte.

    ``bitmap`` is a numpy array for a host build (``build_dip_arr_host``;
    packed words as uint32) and a tensor once placed on a device (packed
    words as int32, same bits)."""

    bitmap: object  # (k, n) int8 OR (k, ceil(n/32)) 32-bit words
    k: int
    n: int
    packed: bool = False


def build_dip_arr_host(entity_ids, attr_ids, *, k: int, n: int,
                       packed: bool | None = None) -> DIPArr:
    """Host (numpy) build: flag ``bitmap[attr, entity]`` for every pair;
    out-of-range pairs are dropped.  The packed build scatters single-bit
    ORs straight into the word plane — no (k, n) byte array in between."""
    if packed is None:
        packed = bitplane.packed_default()
    entity_ids = np.asarray(entity_ids, np.int32).ravel()
    attr_ids = np.asarray(attr_ids, np.int32).ravel()
    ok = (entity_ids >= 0) & (entity_ids < n) & (attr_ids >= 0) & (attr_ids < k)
    if packed:
        ent, att = entity_ids[ok], attr_ids[ok]
        plane = np.zeros((k, bitplane.n_words(n)), np.uint32)
        np.bitwise_or.at(plane, (att, ent >> 5), np.uint32(1) << (ent & 31).astype(np.uint32))
        return DIPArr(bitmap=plane, k=k, n=n, packed=True)
    bitmap = np.zeros((k, n), np.int8)
    bitmap[attr_ids[ok], entity_ids[ok]] = 1
    return DIPArr(bitmap=bitmap, k=k, n=n, packed=False)


def to_device(host: DIPArr, device) -> DIPArr:
    """Place a host build on ``device`` (packed words viewed as int32)."""
    bm = np.ascontiguousarray(host.bitmap)
    if host.packed:
        bm = bm.view(np.int32)
    return dataclasses.replace(host, bitmap=torch.from_numpy(bm).to(device))


def build_dip_arr(entity_ids, attr_ids, *, k: int, n: int,
                  packed: bool | None = None, device=None) -> DIPArr:
    """Bulk build through ``build_dip_arr_host``, then placed on ``device``
    (None: the CUDA card, raising if there is none)."""
    device = resolve_device(device)
    return to_device(build_dip_arr_host(entity_ids, attr_ids, k=k, n=n, packed=packed),
                     device)


def insert(dip: DIPArr, entity_ids, attr_ids) -> DIPArr:
    """Functional bulk insert of additional (entity, attribute) pairs;
    out-of-range pairs are dropped."""
    dev = dip.bitmap.device
    ent = torch.as_tensor(np.asarray(entity_ids), device=dev).to(torch.int64).ravel()
    att = torch.as_tensor(np.asarray(attr_ids), device=dev).to(torch.int64).ravel()
    ok = (ent >= 0) & (ent < dip.n) & (att >= 0) & (att < dip.k)
    ent, att = ent[ok], att[ok]
    if dip.packed:
        # no scatter combines with OR, so round-trip through bits (the
        # cold path; bulk loads scatter words in build_dip_arr_host)
        bits = bitplane.unpack_mask(dip.bitmap, dip.n)
        bits[att, ent] = True
        return dataclasses.replace(dip, bitmap=bitplane.pack_mask(bits))
    bitmap = dip.bitmap.clone()
    bitmap[att, ent] = 1
    return dataclasses.replace(dip, bitmap=bitmap)


def query_any_words(dip: DIPArr, attr_mask: torch.Tensor) -> torch.Tensor:
    """Packed query, packed result: (k,) bool → (W,) int32 words."""
    if not dip.packed:
        raise ValueError("query_any_words requires a packed store")
    return _ops.bitmap_query_packed(dip.bitmap, attr_mask)


def query_any_batched_words(dip: DIPArr, attr_masks: torch.Tensor) -> torch.Tensor:
    """Q packed queries in one launch: (Q, K) bool → (Q, W) int32."""
    if not dip.packed:
        raise ValueError("query_any_batched_words requires a packed store")
    return _ops.bitmap_query_batched_packed(dip.bitmap, attr_masks)


def query_any_scan(dip: DIPArr, attr_mask: torch.Tensor) -> torch.Tensor:
    """Paper-faithful query: OR of the selected attribute rows.
    ``attr_mask`` is the (k,) bool query (OR semantics, §VI)."""
    if dip.packed:
        return bitplane.unpack_mask(query_any_words(dip, attr_mask), dip.n)
    return _ops.bitmap_query(dip.bitmap, attr_mask)


def _matvec(bitmap: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """counts = masks @ bitmap; > 0 is exact in any float type (non-negative
    integer terms, counts ≤ k).  Half precision on the card, float32 on the
    CPU (which has no fast half matmul)."""
    dt = torch.float16 if bitmap.device.type == "cuda" else torch.float32
    return (masks.to(dt) @ bitmap.to(dt)) > 0


def query_any_matvec(dip: DIPArr, attr_mask: torch.Tensor) -> torch.Tensor:
    """OR-of-rows as a matvec: ``counts > 0``.  A packed store has no
    matmul form of a word OR, so this is the word scan there."""
    if dip.packed:
        return bitplane.unpack_mask(query_any_words(dip, attr_mask), dip.n)
    return _matvec(dip.bitmap, attr_mask[None, :])[0]


def query_any(dip: DIPArr, attr_mask: torch.Tensor, *, impl: str = "matvec") -> torch.Tensor:
    """``scan`` and ``kernel`` are one path here: the OR of selected rows is
    the bitmap_query kernel on the card and its plain version on the CPU."""
    if impl in ("scan", "kernel"):
        return query_any_scan(dip, attr_mask)
    if impl == "matvec":
        return query_any_matvec(dip, attr_mask)
    raise ValueError(f"unknown impl {impl!r}")


def query_any_batched_matvec(dip: DIPArr, attr_masks: torch.Tensor) -> torch.Tensor:
    """Q OR-queries as one matmul ``(Q, K) @ (K, N) > 0``."""
    if dip.packed:
        return bitplane.unpack_mask(query_any_batched_words(dip, attr_masks), dip.n)
    return _matvec(dip.bitmap, attr_masks)


def query_any_batched(dip: DIPArr, attr_masks: torch.Tensor, *,
                      impl: str = "matvec") -> torch.Tensor:
    """attr_masks: (Q, K) bool → (Q, N) bool, one launch for all Q queries."""
    if impl == "matvec":
        return query_any_batched_matvec(dip, attr_masks)
    if impl in ("scan", "kernel"):
        if dip.packed:
            return bitplane.unpack_mask(query_any_batched_words(dip, attr_masks), dip.n)
        return _ops.bitmap_query_batched(dip.bitmap, attr_masks)
    raise ValueError(f"unknown impl {impl!r}")


def attrs_of_entity(dip: DIPArr, e: int) -> torch.Tensor:
    """Column read: (k,) bool of attributes held by entity ``e``."""
    if dip.packed:
        word = dip.bitmap[:, e >> 5]
        return ((word >> (e & 31)) & 1).to(torch.bool)
    return dip.bitmap[:, e].to(torch.bool)


def entities_of_attr(dip: DIPArr, a: int) -> torch.Tensor:
    """Row read: (n,) bool of entities carrying attribute ``a``."""
    if dip.packed:
        return bitplane.unpack_mask(dip.bitmap[a, :], dip.n)
    return dip.bitmap[a, :].to(torch.bool)
