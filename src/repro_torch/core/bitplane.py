"""Bit-packed mask plane: 32-bit words, little-endian bit order.

Entity ``e`` lives in bit ``e % 32`` of word ``e // 32`` — the layout of
``np.packbits(bitorder='little')`` viewed as ``<u4``, so host and device
packing agree bit for bit.  Tail padding bits (entities ≥ n inside the last
word) are ZERO everywhere, so word-space AND/OR never needs a masking
epilogue.

Device words are ``torch.int32`` holding the same bits as the uint32 words
of the host layout: torch on the CPU implements neither ``>>``/``<<`` nor
``>`` for ``torch.uint32``.  Convert at a numpy boundary with
``.view(np.uint32)`` / ``.view(np.int32)``; after an arithmetic right shift,
mask the bits you need (``& 1``).

The byte layout stays available behind ``REPRO_PG_BYTE_MASKS=1`` (env) or
the ``byte_masks()`` context manager; stores capture the flag when built.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

WORD = 32  # bits per packed word

__all__ = [
    "WORD", "n_words", "packed_default", "byte_masks",
    "pack_bits_host", "unpack_bits_host",
    "pack_mask", "unpack_mask", "or_reduce", "or_allreduce",
]

# None → consult the env var; True/False → explicit override (context manager).
_FORCE_BYTE: Optional[bool] = None


def packed_default() -> bool:
    """True when new stores should pack masks (the default)."""
    if _FORCE_BYTE is not None:
        return not _FORCE_BYTE
    return os.environ.get("REPRO_PG_BYTE_MASKS", "0") not in ("1", "true", "yes")


@contextlib.contextmanager
def byte_masks(enabled: bool = True) -> Iterator[None]:
    """Force the byte layout (or un-force it) for the enclosed block.

    Process-local and not thread-scoped: flip it before graphs are built —
    stores capture the flag at build time.
    """
    global _FORCE_BYTE
    prev = _FORCE_BYTE
    _FORCE_BYTE = bool(enabled)
    try:
        yield
    finally:
        _FORCE_BYTE = prev


def n_words(n: int) -> int:
    """Words needed for n entities (ceil(n / 32); 0 entities → 0 words)."""
    return (int(n) + WORD - 1) // WORD


# ---------------------------------------------------------------------------
# Host (numpy) pack / unpack — uint32 words
# ---------------------------------------------------------------------------

def pack_bits_host(bits: np.ndarray) -> np.ndarray:
    """Pack a host bool/int array along its LAST axis into uint32 words.

    ``(..., n)`` → ``(..., ceil(n/32))`` with bit ``e & 31`` of word
    ``e >> 5`` = ``bits[..., e]``; tail bits zero.
    """
    bits = np.asarray(bits)
    n = bits.shape[-1]
    w = n_words(n)
    packed8 = np.packbits(bits.astype(bool), axis=-1, bitorder="little")
    # packbits yields ceil(n/8) bytes; pad the byte axis to a 4-byte multiple
    # so the <u4 view lines up.  Pad bytes are zero → tail bits zero.
    pad = 4 * w - packed8.shape[-1]
    if pad:
        packed8 = np.concatenate(
            [packed8, np.zeros(bits.shape[:-1] + (pad,), np.uint8)], axis=-1)
    return np.ascontiguousarray(packed8).view("<u4").astype(np.uint32, copy=False)


def unpack_bits_host(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits_host`: ``(..., W)`` words → ``(..., n)`` bool.
    Accepts uint32 or int32 words (same bits)."""
    words = np.ascontiguousarray(np.asarray(words)).view("<u4")
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :n].astype(bool)


# ---------------------------------------------------------------------------
# Device (torch) pack / unpack — identical layout, int32 words
# ---------------------------------------------------------------------------

def _shifts(device, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(WORD, dtype=dtype, device=device)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """Pack a bool tensor along its last axis into int32 words.

    Pads the tail with False so padding bits are zero.  The 32 lanes of a
    word are summed in int64 (the bits are disjoint, so the sum is their OR)
    and wrapped to int32 — bit 31 would overflow an int32 sum.
    """
    n = mask.shape[-1]
    w = n_words(n)
    pad = w * WORD - n
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    lanes = mask.reshape(mask.shape[:-1] + (w, WORD)).to(torch.int64)
    words = (lanes << _shifts(mask.device)).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_mask`: ``(..., W)`` int32 → ``(..., n)`` bool.
    ``& 1`` after the shift drops the sign bits an arithmetic shift drags in."""
    bits = (words[..., None] >> _shifts(words.device, torch.int32)) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    return flat[..., :n].to(torch.bool)


def or_reduce(words: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Bitwise-OR reduction of int32 words over ``dim``.

    Torch has no OR reduction.  On a CUDA tensor this is the packed
    bitmap_query kernel with every row selected (the reduced axis becomes
    the kernel's K, everything else its word axis); on the CPU it is a
    plain fold over the axis.
    """
    from repro_torch.kernels.bitmap_query import ops

    moved = words.movedim(dim, 0)
    k, rest = moved.shape[0], moved.shape[1:]
    plane = moved.reshape(k, -1).contiguous()
    select = torch.ones((1, k), dtype=torch.bool, device=words.device)
    return ops.bitmap_query_batched_packed(plane, select)[0].reshape(rest)


def or_allreduce(parts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Bitwise-OR all-reduce of packed words across the P shards of a mesh:
    ``parts[i]`` is shard ``i``'s int32 words (on its device); every part
    of the result is the OR of all P.

    A max is not an OR on words (max(0b01, 0b10) = 0b10), and NCCL has no
    OR reduction.  For power-of-two P this is the recursive-doubling
    butterfly over ``ppermute``: log2(P) rounds, each moving W words —
    1 bit per entity; each round computes every shard's new value before
    any is overwritten.  Any other P gathers the parts and folds them
    (``or_reduce``)."""
    from repro_torch.launch.collectives import all_gather, ppermute

    parts = tuple(parts)
    p = len(parts)
    if p <= 1:
        return parts
    if p & (p - 1) == 0:
        d = 1
        while d < p:
            moved = ppermute(parts, [(i, i ^ d) for i in range(p)])
            parts = tuple(w | x for w, x in zip(parts, moved))
            d <<= 1
        return parts
    gathered = all_gather(parts)
    folded = {}
    for g in gathered:  # one fold per distinct stacked tensor (device)
        if id(g) not in folded:
            folded[id(g)] = or_reduce(g, dim=0)
    return tuple(folded[id(g)] for g in gathered)
