"""Collectives over an entity mesh, single-controller.

A sharded value is a tuple of P tensors, part ``i`` on the mesh's
``devices[i]``.  These are the port's counterparts of the reference's
``pmax``/``pmin``/``psum``, ``all_gather`` and ``ppermute`` inside its
``shard_map``: one process moves the parts with
``tensor.to(device, non_blocking=True)``, a no-op when source and target
are the same device (P shards on one card) and a peer copy between cards.

Ordering across cards: PyTorch enqueues a copy between two CUDA devices
after the work already queued on both devices' current streams, so a copy
of a kernel's output never overtakes the kernel (the bitmap_query launchers
queue on the current stream of the plane's device).

Each reduction is computed once per DISTINCT device, in shard order, and
every part on that device shares the result: on one card a P-way
all-reduce is one fold, not P.  Results may alias one another and the
inputs (``.to`` of a tensor already in place returns it), so callers treat
them as read-only, as the reference's immutable arrays are.

NCCL has no bitwise-OR reduction; the packed words' OR all-reduce is
``core.bitplane.or_allreduce``, built from ``ppermute`` and
``all_gather`` here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["all_reduce", "all_gather", "ppermute", "broadcast", "gather"]

_OPS = {"max": torch.maximum, "min": torch.minimum, "sum": torch.add}


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def _per_device(parts: Sequence[torch.Tensor], build) -> Tuple[torch.Tensor, ...]:
    """``build(device)`` once for every distinct device of ``parts``; each
    part's slot gets its device's result."""
    done: Dict[torch.device, torch.Tensor] = {}
    for p in parts:
        if p.device not in done:
            done[p.device] = build(p.device)
    return tuple(done[p.device] for p in parts)


def all_reduce(parts: Sequence[torch.Tensor], op: str) -> Tuple[torch.Tensor, ...]:
    """Element-wise ``max``, ``min`` or ``sum`` of the P parts, replicated:
    part ``i`` of the result, on ``parts[i].device``, is the reduction of
    all P.  The fold runs in shard order (``((p0 ⊕ p1) ⊕ p2) …``), so a
    float ``sum`` reassociates against a single-device scatter-add and
    agrees with it within a tolerance only; ``max``/``min`` are exact
    (``min`` and ``max`` propagate NaN, as XLA's do).  ``max`` over bool
    parts is their OR."""
    if op not in _OPS:
        raise ValueError(f"unknown all_reduce op {op!r}; known: {sorted(_OPS)}")
    parts = list(parts)
    if len(parts) == 1:
        return (parts[0],)
    fn = torch.logical_or if (op == "max" and parts[0].dtype == torch.bool) else _OPS[op]

    def build(device):
        acc = _to(parts[0], device)
        for p in parts[1:]:
            acc = fn(acc, _to(p, device))
        return acc

    return _per_device(parts, build)


def all_gather(parts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Every part stacked in shard order, ``(P, ...)``, on every part's
    device."""
    parts = list(parts)
    return _per_device(parts, lambda device: torch.stack([_to(p, device) for p in parts]))


def ppermute(parts: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> Tuple[torch.Tensor, ...]:
    """Part ``dst`` of the result is part ``src`` of the input, moved to
    ``dst``'s device, for every ``(src, dst)`` in ``perm``; a part no pair
    targets is zeros, as ``lax.ppermute`` leaves it."""
    parts = list(parts)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"ppermute: shard {dst} is targeted twice")
        out[dst] = _to(parts[src], parts[dst].device)
    return tuple(torch.zeros_like(p) if o is None else o for p, o in zip(parts, out))


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> Tuple[torch.Tensor, ...]:
    """``x`` on each of ``devices`` — one copy per distinct device (the
    replicated input of a sharded step, ``P()`` in the reference)."""
    done: Dict[torch.device, torch.Tensor] = {}
    for d in devices:
        if d not in done:
            done[d] = _to(x, d)
    return tuple(done[d] for d in devices)


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = -1) -> torch.Tensor:
    """The sharded value as ONE tensor on ``device``: the parts
    concatenated along ``dim`` in shard order.  The counterpart of the
    reference's implicit GSPMD gather when an unsharded op reads a
    sharded array."""
    parts = [_to(p, device) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
