"""Cost analysis of one step: FLOPs, bytes, kernel charges and peak memory.

The port of ``src/repro/launch/hlo_analysis.py``, under its name.  The
reference parses the HLO that XLA compiled and multiplies the work inside
``while`` loops by their trip counts.  This module reads no HLO: it reads
the torch operations a step dispatches.  Torch runs eagerly, so every loop
iteration and every layer dispatches its own operations and no trip count
is needed.

``CostCounter`` is a ``TorchDispatchMode``; while it is active it counts

* ``flops``: 2·M·N·K for each matmul-class operation (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot``), as the reference counts
  only ``dot``; by the first matrix operand's dtype (``flops_by_dtype``)
  and on bf16 or f16 operands (``flops_bf16``);
* the hand kernels' charges (``kernels``, ``kernel_flops``,
  ``kernel_bytes``): each launch of B4, B5 and B6, forward and backward,
  charged by formula by its wrapper (``kernels/_cost.py``);
* ``bytes``: the reference's write-side proxy, twice each operation's
  output bytes plus the arguments' once; views and allocations that write
  nothing count nothing.  One eager operation is one kernel, so this is not
  XLA's fused figure and is not compared with it;
* live bytes: each storage from the first operation that outputs it until
  it is freed, beside the arguments' storages; their peak is
  ``peak_bytes``, the most one device holds at once.

It counts real tensors and fake ones (``FakeTensorMode``) alike.  A
recomputation (``torch.utils.checkpoint``) dispatches again and counts
again, as the reference's HLO holds the recompute; under a selective policy
(``context_fn``, which pushes its own dispatch mode above the counter) the
outputs it saved are served from its cache and not dispatched again, so
they count once.

``coll_bytes`` is None: the port runs no model-parallel step, so it has no
collective traffic to count (``COLL_BYTES_REASON``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Iterator

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _cost

__all__ = ["CostCounter", "Totals", "count_step", "tensors_of", "COLL_BYTES_REASON"]

COLL_BYTES_REASON = ("the port runs no model-parallel step: a cell's step runs whole on one "
                     "device, so no collective moves bytes")

_aten = torch.ops.aten
# matmul-class operations: (operand index of the first matrix, of the second)
_MATMULS = {_aten.mm: (0, 1), _aten.addmm: (1, 2), _aten.bmm: (0, 1), _aten.baddbmm: (1, 2),
            _aten.mv: (0, 1), _aten.addmv: (1, 2), _aten.dot: (0, 1), _aten.vdot: (0, 1)}
# allocations that write nothing, and a view not marked as one
_NO_WRITE = {_aten.empty, _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
             _aten.empty_like, _aten._unsafe_view}
_HALF = (torch.bfloat16, torch.float16)


class Totals(dict):
    """{'flops', 'flops_bf16', 'flops_by_dtype', 'bytes', 'kernel_flops',
    'kernel_bytes', 'kernels', 'peak_bytes', 'argument_bytes', 'coll_bytes'
    (None), 'coll_by_kind', 'coll_count'}: the reference's keys and the
    port's own."""


def tensors_of(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors_of(getattr(tree, f.name))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts what the operations dispatched while it is active cost
    (module docstring).  ``arguments``: the step's inputs, live from the
    start and read once."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.flops_bf16 = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, Any]] = {}
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}  # storage -> its bytes, while it lives
        self._paused = 0
        self._outer = None
        self.argument_bytes = 0
        for t in tensors_of(arguments):
            before = self.live
            self._hold(t)
            self.argument_bytes += self.live - before
        self.bytes += self.argument_bytes

    # ------------------------------------------------------------------ live bytes
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    # ------------------------------------------------------------------- counting
    def charge(self, c: _cost.Charge) -> None:
        """One kernel launch's charge (``kernels/_cost.py``)."""
        k = self.kernels.setdefault(c.name, {"calls": 0, "flops": 0.0, "bytes": 0.0,
                                             "rows_from_shape": False})
        k["calls"] += 1
        k["flops"] += c.flops
        k["bytes"] += c.bytes
        k["rows_from_shape"] |= c.rows_from_shape

    @contextlib.contextmanager
    def paused(self):
        """Count no FLOPs or bytes inside (live bytes are still followed)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._hold(t)
        if self._paused:
            return out
        packet = func.overloadpacket
        mm = _MATMULS.get(packet)
        if mm is not None:
            a, b = args[mm[0]], args[mm[1]]
            fl = 2.0 * outs[0].numel() * a.shape[-1]
            key = str(a.dtype).replace("torch.", "")
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + fl
            if a.dtype in _HALF or b.dtype in _HALF:
                self.flops_bf16 += fl
        if not func.is_view and packet not in _NO_WRITE:
            self.bytes += 2.0 * sum(_nbytes(t) for t in outs)
        return out

    def __enter__(self):
        self._outer, _cost.counter = _cost.counter, self
        return super().__enter__()

    def __exit__(self, *exc):
        _cost.counter = self._outer
        return super().__exit__(*exc)

    # ----------------------------------------------------------------------- result
    def totals(self) -> Totals:
        flops = sum(self.flops_by_dtype.values())
        kernels = {k: dict(v) for k, v in sorted(self.kernels.items())}
        return Totals(flops=flops, flops_bf16=self.flops_bf16,
                      flops_by_dtype=dict(sorted(self.flops_by_dtype.items())),
                      bytes=self.bytes,
                      kernel_flops=sum(v["flops"] for v in kernels.values()),
                      kernel_bytes=sum(v["bytes"] for v in kernels.values()),
                      kernels=kernels, peak_bytes=self.peak,
                      argument_bytes=self.argument_bytes,
                      coll_bytes=None, coll_by_kind={}, coll_count={})


def count_step(fn, *args, **kwargs) -> Totals:
    """``fn(*args, **kwargs)`` once under a ``CostCounter`` whose arguments
    are ``args``: its totals."""
    with CostCounter(arguments=args) as counter:
        fn(*args, **kwargs)
    return counter.totals()
