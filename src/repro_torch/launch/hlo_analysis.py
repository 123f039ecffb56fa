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

* collectives (``coll_bytes``, ``coll_by_kind``, ``coll_count``): each
  ``_c10d_functional`` all-gather, reduce-scatter, all-reduce and
  all-to-all, and DTensor's ``shard_dim_alltoall``, charged on the group's
  size p and the output's bytes by the reference's ring model
  (``ring_bytes``: all-reduce 2(p−1)/p·out, all-gather and all-to-all
  (p−1)/p·out, reduce-scatter (p−1)·out, any other out), under its kinds.

Over DTensors (the partitioned program, ``launch/dryrun.py``) it steps
aside for each DTensor operation, as ``CommDebugMode`` does, and counts the
local operations and collectives DTensor runs for it: one rank's FLOPs,
bytes, live bytes and traffic.  An all-to-all that DTensor lowers to an
all-gather and a chunk on a CPU mesh (gloo has none) is run as the
all-to-all, on tensors that hold no data, and booked as one: what the
card's mesh runs.

It counts real tensors and fake ones (``FakeTensorMode``) alike.  A
recomputation (``torch.utils.checkpoint``) dispatches again and counts
again, as the reference's HLO holds the recompute; under a selective policy
(``context_fn``, which pushes its own dispatch mode above the counter) the
outputs it saved are served from its cache and not dispatched again, so
they count once.

A step on plain tensors runs whole on one device and issues no
collective: its ``coll_bytes`` is None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Iterator

import torch
from torch.distributed.tensor import DTensor as _DTensor
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _cost

__all__ = ["CostCounter", "Totals", "count_step", "tensors_of", "ring_bytes"]

_aten = torch.ops.aten
# matmul-class operations: (operand index of the first matrix, of the second)
_MATMULS = {_aten.mm: (0, 1), _aten.addmm: (1, 2), _aten.bmm: (0, 1), _aten.baddbmm: (1, 2),
            _aten.mv: (0, 1), _aten.addmv: (1, 2), _aten.dot: (0, 1), _aten.vdot: (0, 1)}
# allocations that write nothing, and a view not marked as one
_NO_WRITE = {_aten.empty, _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
             _aten.empty_like, _aten._unsafe_view}
_HALF = (torch.bfloat16, torch.float16)


def _ops(namespace, kinds: Dict[str, str]) -> Dict:
    """{overload packet: kind} of the ``namespace`` ops.  A torch without
    one of them would issue a collective the counter cannot see: raise."""
    out = {}
    for name, kind in kinds.items():
        try:
            out[getattr(namespace, name)] = kind
        except (AttributeError, RuntimeError) as e:
            raise RuntimeError(f"torch {torch.__version__} has no {namespace}.{name}: the "
                               "cost counter cannot book that collective") from e
    return out


# collectives by kind, as the reference's HLO names them
_COLLECTIVES = {
    **_ops(torch.ops._c10d_functional, {
        "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
        "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
        "all_to_all_single": "all-to-all"}),
    **_ops(torch.ops._dtensor, {"shard_dim_alltoall": "all-to-all"}),
}
_WAIT = set(_ops(torch.ops._c10d_functional, {"wait_tensor": ""}))


def ring_bytes(kind: str, p: int, out_bytes: float) -> float:
    """One collective's traffic on a group of ``p`` with ``out_bytes`` of
    output: the reference's ring model (``hlo_analysis.py``)."""
    p = max(int(p), 1)
    if kind == "all-reduce":
        return 2 * (p - 1) / p * out_bytes
    if kind in ("all-gather", "all-to-all"):
        return (p - 1) / p * out_bytes
    if kind == "reduce-scatter":
        return (p - 1) * out_bytes
    return float(out_bytes)


def _group_size(func, args, kwargs) -> int:
    """The group size of a collective: its ``group_size`` argument, else
    the size of the group its name (or object) resolves to."""
    schema = func._schema.arguments
    named = dict(zip((a.name for a in schema), args), **(kwargs or {}))
    if "group_size" in named:
        return int(named["group_size"])
    group = named.get("group_name", named.get("group"))
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(group)
    return group.size()


def _patched(owner, name: str, make) -> contextlib.AbstractContextManager:
    """``owner.name`` replaced by ``make(original)`` inside the ``with``.
    A torch without ``owner.name`` is refused: the counter would then count
    what it must not, or miss what it must, with nothing to show it."""
    original = getattr(owner, name, None)
    if original is None:
        raise RuntimeError(f"torch {torch.__version__} has no {owner.__name__}.{name}, which "
                           "the cost counter patches to count DTensor programs")

    @contextlib.contextmanager
    def patch():
        setattr(owner, name, make(original))
        try:
            yield
        finally:
            setattr(owner, name, original)

    return patch()


def _unseen_sharding_propagation(counter) -> contextlib.AbstractContextManager:
    """DTensor works out an operation's output shape by running it on fake
    tensors of the global shapes (``_propagate_tensor_meta_non_cached``,
    which its cached paths call too), and, for an operation it has no rule
    for, a strategy by running its decomposition on them
    (``DecompShardingStrategy.propagate_strategy``, where this torch has
    it: the first call of each operation and placement, a (1,000,448, 64)
    f32 table's worth for retrieval's ``mv``); the counter ignores those
    runs (they are no rank's work)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def ignoring(original):
        def run(*args, **kwargs):
            counter._ignore += 1
            try:
                return original(*args, **kwargs)
            finally:
                counter._ignore -= 1
        return run

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                                 ignoring))
    try:
        from torch.distributed.tensor._decompositions import DecompShardingStrategy
    except ImportError:  # a torch that propagates no strategy through decompositions
        return stack
    stack.enter_context(_patched(DecompShardingStrategy, "propagate_strategy", ignoring))
    return stack


def _alltoall_as_on_the_card() -> contextlib.AbstractContextManager:
    """DTensor's ``shard_dim_alltoall`` on a CPU mesh run as the card's
    all-to-all op when its input holds no data (module docstring); on data
    it keeps gloo's all-gather and chunk.  Patched where it is defined and
    where ``Shard`` calls it."""
    from torch.distributed.tensor import _collective_utils, placement_types

    from repro_torch.core.device import holds_data

    original = _collective_utils.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu" or holds_data(input):
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     mesh.get_group(mesh_dim).group_name)

    if getattr(placement_types, "shard_dim_alltoall", None) is not original:
        raise RuntimeError(f"torch {torch.__version__}'s Shard does not call "
                           "_collective_utils.shard_dim_alltoall, which the cost counter patches")
    stack = contextlib.ExitStack()
    for m in (_collective_utils, placement_types):
        stack.enter_context(_patched(m, "shard_dim_alltoall", lambda _: alltoall))
    return stack


class Totals(dict):
    """{'flops', 'flops_bf16', 'flops_by_dtype', 'bytes', 'kernel_flops',
    'kernel_bytes', 'kernels', 'peak_bytes', 'argument_bytes', 'coll_bytes'
    (None where no collective ran), 'coll_by_kind', 'coll_count'}: the
    reference's keys and the port's own."""


def tensors_of(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses (of a
    DTensor, its local shard)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        yield tree.to_local()
    elif torch.is_tensor(tree):
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
        self.coll_by_kind: Dict[str, float] = {}
        self.coll_count: Dict[str, int] = {}
        self._patches = None
        self._ignore = 0
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
    def _hold(self, t: torch.Tensor, own: bool = False) -> None:
        """Follow ``t``'s storage while it lives: its bytes, or with ``own``
        the tensor's own (a collective's output, which the card allocates
        whole: a fake all-to-all returns a view of a p-times larger buffer)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = _nbytes(t) if own else st.nbytes()
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
        if any(issubclass(t, _DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local operations come back here
        out = func(*args, **(kwargs or {}))
        if self._ignore:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func.overloadpacket
        kind = _COLLECTIVES.get(packet)
        for t in outs:
            self._hold(t, own=kind is not None)
        if self._paused:
            return out
        if kind is not None:
            p = _group_size(func, args, kwargs)
            for t in outs:
                traffic = ring_bytes(kind, p, _nbytes(t))
                self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + traffic
                self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
            return out
        if packet in _WAIT:
            return out
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
        self._patches = contextlib.ExitStack()
        self._patches.enter_context(_alltoall_as_on_the_card())
        self._patches.enter_context(_unseen_sharding_propagation(self))
        return super().__enter__()

    def __exit__(self, *exc):
        _cost.counter = self._outer
        self._patches.close()
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
                      coll_bytes=sum(self.coll_by_kind.values()) if self.coll_count else None,
                      coll_by_kind=dict(sorted(self.coll_by_kind.items())),
                      coll_count=dict(sorted(self.coll_count.items())))


def count_step(fn, *args, **kwargs) -> Totals:
    """``fn(*args, **kwargs)`` once under a ``CostCounter`` whose arguments
    are ``args``: its totals."""
    with CostCounter(arguments=args) as counter:
        fn(*args, **kwargs)
    return counter.totals()
