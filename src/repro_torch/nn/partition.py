"""Placing tensors on a ``torch.distributed`` device mesh: the DTensor
helpers the models' partitioned program (``launch/dryrun.py``) runs on.

A spec is a tuple with one entry per dimension, None (not split), an axis
name, or a tuple of axis names, written as the reference's
``PartitionSpec`` writes them (``P``).  ``named`` turns a spec into DTensor
placements (the reference's ``NamedSharding``); a dim split over an axis
group is split major to minor, as JAX splits it, so the group must follow
the mesh's axis order, in which two ``Shard``s of one dim give JAX's
offsets.  ``constrain`` is the reference's ``with_sharding_constraint``: a
``redistribute`` of a DTensor and nothing on a plain tensor, so a hint
leaves every unpartitioned path as it is.  ``mesh_placements`` builds the
placements of the layouts the models use by name (batch over the
data-parallel axes, one dim over ``model``), ``local_shard`` gives this
rank's shard of a shape, and ``local_call`` runs a function on the local
shards of an output whose split may be uneven.

``gather_plan`` and ``scatter_plan`` place the two halves of message
passing (``graph/segment_ops.py``'s DTensor forms).  A gather reads rows
of a node table by global id: the ids keep their split (edges over the
data-parallel axes; an index never crosses a collective, so a step on real
tensors over a fake group reads its own ids), the table is whole along its
rows on every mesh dim that splits the ids (an all-gather where it was
split), and the rows come out split as the ids are, the table's feature
split kept.  Each rank's gradient of the whole table is then one part of
a sum (``Partial``).  A scatter sums each rank's edges into a whole
(n, ...) table, a ``Partial`` one on every mesh dim that splits the edges,
which ``node_placements`` then reduces to the node tables' rule: rows over
those axes where they divide n (a reduce-scatter), else whole on every
rank (an all-reduce).

The spec rules of each family live in ``launch/sharding.py``, which
re-exports these helpers for its callers.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["P", "named", "constrain", "local_shard", "local_call", "mesh_placements",
           "contiguous_stride", "unsplit", "mesh_of", "as_dtensor", "gather_plan",
           "scatter_plan", "node_placements"]


def P(*dims) -> Tuple:
    """A spec tuple as the reference's ``PartitionSpec(*dims)`` writes it:
    an axis group of one name is that name, an empty group None."""
    def canon(d):
        if isinstance(d, (tuple, list)):
            d = tuple(d)
            return None if not d else d[0] if len(d) == 1 else d
        return d

    return tuple(canon(d) for d in dims)


def _axes(d) -> Tuple[str, ...]:
    return () if d is None else (d,) if isinstance(d, str) else tuple(d)


def named(dmesh, spec) -> Tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``dmesh``
    (one per mesh dim): ``Shard(i)`` on each axis that splits dim ``i``,
    ``Replicate()`` on the others."""
    names = tuple(dmesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, d in enumerate(spec or ()):
        axes = _axes(d)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axis group {axes} is not in the mesh's order {names}: JAX "
                             "splits it major to minor, which Shard on two mesh dims is not")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"mesh axis {names[m]!r} splits two dims in {spec}")
            out[m] = Shard(i)
    return tuple(out)


def constrain(x, spec):
    """The reference's ``with_sharding_constraint``: a DTensor
    redistributed to ``spec``'s placements on its own mesh (a no-op where it
    has them), any other value unchanged."""
    if spec is None or not isinstance(x, DTensor):
        return x
    want = named(x.device_mesh, spec)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def unsplit(x, dim: int):
    """A DTensor made whole along ``dim`` (``Replicate()`` on each mesh dim
    that splits it: an all-gather), its other placements kept; any other
    value unchanged.  Before a reduction along ``dim`` whose gradient
    DTensor cannot redistribute (a mean's ``Partial(avg)``) or a reshape
    that splits ``dim`` unevenly over the mesh."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def local_shard(shape, placements, dmesh) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(shape, offsets) of this rank's shard of a ``shape`` tensor placed
    by ``placements`` on ``dmesh`` (DTensor's own rule, which works on
    plain integers even inside a ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    with unset_fake_temporarily():
        local, offsets = compute_local_shape_and_global_offset(torch.Size(shape), dmesh,
                                                               placements)
    return tuple(int(n) for n in local), tuple(int(o) for o in offsets)


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (no tensor made: a
    cost counter would hold it)."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= int(d)
    return tuple(reversed(stride))


def mesh_placements(dmesh, *, dp=None, model=None, like=None) -> Tuple:
    """One placement per dim of ``dmesh``: ``model`` on the ``"model"``
    axis, ``dp`` on every other (the data-parallel axes); ``Replicate()``
    where None.  ``like`` (a DTensor): ``dp`` only on the data-parallel
    axes that split ``like``'s batch (its dim 0), ``Replicate()`` on the
    others (a batch too small to split, as decode's one sequence)."""
    out = []
    for i, name in enumerate(dmesh.mesh_dim_names):
        p = model if name == "model" else dp
        if name != "model" and like is not None and like.placements[i] != Shard(0):
            p = None
        out.append(p or Replicate())
    return tuple(out)


def local_call(fn, args, in_placements, in_grad_placements, out_placements, out_shape):
    """``local_map`` for one output whose global shape is given: each
    DTensor of ``args`` redistributed to its ``in_placements``, ``fn`` run
    on the local shards, the result a DTensor of ``out_shape`` placed by
    ``out_placements``.  ``local_map`` takes an output's global shape to be
    its local one times the split, which an uneven split (36 heads over 16
    ranks) is not.  Gradients come back placed by ``in_grad_placements``."""
    mesh = args[0].device_mesh
    local = []
    for a, pl, grad in zip(args, in_placements, in_grad_placements):
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        local.append(a.to_local(grad_placements=grad))
    return DTensor.from_local(fn(*local), mesh, out_placements, run_check=False,
                              shape=torch.Size(out_shape), stride=contiguous_stride(out_shape))


def mesh_of(*xs):
    """The device mesh of the first DTensor among ``xs``; None if none is one."""
    return next((x.device_mesh for x in xs if isinstance(x, DTensor)), None)


def as_dtensor(x, mesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    (one every rank made alike: a constant, a mask) replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def gather_plan(table: DTensor, ids: DTensor) -> Tuple[Tuple, Tuple, Tuple]:
    """(the table's placements for the gather, its local gradient's, the
    rows') of ``table[ids]`` (module docstring), one per mesh dim: where
    the ids are split the table is whole (its gradient a ``Partial`` sum)
    and the rows split as the ids; elsewhere the table keeps a feature
    split (the rows split on the same feature dim) and is whole along its
    rows."""
    table_in, grad, out = [], [], []
    for ip, tp in zip(ids.placements, table.placements):
        if isinstance(ip, Shard):
            table_in.append(Replicate())
            grad.append(Partial())
            out.append(ip)
        elif isinstance(tp, Shard) and tp.dim > 0:
            table_in.append(tp)
            grad.append(tp)
            out.append(Shard(tp.dim - 1 + ids.ndim))
        else:
            table_in.append(Replicate())
            grad.append(Replicate())
            out.append(Replicate())
    return tuple(table_in), tuple(grad), tuple(out)


def scatter_plan(data: DTensor, ids: DTensor) -> Tuple[Tuple, Tuple, Tuple]:
    """(the data's placements for the scatter, the ids', the summed
    table's) of a segment sum of ``data`` rows by ``ids`` (module
    docstring), one per mesh dim: where either splits the rows both take
    the ids' split, or the data's where the ids are whole (a local chunk
    of the ids, no collective), and the table is a ``Partial`` sum there;
    elsewhere the data's feature split (or ``Partial``) carries over."""
    data_in, ids_in, out = [], [], []
    for ip, dp in zip(ids.placements, data.placements):
        if isinstance(ip, Shard) or (isinstance(dp, Shard) and dp.dim == 0):
            rows = ip if isinstance(ip, Shard) else dp
            data_in.append(rows)
            ids_in.append(rows)
            out.append(Partial())
        else:
            data_in.append(dp)
            ids_in.append(Replicate())
            out.append(dp)
    return tuple(data_in), tuple(ids_in), tuple(out)


def node_placements(mesh, n: int, summed: Sequence) -> Tuple:
    """Where a summed (n, ...) table goes: on the mesh dims where it is a
    ``Partial`` sum, rows split over them when n divides by their sizes'
    product (a reduce-scatter), else whole (an all-reduce); the other
    placements kept."""
    dims = [m for m, p in enumerate(summed) if isinstance(p, Partial)]
    parts = math.prod(mesh.size(m) for m in dims)
    rows = Shard(0) if n % parts == 0 else Replicate()
    return tuple(rows if isinstance(p, Partial) else p for p in summed)
