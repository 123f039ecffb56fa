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

The spec rules of each family live in ``launch/sharding.py``, which
re-exports these helpers for its callers.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["P", "named", "constrain", "local_shard", "local_call", "mesh_placements",
           "contiguous_stride"]


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
