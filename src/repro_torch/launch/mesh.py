"""The entity mesh: the P locales the property-graph stores shard over.

The paper's stores are distributable: their entity axis block-distributes
over P locales, giving O(NK/P) query cost.  ``EntityMesh`` names those P
locales as devices, shard ``i`` on ``devices[i]``.  The port is
single-controller, like the reference's ``shard_map`` over its device
mesh: one process holds every shard and launches each
shard's work on its device (``launch/collectives.py`` moves data between
them).

A device may repeat: ``make_entity_mesh(devices=["cuda:0"] * 8)`` is a
P = 8 mesh on one card, and ``devices=["cpu"] * 8`` one on the CPU — the
counterpart of the reference's ``--xla_force_host_platform_device_count=8``
virtual devices.  The same code then spans several cards when a machine
has them (``make_entity_mesh()``: every card).

``make_production_mesh`` gives the reference's production meshes, (16,
16) over (``"data"``, ``"model"``) and (2, 16, 16) over (``"pod"``,
``"data"``, ``"model"``), as an ``AbstractMesh``: axis names and sizes,
no devices.  The dry run's spec rules (``launch/sharding.py``) read them,
and ``fake_device_mesh`` makes one a ``torch.distributed`` ``DeviceMesh``
over a fake process group, on which the dry run traces a cell as one
rank's program (``launch/dryrun.py``; the counterpart of the reference's
512 placeholder devices).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

__all__ = ["EntityMesh", "AbstractMesh", "make_entity_mesh", "make_production_mesh",
           "fake_device_mesh", "mesh_axes", "dp_axes"]


@dataclasses.dataclass(frozen=True)
class EntityMesh:
    """A 1-D ``("data",)`` mesh of P devices (repeats allowed).  Frozen and
    hashable: the sharded step functions are cached on it."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("an entity mesh needs at least one device")
        if len({d.type for d in devs}) != 1 or devs[0].type not in ("cpu", "cuda"):
            raise ValueError(f"a mesh is all CUDA devices or all CPU, got {devs}")
        if devs[0].type == "cuda":  # 'cuda' alone names no card: pin the current one
            devs = tuple(torch.device("cuda", torch.cuda.current_device() if d.index is None
                                      else d.index) for d in devs)
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        """P, the shard count."""
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """``devices[0]``: where the graph's unsharded arrays live."""
        return self.devices[0]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axes by name and size, with no devices (the reference's
    ``AbstractMesh(axis_sizes, axis_names)``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"axis sizes {self.axis_sizes} and names {self.axis_names} differ "
                             "in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """One pod, 16 × 16 over ("data", "model"); two, 2 × 16 × 16 over
    ("pod", "data", "model")."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def fake_device_mesh(mesh: AbstractMesh, device_type: str = "cuda") -> Iterator:
    """``mesh`` as a ``torch.distributed`` ``DeviceMesh`` (same axis names
    and sizes, ``device_type`` "cuda" or "cpu") over a fake process group of
    ``mesh.size`` ranks, this process being rank 0.  The group exists
    inside the ``with`` only: a process holds one group at a time, so each
    worker process makes its own."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # torch registers its "fake" backend (a group whose collectives move no data) only in
    # this module, whose creator follows each torch's own process-group API
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield init_device_mesh(device_type, tuple(mesh.axis_sizes),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def make_entity_mesh(n_devices: Optional[int] = None, *,
                     devices: Optional[Sequence] = None) -> EntityMesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA card; ``n_devices`` default: all of them).  Raises when
    ``n_devices`` is outside ``[1, len(devices)]``, as the reference does —
    so with no card and no ``devices`` it always raises.  A sub-mesh
    (``n_devices`` below the count) is how a sweep varies P in one
    process."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    p = len(devices) if n_devices is None else int(n_devices)
    if not 1 <= p <= len(devices):
        raise ValueError(f"n_devices={p} not in [1, {len(devices)}]")
    return EntityMesh(tuple(devices[:p]))


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The pure-data-parallel axis group: ('pod', 'data') when multi-pod."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
