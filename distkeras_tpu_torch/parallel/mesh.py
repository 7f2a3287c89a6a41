"""Device meshes: counterpart of ``distkeras_tpu/parallel/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` over the devices of one SPMD
program. Here one process drives one device, so a mesh is laid over the
**ranks** of a ``torch.distributed`` process group: :class:`Mesh` holds the
named axes and the array of ranks, and builds the
``torch.distributed.device_mesh.DeviceMesh`` over them when a process group
needs it (:attr:`Mesh.device_mesh`, :meth:`Mesh.group`). The shape logic (the
axis order, folding the remainder into ``dp``, every error) never touches a
process group, so it runs, and is tested, without one.

Axes, as in the reference:

- ``dp``   data parallel (batch split; gradient all-reduce)
- ``fsdp`` fully-sharded data parallel (params sharded over the data axis)
- ``tp``   tensor parallel
- ``sp``   sequence/context parallel
- ``pp``   pipeline stages
- ``ep``   experts

A sharding is a :class:`NamedSharding`: the mesh and a partition spec, a
tuple with one entry per tensor dimension (``None``, an axis name or a tuple
of axis names, as ``jax.sharding.PartitionSpec`` holds them), whose
:attr:`~NamedSharding.placements` are the DTensor placements (``Shard(d)``
or ``Replicate()``, one per mesh axis).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from collections.abc import Sequence

import numpy as np
import torch

__all__ = [
    "AXES",
    "Mesh",
    "NamedSharding",
    "make_mesh",
    "best_mesh",
    "data_parallel_shardings",
    "parse_mesh_shape",
    "pp_stages",
    "serving_mesh",
    "shard_batch_spec",
    "stage_submesh",
]

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


def _world_ranks() -> list[int]:
    """The ranks of the default process group; ``[0]`` without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


class Mesh:
    """Named axes over process ranks: ``devices`` is the array of ranks in
    the mesh's shape, ``axis_names`` one name per dimension. ``shape`` maps
    each axis to its size, in axis order, as ``jax.sharding.Mesh.shape``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} given "
                             f"{len(self.axis_names)} axis names {self.axis_names}")
        self._joint_groups: dict[tuple[str, ...], object] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @functools.cached_property
    def device_mesh(self):
        """The ``DeviceMesh`` over these ranks (device type ``cuda`` under
        NCCL, else ``cpu``). Every rank of the process group must build it:
        building one creates a process group per axis."""
        from torch.distributed.device_mesh import DeviceMesh

        backend = torch.distributed.get_backend()
        return DeviceMesh("cuda" if backend == "nccl" else "cpu",
                          torch.as_tensor(self.devices), mesh_dim_names=self.axis_names)

    def coords(self, rank: int) -> dict[str, int]:
        """``rank``'s index along each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh's ranks {self.devices.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group(self, axis):
        """The process group of ``axis`` (a name, or a tuple of names for
        the ranks that differ along those axes alone, major first): None
        without a process group (one rank, no collective to make), the
        default group when the axes hold every rank, else this rank's group
        of the ``DeviceMesh`` along one axis, or of the groups made once
        (by every rank) for several. A rank's place in the group orders
        what it holds of a sharded dimension (its rows of a batch)."""
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()):
            return None
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if math.prod(self.shape[a] for a in axes) == self.size == dist.get_world_size():
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._joint_group(axes)

    def _joint_group(self, axes: tuple[str, ...]):
        # One group per setting of the other axes, made once, in the same
        # order on every rank, as new_group requires; this rank keeps its own.
        if axes in self._joint_groups:
            return self._joint_groups[axes]
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        blocks = self.devices.transpose(rest + order).reshape(-1, math.prod(
            self.devices.shape[i] for i in order))
        mine = None
        for ranks in blocks.tolist():
            group = torch.distributed.new_group(ranks)
            if torch.distributed.get_rank() in ranks:
                mine = group
        self._joint_groups[axes] = mine
        return mine


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec (``()`` replicates)."""

    mesh: Mesh
    spec: tuple = ()

    @property
    def placements(self) -> list:
        """One DTensor placement per mesh axis: ``Shard(d)`` where tensor
        dimension ``d`` is split over the axis, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(self.mesh.axis_names)
        for dim, entry in enumerate(self.spec):
            for axis in _spec_axes(entry):
                out[self.mesh.axis_names.index(axis)] = Shard(dim)
        return out

    def index(self, shape: Sequence[int], rank: int) -> tuple[slice, ...]:
        """The part of a tensor of ``shape`` that ``rank`` holds, one slice
        per dimension (jax's ``devices_indices_map``): a dimension split
        over several axes is split over the first one first. Raises
        ``ValueError`` when a split dimension does not divide."""
        coord = self.mesh.coords(rank)
        out = []
        for dim, size in enumerate(shape):
            axes = _spec_axes(self.spec[dim] if dim < len(self.spec) else None)
            n = math.prod(self.mesh.shape[a] for a in axes)
            if size % n:
                raise ValueError(f"dimension {dim} of size {size} does not divide over "
                                 f"{'x'.join(axes)}={n}")
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + coord[a]
            out.append(slice(i * (size // n), (i + 1) * (size // n)))
        return tuple(out)

    @property
    def is_replicated(self) -> bool:
        return not any(_spec_axes(entry) for entry in self.spec)


def _spec_axes(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _axis_order(sizes: dict[str, int]) -> list[str]:
    return [a for a in AXES if a in sizes] + [a for a in sizes if a not in AXES]


def make_mesh(
    axis_sizes: dict[str, int] | None = None,
    devices: Sequence[int] | None = None,
) -> Mesh:
    """Build a mesh with the given named axis sizes over ``devices`` (ranks;
    default: every rank of the process group). Unnamed remainder ranks fold
    into ``dp``. Example: ``make_mesh({"dp": 2, "tp": 4})`` on 8 ranks."""
    devices = list(devices if devices is not None else _world_ranks())
    n = len(devices)
    sizes = dict(axis_sizes or {})
    specified = math.prod(sizes.values()) if sizes else 1
    if n % specified != 0:
        raise ValueError(f"{n} devices not divisible by axis product {specified}")
    if "dp" not in sizes:
        sizes = {"dp": n // specified, **sizes}
    names = _axis_order(sizes)
    shape = [sizes[a] for a in names]
    if math.prod(shape) != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} != {n} devices")
    return Mesh(np.array(devices).reshape(shape), names)


def best_mesh(num_devices: int | None = None) -> Mesh:
    """Default mesh: pure data-parallel over the process group's ranks (the
    first ``num_devices`` of them)."""
    devices = _world_ranks()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices but only {len(devices)} "
                f"are attached; reduce num_workers or run on more chips"
            )
        devices = devices[:num_devices]
    return make_mesh({"dp": len(devices)}, devices=devices)


def parse_mesh_shape(spec: str) -> dict[str, int]:
    """Parse a CLI mesh-shape spec: ``"tp=2"``, ``"tp=2,dp=1"``, or a bare
    integer ``"4"`` (shorthand for ``tp=4``). Raises ``ValueError`` on junk."""
    spec = (spec or "").strip()
    if not spec:
        raise ValueError("empty mesh shape; expected e.g. 'tp=2'")
    if spec.isdigit():
        return {"tp": int(spec)}
    shape: dict[str, int] = {}
    for part in spec.split(","):
        name, sep, size = part.partition("=")
        name = name.strip()
        if not sep or not name or not size.strip().isdigit():
            raise ValueError(
                f"bad mesh shape {spec!r}: each comma-separated entry "
                f"must be AXIS=N (e.g. 'tp=2'), got {part!r}")
        if name in shape:
            raise ValueError(f"bad mesh shape {spec!r}: axis {name!r} "
                             f"given twice")
        shape[name] = int(size.strip())
    for name, size in shape.items():
        if size < 1:
            raise ValueError(
                f"bad mesh shape {spec!r}: axis {name}={size} must be "
                f">= 1")
    return shape


def serving_mesh(
    shape: dict[str, int] | None = None,
    devices: Sequence[int] | None = None,
) -> Mesh:
    """Mesh for ONE sharded serving replica. ``shape`` defaults to
    ``{"tp": <all ranks>}``; an explicit shape must divide the rank count,
    and exactly the shape's product of ranks is used (the first ones): a
    serving mesh never folds leftover ranks into a hidden axis."""
    devices = list(devices if devices is not None else _world_ranks())
    n = len(devices)
    if n < 1:
        raise ValueError("no visible devices to build a serving mesh on")
    sizes = dict(shape) if shape else {"tp": n}
    if "tp" not in sizes:
        raise ValueError(
            f"serving mesh shape {sizes} has no 'tp' axis; tensor "
            f"parallelism is what a sharded serving replica shards over")
    extra = {a: s for a, s in sizes.items()
             if a not in ("tp", "pp") and s > 1}
    if extra:
        raise ValueError(
            f"serving mesh has non-trivial non-tp/pp axes {extra}: data "
            f"parallelism in serving is N replicas (run.py cluster "
            f"--replicas), not a dp mesh axis inside one engine")
    need = math.prod(sizes.values())
    if need > n or n % need != 0:
        raise ValueError(
            f"mesh shape {sizes} needs {need} devices but {n} are "
            f"visible ({need} must divide {n}); adjust --mesh-shape or "
            f"force more host devices")
    names = _axis_order(sizes)
    return Mesh(np.array(devices[:need]).reshape([sizes[a] for a in names]), names)


def pp_stages(mesh: Mesh | None) -> int:
    """Pipeline-stage count of a serving mesh (1 when unsharded or no
    ``pp`` axis)."""
    if mesh is None or "pp" not in mesh.axis_names:
        return 1
    return mesh.shape["pp"]


def stage_submesh(mesh: Mesh, stage: int) -> Mesh:
    """The tp-only sub-mesh of pipeline stage ``stage``: the ranks at
    pp-index ``stage``. Stage 0 on a ``tp=2,pp=2`` mesh is ``devices[:, 0]``."""
    if "pp" not in mesh.axis_names:
        if stage != 0:
            raise ValueError(f"mesh has no pp axis but stage {stage} "
                             f"requested")
        return mesh
    pp_index = mesh.axis_names.index("pp")
    n_stages = mesh.devices.shape[pp_index]
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} out of range for pp={n_stages}")
    col = np.take(mesh.devices, stage, axis=pp_index)
    return Mesh(col.reshape(-1), ("tp",))


def shard_batch_spec(mesh: Mesh) -> tuple:
    """Batch dimension sharded over every data-like axis present."""
    batch_axes = tuple(a for a in ("dp", "fsdp") if a in mesh.axis_names)
    if not batch_axes:
        return ()
    return (batch_axes if len(batch_axes) > 1 else batch_axes[0],)


def data_parallel_shardings(mesh: Mesh) -> tuple[NamedSharding, NamedSharding]:
    """(batch_sharding, replicated_sharding) for classic DP training."""
    return NamedSharding(mesh, shard_batch_spec(mesh)), NamedSharding(mesh, ())
