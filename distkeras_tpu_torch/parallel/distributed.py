"""Process-group bootstrap and async-island topology: counterpart of
``distkeras_tpu/parallel/distributed.py``.

The reference's control plane is ``jax.distributed``: every host runs the
same SPMD program and a coordinator address joins them. Here every rank is
a process that drives one device, joined by ``torch.distributed``:
:func:`initialize` on every rank (``torchrun`` sets the environment it
reads), then ``SynchronousDistributedTrainer`` trains data-parallel over
:func:`global_mesh`. NCCL carries the collectives on CUDA, gloo on the CPU.

:class:`IslandSpec` and :func:`local_island` carry the wiring of an async
island (a group of ranks that trains synchronously and speaks to a remote
parameter server over gRPC).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from distkeras_tpu_torch.parallel.mesh import Mesh, make_mesh
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = [
    "initialize",
    "global_mesh",
    "IslandSpec",
    "local_island",
    "process_count",
    "process_index",
]


def _env(*names: str) -> str | None:
    for name in names:
        if os.environ.get(name):
            return os.environ[name]
    return None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the process group (a no-op on a single process).

    The arguments default from the reference's variables
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``),
    then from ``torchrun``'s (``WORLD_SIZE``, ``RANK``, and with
    ``MASTER_ADDR`` and ``MASTER_PORT`` set, its rendezvous store through
    ``env://``). ``coordinator_address`` is ``host:port`` or a
    ``torch.distributed`` init URL (``tcp://...``, ``file://...``).
    ``backend`` defaults to NCCL, which needs a CUDA device (this raises
    without one); name ``"gloo"`` to run on the CPU. Under NCCL each rank
    takes the device ``LOCAL_RANK`` (else its rank modulo the device count).
    A backend that fails raises: there is no switch to another one."""
    coordinator_address = coordinator_address or _env("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and _env("MASTER_ADDR") and _env("MASTER_PORT"):
        # torchrun's agent may already serve a store on MASTER_PORT, which
        # env:// joins and a tcp:// URL would try to open a second time.
        coordinator_address = "env://"
    if num_processes is None and _env("JAX_NUM_PROCESSES", "WORLD_SIZE"):
        num_processes = int(_env("JAX_NUM_PROCESSES", "WORLD_SIZE"))
    if coordinator_address is None and num_processes is None:
        return  # single process
    if process_id is None and _env("JAX_PROCESS_ID", "RANK"):
        process_id = int(_env("JAX_PROCESS_ID", "RANK"))
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            f"initialize needs a coordinator address, the number of processes and this "
            f"process's id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if backend is None:
        resolve_device(None)  # NCCL needs a card: raise here without one
        backend = "nccl"
    if backend == "nccl":
        local = _env("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else int(process_id) % torch.cuda.device_count())
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    torch.distributed.init_process_group(backend, init_method=init_method,
                                         world_size=int(num_processes), rank=int(process_id))


def process_count() -> int:
    """Ranks in the default process group; 1 without one."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def global_mesh(axis_sizes: dict[str, int] | None = None) -> Mesh:
    """A mesh over every rank of the process group."""
    return make_mesh(axis_sizes, devices=list(range(process_count())))


@dataclasses.dataclass(frozen=True)
class IslandSpec:
    """One async island: a synchronous group of ranks that talks to a remote
    parameter server. ``island_id``/``num_islands`` index this island among
    its peers; ``ps_host``/``ps_port`` locate the gRPC PS; within the island,
    training is data-parallel over ``mesh_axes``."""

    island_id: int
    num_islands: int
    ps_host: str
    ps_port: int
    mesh_axes: tuple[tuple[str, int], ...] = ()

    def mesh(self) -> Mesh:
        return global_mesh(dict(self.mesh_axes) or None)

    def client(self, like=None):
        from distkeras_tpu_torch.parallel.ps_grpc import GrpcClient

        return GrpcClient(self.ps_host, self.ps_port, like=like)


def local_island(ps_host: str, ps_port: int, num_islands: int = 1) -> IslandSpec:
    """IslandSpec for this process, numbering islands by its rank (island 0
    conventionally co-hosts the PS)."""
    return IslandSpec(
        island_id=process_index() % num_islands,
        num_islands=num_islands,
        ps_host=ps_host,
        ps_port=ps_port,
    )
