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

The sequence-parallel collectives (the reference's ``lax.ppermute`` and
``lax.all_to_all`` over a mesh axis) work on an :class:`AxisRing`, one mesh
axis seen from this rank (:func:`axis_ring`): :func:`sp_permute` moves
tensors one hop along the ring with ``batch_isend_irecv`` (a send to the
next rank, a receive from the previous one), :func:`sp_all_to_all`
exchanges the chunks of a tensor's leading dimension with
``all_to_all_single``, and :func:`sp_permute_grad` and
:func:`sp_all_to_all_grad` are their autograd-aware twins. At an axis of
size 1 each is the identity and communicates nothing. Under gloo a CUDA
tensor's P2P traffic is staged through host memory inside
:func:`sp_permute` (gloo sends from host memory); NCCL never stages.
:func:`sp_all_gather_grad` gathers tensors' sequence columns over the
ring (the reference's XLA sequence split, where GSPMD gathers what
attention needs): its forward concatenates the ranks' columns in ring
order, its backward sums the ranks' cotangents and hands each rank back
its own columns (a reduce-scatter). Their spans are ``sp_permute`` (its
``staged`` attribute says whether the bytes went through the host),
``sp_all_to_all`` and ``sp_all_gather`` (``staged`` likewise; gather and
reduce-scatter under gloo go through host memory for a CUDA tensor).

A pipeline's neighbour traffic (the reference's per-tick ``ppermute`` over
``pp``) is :func:`pp_exchange`: one tick's sends to the next and previous
ranks of the pp ring and receives from them, in one ``batch_isend_irecv``
of the same P2P (staged through the host likewise), under the span
``pp_p2p`` (attributes ``staged`` and ``bytes``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from distkeras_tpu_torch.parallel.mesh import Mesh, make_mesh
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = [
    "AxisRing",
    "axis_ring",
    "sp_all_gather",
    "sp_all_gather_grad",
    "sp_all_to_all",
    "sp_all_to_all_grad",
    "sp_permute",
    "sp_permute_grad",
    "sp_permute_start",
    "pp_exchange",
    "pp_join",
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


@dataclasses.dataclass(frozen=True)
class AxisRing:
    """One mesh axis seen from this rank: ``size`` ranks along it, this
    rank at ``index``, ``next`` and ``prev`` the global ranks at ``index + 1``
    and ``index - 1`` (mod ``size``), ``group`` the axis's process group
    (None at size 1, where nothing is communicated)."""

    size: int
    index: int = 0
    next: int = 0
    prev: int = 0
    group: object = None


def axis_ring(mesh: Mesh, axis: str) -> AxisRing:
    """This rank's :class:`AxisRing` along ``mesh``'s ``axis``. An axis above
    1 needs a process group over the mesh's ranks (``RuntimeError``
    otherwise); every rank of the mesh must ask for it together the first
    time, as :meth:`Mesh.group` builds the groups."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    n = mesh.shape[axis]
    if n == 1:
        return AxisRing(1)
    group = mesh.group(axis)
    if group is None:
        raise RuntimeError(f"a mesh with {axis}={n} needs a process group over its ranks "
                           f"(distkeras_tpu_torch.parallel.distributed.initialize)")
    where = list(np.argwhere(mesh.devices == process_index())[0])
    dim = mesh.axis_names.index(axis)
    i = int(where[dim])

    def at(j):
        where[dim] = j % n
        return int(mesh.devices[tuple(where)])

    return AxisRing(n, i, at(i + 1), at(i - 1), group)


def _pack(tensors) -> tuple[torch.Tensor, list]:
    """The tensors' bytes in one flat uint8 buffer, and how to cut it."""
    layout = [(t.shape, t.dtype, t.numel() * t.element_size()) for t in tensors]
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    return flat, layout


def _unpack(flat: torch.Tensor, layout) -> list[torch.Tensor]:
    parts = flat.split([nbytes for _, _, nbytes in layout])
    return [part.view(dtype).reshape(shape) for part, (shape, dtype, _) in zip(parts, layout)]


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and torch.distributed.get_backend(group) == "gloo"


class _Rotation:
    """A :func:`sp_permute_start` in flight; :meth:`wait` returns the
    tensors received."""

    def __init__(self, tensors=None, works=(), send=None, recv=None, layout=None, device=None):
        self._done, self._works = tensors, works
        self._send, self._recv, self._layout, self._device = send, recv, layout, device

    def wait(self) -> list[torch.Tensor]:
        if self._done is None:
            with span("sp_permute"):
                for work in self._works:
                    work.wait()
                recv = self._recv.to(self._device)  # a no-op unless staged
                self._done = _unpack(recv, self._layout)
                self._send = self._recv = None
        return self._done


def sp_permute_start(tensors, ring: AxisRing, reverse: bool = False) -> _Rotation:
    """Start moving ``tensors`` one hop along ``ring``: each rank sends to
    ``ring.next`` and receives from ``ring.prev`` (``reverse``: the other
    way), the reference's ``ppermute`` with ``perm = [(i, (i + 1) % p)]``.
    The tensors travel as one buffer of their bytes. Returns a handle whose
    ``wait()`` gives the received tensors, in order; the caller may queue
    device work in between."""
    tensors = list(tensors)
    if ring.size == 1:
        return _Rotation(tensors)
    dist = torch.distributed
    flat, layout = _pack(tensors)
    staged = _staged(flat, ring.group)
    with span("sp_permute", staged=staged):
        send = flat.cpu() if staged else flat
        recv = torch.empty_like(send)
        to, frm = (ring.prev, ring.next) if reverse else (ring.next, ring.prev)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, ring.group),
                                        dist.P2POp(dist.irecv, recv, frm, ring.group)])
    return _Rotation(None, works, send, recv, layout, flat.device)


def sp_permute(tensors, ring: AxisRing, reverse: bool = False) -> list[torch.Tensor]:
    """:func:`sp_permute_start` and wait: the tensors of the previous rank
    along ``ring`` (of the next one with ``reverse``)."""
    return sp_permute_start(tensors, ring, reverse).wait()


_JOINED: set = set()


def pp_join(ring: AxisRing, device) -> None:
    """Before a pipeline's first hop over ``ring``: one collective that
    every rank of the ring's group takes part in (a one-element
    ``all_reduce`` on ``device``), once a process and group (by the
    group's unique name). NCCL requires a group's first
    ``batch_isend_irecv`` to involve all its ranks, and a pipeline tick
    posts hops between neighbours only."""
    if ring.size == 1 or ring.group.group_name in _JOINED:
        return
    key = ring.group.group_name
    with span("pp_join"):
        torch.distributed.all_reduce(torch.zeros(1, device=device), group=ring.group)
    _JOINED.add(key)


def pp_exchange(ring: AxisRing, to_next=None, to_prev=None, from_prev=None, from_next=None):
    """One tick of a pipeline's neighbour traffic along ``ring``: send
    ``to_next`` to ``ring.next`` and ``to_prev`` to ``ring.prev``; receive
    from ``ring.prev`` a tensor shaped like ``from_prev`` (a template: its
    shape, dtype and device) and from ``ring.next`` one like ``from_next``.
    A None posts nothing. The operations go out in one
    ``batch_isend_irecv`` (sends to next then prev, receives from prev then
    next, so that at a ring of 2, where next and prev are one rank, the two
    messages a pair exchanges match in order) and are waited for. Both ranks
    of a hop must post it in the same call, in the same order of calls as
    every other hop between them. Returns ``(from_prev, from_next)``, the
    received tensors (None where nothing was asked). At a ring of 1 a rank's
    sends are its receives."""
    if ring.size == 1:
        return (to_next if from_prev is not None else None,
                to_prev if from_next is not None else None)
    if to_next is None and to_prev is None and from_prev is None and from_next is None:
        return None, None
    dist = torch.distributed
    sends = [(peer, t.contiguous()) for peer, t in ((ring.next, to_next), (ring.prev, to_prev))
             if t is not None]
    wanted = [(peer, like) for peer, like in ((ring.prev, from_prev), (ring.next, from_next))]
    first = sends[0][1] if sends else next(like for _, like in wanted if like is not None)
    staged = _staged(first, ring.group)
    nbytes = sum(t.numel() * t.element_size() for _, t in sends) + sum(
        like.numel() * like.element_size() for _, like in wanted if like is not None)
    with span("pp_p2p", staged=staged, bytes=nbytes):
        ops = [dist.P2POp(dist.isend, t.cpu() if staged else t, peer, ring.group)
               for peer, t in sends]
        bufs = []
        for peer, like in wanted:
            buf = None
            if like is not None:
                buf = torch.empty(like.shape, dtype=like.dtype,
                                  device="cpu" if staged else like.device)
                ops.append(dist.P2POp(dist.irecv, buf, peer, ring.group))
            bufs.append(buf)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(None if buf is None else buf.to(like.device)
                     for buf, (_, like) in zip(bufs, wanted))


def sp_all_to_all(x: torch.Tensor, ring: AxisRing) -> torch.Tensor:
    """``x`` (leading dimension ``ring.size``) with chunk ``j`` sent to the
    ``j``-th rank of the ring and chunk ``j`` of the result received from
    it: ``all_to_all_single`` over the ring's group."""
    if ring.size == 1:
        return x
    if x.shape[0] != ring.size:
        raise ValueError(f"sp_all_to_all takes a leading dimension of {ring.size}, "
                         f"got {tuple(x.shape)}")
    with span("sp_all_to_all"):
        x = x.contiguous()
        out = torch.empty_like(x)
        torch.distributed.all_to_all_single(out, x, group=ring.group)
    return out


class _Permute(torch.autograd.Function):
    """:func:`sp_permute`; backward, the cotangents one hop the other way."""

    @staticmethod
    def forward(ctx, ring, reverse, *tensors):
        ctx.ring, ctx.reverse = ring, reverse
        return tuple(sp_permute(tensors, ring, reverse))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *sp_permute(grads, ctx.ring, not ctx.reverse))


class _AllToAll(torch.autograd.Function):
    """:func:`sp_all_to_all`; it is its own adjoint, so the backward is the
    same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, ring, x):
        ctx.ring = ring
        return sp_all_to_all(x, ring)

    @staticmethod
    def backward(ctx, grad):
        return None, sp_all_to_all(grad, ctx.ring)


def sp_all_gather(tensors, ring: AxisRing, dim: int = 1) -> list[torch.Tensor]:
    """Each of ``tensors`` (this rank's columns along ``dim``, the same
    shape on every rank) with the ring's ranks' columns concatenated along
    ``dim`` in ring order: one ``all_gather_into_tensor`` of their bytes
    over the ring's group."""
    tensors = list(tensors)
    if ring.size == 1:
        return tensors
    flat, layout = _pack(tensors)
    staged = _staged(flat, ring.group)
    with span("sp_all_gather", staged=staged):
        send = flat.cpu() if staged else flat
        whole = torch.empty(ring.size * send.numel(), dtype=send.dtype, device=send.device)
        torch.distributed.all_gather_into_tensor(whole, send, group=ring.group)
        whole = whole.to(flat.device).view(ring.size, -1)
    parts = [_unpack(row, layout) for row in whole]
    return [torch.cat([p[i] for p in parts], dim=dim) for i in range(len(tensors))]


def _reduce_scatter_columns(grads, ring: AxisRing, dim: int) -> list[torch.Tensor]:
    """The sum over the ring's ranks of each whole cotangent in ``grads``,
    cut to this rank's columns along ``dim``: one ``reduce_scatter_tensor``
    of rank-major chunks."""
    chunks = [g.contiguous().chunk(ring.size, dim) for g in grads]
    flat = torch.cat([torch.cat([c[r].contiguous().reshape(-1) for c in chunks])
                      for r in range(ring.size)])
    staged = _staged(flat, ring.group)
    with span("sp_all_gather", staged=staged, backward=True):
        send = flat.cpu() if staged else flat
        mine = torch.empty(send.numel() // ring.size, dtype=send.dtype, device=send.device)
        torch.distributed.reduce_scatter_tensor(mine, send, group=ring.group)
        mine = mine.to(flat.device)
    shapes = [c[0].shape for c in chunks]
    return [part.view(shape) for part, shape in
            zip(mine.split([math.prod(sh) for sh in shapes]), shapes)]


class _AllGather(torch.autograd.Function):
    """:func:`sp_all_gather`; backward, the ranks' cotangents summed and
    each rank's columns handed back to it."""

    @staticmethod
    def forward(ctx, ring, dim, *tensors):
        ctx.ring, ctx.dim = ring, dim
        ctx.dtypes = [t.dtype for t in tensors]
        return tuple(sp_all_gather(tensors, ring, dim))

    @staticmethod
    def backward(ctx, *grads):
        by_dtype: dict[torch.dtype, list[int]] = {}
        for i, dt in enumerate(ctx.dtypes):
            by_dtype.setdefault(dt, []).append(i)
        out = [None] * len(grads)
        for idx in by_dtype.values():
            for i, g in zip(idx, _reduce_scatter_columns([grads[i] for i in idx], ctx.ring,
                                                         ctx.dim)):
                out[i] = g
        return (None, None, *out)


def sp_all_gather_grad(tensors, ring: AxisRing, dim: int = 1) -> list[torch.Tensor]:
    """:func:`sp_all_gather`, differentiable in each tensor."""
    if ring.size == 1:
        return list(tensors)
    return list(_AllGather.apply(ring, dim, *tensors))


def sp_permute_grad(tensors, ring: AxisRing) -> list[torch.Tensor]:
    """:func:`sp_permute`, differentiable in each tensor."""
    if ring.size == 1:
        return list(tensors)
    return list(_Permute.apply(ring, False, *tensors))


def sp_all_to_all_grad(x: torch.Tensor, ring: AxisRing) -> torch.Tensor:
    """:func:`sp_all_to_all`, differentiable in ``x``."""
    return x if ring.size == 1 else _AllToAll.apply(ring, x)
