"""Multi-device async islands: counterpart of the reference's
``devices_per_worker`` sub-mesh (``training/trainers.py:1002-1063``).

In the reference an island is one worker of an async trainer whose state
is replicated over a ``{"dp": n}`` sub-mesh of its own devices and whose
window batches are split over that mesh: XLA makes each step one
data-parallel step over the island, BatchNorm takes the island's whole
batch's moments, and the island speaks to the parameter server as one
participant.

Here each replica of an island is a thread of the worker's process driving
its own device (its own CUDA stream), and the replicas are joined by an
:class:`IslandGroup`, a process group in miniature: a barrier and a sum in
rank order, the same on every replica, so their states stay bitwise equal.
A replica's :class:`IslandMember` stands where a ``torch.distributed``
group stands elsewhere: :func:`~distkeras_tpu_torch.training.step.all_reduce_mean_`
averages the gradients and metrics over it, and BatchNorm
(:func:`~distkeras_tpu_torch.models.core.cross_replica_batch_stats`) sums
its moments through :func:`all_reduce_sum_grad` (an MoE layer routes the
island's whole batch through them too). On CUDA a replica waits
for the other replicas' streams through events before it reads what they
left, and marks their tensors as used by its own stream. The sum with a
gradient goes through host memory there: its backward blocks on the other
replicas, and autograd runs a CUDA node on the device's one worker thread,
which replicas that share a card share too.
"""

from __future__ import annotations

import threading

import torch

from distkeras_tpu_torch.telemetry.spans import span

__all__ = ["IslandGroup", "IslandMember", "all_reduce_sum_grad"]


class IslandGroup:
    """``size`` replicas, one thread each, that meet at a barrier. A
    replica that fails calls :meth:`abort`, which breaks the barrier for
    the others (``threading.BrokenBarrierError``) instead of leaving them
    waiting."""

    def __init__(self, size: int):
        self.size = int(size)
        self._barrier = threading.Barrier(self.size)
        self._slots: list = [None] * self.size

    def member(self, rank: int) -> "IslandMember":
        return IslandMember(self, rank)

    def abort(self) -> None:
        self._barrier.abort()

    def exchange(self, rank: int, value) -> list:
        """Every replica's ``value``, in rank order: each replica deposits
        its own and waits for the others, and all have read before any
        deposits again."""
        self._slots[rank] = value
        self._barrier.wait()
        values = list(self._slots)
        self._barrier.wait()
        return values


def _ready_event(t: torch.Tensor):
    """An event on ``t``'s device's current stream after the work queued so
    far (None on the CPU)."""
    if not t.is_cuda:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


def _adopt(t: torch.Tensor, event, device: torch.device) -> torch.Tensor:
    """Another replica's ``t`` made safe to read on this thread's streams
    and moved to ``device``."""
    if event is not None:
        stream = torch.cuda.current_stream(t.device)
        stream.wait_event(event)
        t.record_stream(stream)
    return t.to(device)


class IslandMember:
    """One replica's handle on its :class:`IslandGroup`: ``rank`` among
    ``size``."""

    def __init__(self, group: IslandGroup, rank: int):
        self.group, self.rank, self.size = group, int(rank), group.size

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every replica's ``x`` (one shape) stacked in rank order on this
        replica's device, ``[size, ...]``."""
        x = x.detach().contiguous()
        with span("island_all_gather"):
            values = self.group.exchange(self.rank, (x, _ready_event(x)))
            return torch.stack([_adopt(t, event, x.device) for t, event in values])

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every replica's ``x`` (one shape), added in rank order
        on this replica's device: the same bits on every replica."""
        x = x.detach().contiguous()
        with span("island_all_reduce"):
            values = self.group.exchange(self.rank, (x, _ready_event(x)))
            total = None
            for t, event in values:
                t = _adopt(t, event, x.device)
                total = t.clone() if total is None else total + t
        return total


class _SumGrad(torch.autograd.Function):
    """:meth:`IslandMember.sum`; backward, the replicas' cotangents summed
    (each replica's input reaches every replica's output)."""

    @staticmethod
    def forward(ctx, x, member):
        ctx.member = member
        return member.sum(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.member.sum(grad), None


def all_reduce_sum_grad(x: torch.Tensor, member: IslandMember) -> torch.Tensor:
    """The sum of every replica's ``x``, differentiable: the counterpart of
    ``torch.distributed.nn.functional.all_reduce`` over an island. A CUDA
    ``x`` is summed in host memory, so that the backward's wait for the
    other replicas runs on the calling thread (see the module's
    docstring)."""
    if not x.is_cuda:
        return _SumGrad.apply(x, member)
    return _SumGrad.apply(x.cpu(), member).to(x.device)
