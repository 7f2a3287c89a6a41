"""Kernel launch counters that stay exact when several threads launch.

Each kernel wrapper keeps its count in its ``launches`` attribute, which
callers read and reset. ``wrapper.launches += 1`` is a read-modify-write,
so two worker threads launching at once could lose a count;
:func:`count_launch` makes the increment under one lock. A wrapper also
hands :func:`count_launch` the matrix-product flops of its kernel's plain
version, which :func:`kernel_flops` sums for
:func:`~distkeras_tpu_torch.tracing.compiled_step_flops` (the flop counter
of ``torch.utils.flop_counter`` does not see a ctypes or Triton launch).
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["count_launch", "kernel_flops"]

_LOCK = threading.Lock()
_TALLIES: list = []


class _Tally:
    def __init__(self):
        self.flops = 0.0


def count_launch(wrapper, flops: float = 0.0) -> None:
    """Add one to ``wrapper.launches``, atomically, and ``flops`` to every
    open :func:`kernel_flops` tally."""
    with _LOCK:
        wrapper.launches += 1
        for tally in _TALLIES:
            tally.flops += flops


@contextlib.contextmanager
def kernel_flops():
    """Sum the flops of the kernels launched while this is entered, by any
    thread (the autograd engine runs a CUDA backward on threads of its
    own): ``with kernel_flops() as t: ...; t.flops``."""
    tally = _Tally()
    with _LOCK:
        _TALLIES.append(tally)
    try:
        yield tally
    finally:
        with _LOCK:
            _TALLIES.remove(tally)
