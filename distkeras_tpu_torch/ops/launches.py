"""Counters on functions that stay exact when several threads count.

A counted function keeps each count in an attribute of its own, which
callers read and reset: a kernel wrapper its ``launches``, the gradient
all-reduce its ``bytes`` and ``calls``. ``wrapper.launches += 1`` is a
read-modify-write, so two worker threads counting at once could lose a
count; :func:`count` makes the increments under one lock, and
:func:`count_launch` is its call for a kernel launch. A wrapper also
hands :func:`count_launch` the matrix-product flops of its kernel's plain
version, which :func:`kernel_flops` sums for
:func:`~distkeras_tpu_torch.tracing.compiled_step_flops` (the flop counter
of ``torch.utils.flop_counter`` does not see a ctypes or Triton launch).
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["count", "count_launch", "kernel_flops"]

_LOCK = threading.Lock()
_TALLIES: list = []


class _Tally:
    def __init__(self):
        self.flops = 0.0


def count(holder, flops: float = 0.0, **increments) -> None:
    """Add each of ``increments`` to the attribute of ``holder`` it names
    (``count(f, bytes=n, calls=1)``), all under one lock, and ``flops`` to
    every open :func:`kernel_flops` tally."""
    with _LOCK:
        for name, n in increments.items():
            setattr(holder, name, getattr(holder, name) + n)
        for tally in _TALLIES:
            tally.flops += flops


def count_launch(wrapper, flops: float = 0.0) -> None:
    """Add one to ``wrapper.launches`` and ``flops`` to every open
    :func:`kernel_flops` tally."""
    count(wrapper, flops, launches=1)


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
