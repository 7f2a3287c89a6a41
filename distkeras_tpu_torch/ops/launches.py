"""Kernel launch counters that stay exact when several threads launch.

Each kernel wrapper keeps its count in its ``launches`` attribute, which
callers read and reset. ``wrapper.launches += 1`` is a read-modify-write,
so two worker threads launching at once could lose a count;
:func:`count_launch` makes the increment under one lock.
"""

from __future__ import annotations

import threading

__all__ = ["count_launch"]

_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, atomically."""
    with _LOCK:
        wrapper.launches += 1
