"""Hierarchical wall-clock spans with Chrome-trace export, on the profiler's
timeline too.

Copy of the reference's ``distkeras_tpu/telemetry/spans.py`` (jax-free).
A span marks a region of the host's work: a training step's forward,
backward and optimizer step, the feed's copies, the PS exchange, the
rebase. It lands in two places, each only while it is on:

- the active :class:`Tracer`, on the ``perf_counter`` clock, exported as a
  Chrome trace of the host alone;
- ``torch.profiler``'s timeline, while the profiler records: the span opens
  a ``record_function`` range named :data:`RANGE_PREFIX` + its name, so it
  shares the profiler's clock with every device activity, and the kernels a
  span launched (on any thread, the autograd engine's included) can be put
  down to it by time.

- **Near-zero overhead when disabled.** ``span("name")`` with no active
  tracer and no recording profiler is one module-global read and one read
  of the profiler's flag (``torch.autograd.profiler._is_profiler_enabled``,
  looked up only once torch is imported: this module imports no torch) plus
  returning a shared no-op context manager: no allocation, no clock read,
  no ``record_function`` (which costs microseconds even with the profiler
  off), so hot paths keep their ``with span(...)`` lines unconditionally.
- **Correct nesting across threads and asyncio tasks.** Parent tracking
  uses a :class:`contextvars.ContextVar`; trace lanes (the Chrome-trace
  ``tid``) are keyed by the running task, or the thread when no loop runs.
- **Standard output.** :meth:`Tracer.chrome_trace` emits Chrome
  ``traceEvents`` JSON that Perfetto and chrome://tracing load; every
  ``B`` has a matching ``E`` on its lane.
"""

from __future__ import annotations

import contextvars
import json
import os
import sys
import threading
import time
from typing import Any

__all__ = [
    "RANGE_PREFIX",
    "Tracer",
    "span",
    "enable_tracing",
    "disable_tracing",
    "active_tracer",
]


class _NullSpan:
    """Shared do-nothing span: what ``span()`` returns while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

# What a span's profiler range is named: this prefix, then the span's name.
RANGE_PREFIX = "dk."


def _profiling() -> bool:
    """Whether ``torch.profiler`` records now; False while torch is not
    imported."""
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and profiler._is_profiler_enabled


def _open_range(name: str):
    """The entered ``record_function`` range of span ``name`` while the
    profiler records, else None."""
    if not _profiling():
        return None
    r = sys.modules["torch.autograd.profiler"].record_function(RANGE_PREFIX + name)
    r.__enter__()
    return r


# The active span in the CURRENT logical context (task- and thread-local).
_CURRENT: contextvars.ContextVar["_Span | None"] = contextvars.ContextVar(
    "distkeras_tpu_torch_current_span", default=None
)


def _lane_key():
    """Identity of the current swimlane: the running asyncio task when
    inside a loop, else the thread. Two tasks on one thread must not share
    a lane — their B/E events interleave and would break stack nesting."""
    try:
        import asyncio

        task = asyncio.current_task()
    except RuntimeError:  # no running event loop in this thread
        task = None
    if task is not None:
        return ("task", id(task), task.get_name())
    t = threading.current_thread()
    return ("thread", t.ident, t.name)


class _Span:
    """One span, recorded into ``tracer`` (when not None) and the profiler's
    range (when it records at ``__enter__``)."""

    __slots__ = ("_tracer", "name", "attrs", "_token", "_lane", "_t0",
                 "_recorded", "_range")

    def __init__(self, tracer: "Tracer | None", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._range = _open_range(self.name)
        if self._tracer is None:
            return self
        parent = _CURRENT.get()
        self._token = _CURRENT.set(self)
        self._lane = self._tracer._lane()
        self._t0 = time.perf_counter()
        # _record_b says whether the B event landed; when the tracer is
        # full this span is skipped wholesale (E suppressed too) so the
        # recorded stream keeps strict B/E matching per lane.
        self._recorded = self._tracer._record_b(
            self.name, self._t0, self._lane,
            parent.name if parent is not None else None, self.attrs,
        )
        return self

    def __exit__(self, *exc):
        if self._tracer is not None:
            if self._recorded:
                t1 = time.perf_counter()
                self._tracer._record_e(self.name, t1, self._lane)
            _CURRENT.reset(self._token)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Tracer:
    """Collects span events; export with :meth:`chrome_trace` /
    :meth:`export_chrome_trace`. Thread-safe (one lock around the event
    list and lane table); cheap enough for per-iteration spans, not for
    per-element inner loops.

    ``max_events`` bounds memory on long-lived traced processes (a
    serving engine records several events per decode iteration — an
    unbounded list would grow to GBs over a multi-day run, the exact
    failure mode ServingMetrics bounds its windows against). Once full,
    NEW spans are dropped whole (their E suppressed with them, so the
    recorded prefix keeps matched B/E per lane) and counted in
    :attr:`dropped_spans`; spans already open keep their closing E.
    """

    def __init__(self, max_events: int = 1_000_000):
        self._lock = threading.Lock()
        self._events: list[tuple] = []  # (ph, name, t, lane, parent, attrs)
        self._lane_ids: dict = {}
        self._lane_names: dict[int, str] = {}
        self._max_events = int(max_events)
        self.dropped_spans = 0

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **attrs: Any) -> _Span:
        return _Span(self, name, attrs)

    def _lane(self) -> int:
        key = _lane_key()
        with self._lock:
            lane = self._lane_ids.get(key)
            if lane is None:
                lane = len(self._lane_ids)
                self._lane_ids[key] = lane
                self._lane_names[lane] = f"{key[0]}:{key[2]}"
            return lane

    def _record_b(self, name, t, lane, parent, attrs) -> bool:
        with self._lock:
            # Reserve room for this span's own E (the +1): admitted spans
            # always get to close, the cap may be exceeded by the E events
            # of spans open at the moment it filled.
            if len(self._events) + 1 >= self._max_events:
                self.dropped_spans += 1
                return False
            self._events.append(("B", name, t, lane, parent, attrs))
            return True

    def _record_e(self, name, t, lane) -> None:
        with self._lock:
            self._events.append(("E", name, t, lane, None, None))

    # -- introspection / export ----------------------------------------------
    def events(self) -> list[tuple]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def chrome_trace(self) -> dict:
        """Chrome ``traceEvents`` JSON object (loadable in Perfetto and
        chrome://tracing). Timestamps are microseconds on the
        ``perf_counter`` clock; lanes become ``tid`` with a metadata name
        event each so task/thread names show on the swimlane."""
        pid = os.getpid()
        out = []
        with self._lock:
            events = list(self._events)
            lane_names = dict(self._lane_names)
            dropped = self.dropped_spans
        if dropped:
            out.append({
                "name": "dropped_spans", "ph": "M", "pid": pid, "tid": 0,
                "args": {"count": dropped},
            })
        for lane, lname in sorted(lane_names.items()):
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": lane,
                "args": {"name": lname},
            })
        for ph, name, t, lane, parent, attrs in events:
            ev = {"name": name, "ph": ph, "pid": pid, "tid": lane,
                  "ts": round(t * 1e6, 3)}
            if ph == "B":
                args = dict(attrs) if attrs else {}
                if parent is not None:
                    args["parent"] = parent
                if args:
                    ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# -- module-level switch ------------------------------------------------------

_ACTIVE: Tracer | None = None


def enable_tracing(tracer: Tracer | None = None) -> Tracer:
    """Install (and return) the process-wide tracer; subsequent
    ``span(...)`` calls record into it."""
    global _ACTIVE
    _ACTIVE = tracer if tracer is not None else Tracer()
    return _ACTIVE


def disable_tracing() -> None:
    """Back to no-op spans (already-recorded events stay on the tracer)."""
    global _ACTIVE
    _ACTIVE = None


def active_tracer() -> Tracer | None:
    return _ACTIVE


def span(name: str, **attrs: Any):
    """Context manager marking one timed region, parented to the
    enclosing span of the current task/thread, and a profiler range while
    the profiler records. A no-op singleton when neither is on — safe to
    leave on every hot path."""
    t = _ACTIVE
    if t is None:
        return _Span(None, name, attrs) if _profiling() else _NULL_SPAN
    return t.span(name, **attrs)
