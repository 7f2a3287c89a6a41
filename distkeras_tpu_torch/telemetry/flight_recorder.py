"""Flight recorder: a bounded black box of recent serving activity.

Copy of the reference's ``distkeras_tpu/telemetry/flight_recorder.py``, which imports no JAX;
only its imports differ.

A crashed replica's aggregate metrics die with it; its last seconds of
STATE — which requests were in flight, what the engine was doing, which
request blew its SLO — are exactly what the post-mortem needs. The
recorder keeps three fixed-size rings per process:

- **events** — engine/process state transitions (admit, shutdown, param
  swap, failure) as ``(wall_ts, kind, fields)`` tuples;
- **timelines** — the most recent finished per-request
  :class:`~distkeras_tpu_torch.telemetry.request_trace.TimelineRecord` dicts;
- **slow exemplars** — full timelines of requests that exceeded the
  latency SLO, kept in their own ring so a burst of ordinary traffic
  cannot wash the interesting ones out of the window.

Memory stance: every ring is a **preallocated fixed-length list with a
cursor** — recording overwrites the oldest entry in place and never
grows a container, so a recorder armed on a multi-day serving process
costs the same bytes on day 30 as at boot (the span tracer's
``max_events`` concern, solved by overwrite instead of drop: for a black
box the RECENT past is the valuable part).

Dumps: :meth:`dump` writes one JSON file (tmp + rename, so a reader
never sees a torn file); :meth:`crash_dump` is the best-effort
exception-path variant the engine calls when its loop dies — the
"last words" file the cluster supervisor collects off a dead replica and
references in its restart log. A SIGKILL'd process (the chaos test's
hard kill of a child REPLICA PROCESS) cannot write last words — that
limitation is fundamental; in-process crash paths (engine task failure
or cancellation, SIGTERM drain) all dump.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["FlightRecorder", "load_flight_dump"]


class _Ring:
    """Fixed-size overwrite ring: preallocated slots + cursor."""

    __slots__ = ("_slots", "_cursor", "count")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self._slots: list = [None] * int(capacity)
        self._cursor = 0
        self.count = 0  # total ever recorded (monotonic)

    def put(self, item) -> None:
        self._slots[self._cursor] = item
        self._cursor = (self._cursor + 1) % len(self._slots)
        self.count += 1

    def items(self) -> list:
        """Oldest-to-newest live entries."""
        n = len(self._slots)
        if self.count < n:
            return [s for s in self._slots[:self.count]]
        return (self._slots[self._cursor:] + self._slots[:self._cursor])


class FlightRecorder:
    """Bounded ring buffers of recent events + request timelines.

    ``capacity``: state-transition event ring size.
    ``timeline_capacity``: finished-request timeline ring size.
    ``slow_capacity``: SLO-violation exemplar ring size.
    ``dump_path``: where :meth:`dump`/:meth:`crash_dump` write when called
    with no explicit path — the replica's "last words" location the
    supervisor knows to look at.
    ``source``: process identity stamped into dumps (replica id, pid).
    ``wide_events``: optional
    :class:`~distkeras_tpu_torch.telemetry.wide_events.WideEventStore` whose
    ring TAIL rides along in every dump — the flat per-request facts of
    the last requests served before death, available even when no
    timeline store was armed (the engine attaches its store here).
    """

    def __init__(self, capacity: int = 256, *, timeline_capacity: int = 128,
                 slow_capacity: int = 32, dump_path: str | None = None,
                 source: str = "", wide_events=None,
                 wide_tail: int = 64):
        self._lock = threading.Lock()
        self._events = _Ring(capacity)
        self._timelines = _Ring(timeline_capacity)
        self._slow = _Ring(slow_capacity)
        self.dump_path = dump_path
        self.source = source or f"pid:{os.getpid()}"
        self.dumps_written = 0
        self.wide_events = wide_events
        self.wide_tail = int(wide_tail)

    # -- recording -----------------------------------------------------------
    def record_event(self, kind: str, **fields) -> None:
        """One state transition. Guard call sites with ``if recorder is
        not None`` — with no recorder the serving hot path must not even
        build the kwargs."""
        with self._lock:
            self._events.put((time.time(), kind, fields or None))

    def record_timeline(self, record: dict, slow: bool = False) -> None:
        """A finished request's timeline dict; ``slow=True`` (the caller's
        SLO verdict) ALSO pins it in the exemplar ring."""
        with self._lock:
            self._timelines.put(record)
            if slow:
                self._slow.put(record)

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "source": self.source,
                "events_recorded": self._events.count,
                "events_capacity": len(self._events._slots),
                "timelines_recorded": self._timelines.count,
                "timelines_capacity": len(self._timelines._slots),
                "slow_exemplars": self._slow.count,
                "dump_path": self.dump_path,
                "dumps_written": self.dumps_written,
            }

    def slow_exemplars(self) -> list[dict]:
        with self._lock:
            return list(self._slow.items())

    def dump_dict(self) -> dict:
        with self._lock:
            out = {
                "source": self.source,
                "dumped_at": time.time(),
                "events": [
                    {"ts": ts, "kind": kind,
                     **({"fields": fields} if fields else {})}
                    for ts, kind, fields in self._events.items()
                ],
                "timelines": list(self._timelines.items()),
                "slow_exemplars": list(self._slow.items()),
                "events_recorded": self._events.count,
                "timelines_recorded": self._timelines.count,
            }
        # Outside the recorder lock: the store has its own (and a
        # wedged store must not deadlock a crash dump against an
        # appending engine thread).
        if self.wide_events is not None:
            try:
                out["wide_events_tail"] = self.wide_events.tail(
                    self.wide_tail)
                out["wide_events_stats"] = self.wide_events.stats()
            except Exception:
                # Last-words writes are best-effort end to end.
                pass
        return out

    # -- dumping -------------------------------------------------------------
    def dump(self, path: str | None = None) -> str:
        """Write the black box as one JSON file (atomic tmp + rename);
        returns the path written."""
        path = path or self.dump_path
        if not path:
            raise ValueError("no dump path configured")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self.dump_dict(), f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.dumps_written += 1
        return path

    def crash_dump(self, error: str | None = None) -> str | None:
        """Best-effort last-words write on the failure path: records the
        terminal event, dumps to ``dump_path``, and SWALLOWS any write
        failure — a broken disk must not mask the original exception the
        engine is about to re-raise. None when no path is configured or
        the write failed."""
        if error is not None:
            self.record_event("crash", error=error)
        if not self.dump_path:
            return None
        try:
            return self.dump()
        except Exception:
            return None


def load_flight_dump(path: str) -> dict:
    """Read a dump file back (supervisor last-words collection, tests)."""
    with open(path) as f:
        return json.load(f)
