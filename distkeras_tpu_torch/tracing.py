"""Structured metric records with pluggable sinks.

The one class of the reference's ``distkeras_tpu/tracing.py`` that the
serving metrics need, copied: that module imports JAX for its step timer
and profiler, so the port keeps :class:`MetricStream` alone here.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable

from distkeras_tpu_torch.telemetry.registry import sanitize_metric_name

__all__ = ["MetricStream"]


class MetricStream:
    """Structured metric records: ``emit(step, {...})`` fans out to sinks.

    ``registry``: optional :class:`~distkeras_tpu_torch.telemetry.registry.
    MetricsRegistry`; every numeric metric emitted also sets a
    ``stream_<key>`` gauge (latest value) and bumps
    ``stream_records_total``, so a scrape of the registry shows the live
    tail of the step series without replaying the JSONL.

    Close when done: ``to_jsonl`` owns an open file handle. Use as a
    context manager, or call :meth:`close` — emitting after close raises.
    """

    def __init__(self, sinks: list[Callable[[dict], None]] | None = None,
                 registry=None):
        self.records: list[dict] = []
        self._sinks = sinks or []
        self._files: list[Any] = []  # handles owned by this stream
        self._closed = False
        self._registry = registry

    @classmethod
    def to_jsonl(cls, path: str, registry=None) -> "MetricStream":
        f = open(path, "a")

        def sink(rec: dict):
            f.write(json.dumps(rec) + "\n")
            f.flush()

        stream = cls([sink], registry=registry)
        stream._files.append(f)
        return stream

    def close(self) -> None:
        """Flush and close owned file handles; idempotent."""
        if self._closed:
            return
        self._closed = True
        for f in self._files:
            try:
                f.close()
            except OSError:
                pass
        self._files.clear()

    def __enter__(self) -> "MetricStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def emit(self, step: int, metrics: dict[str, Any]) -> None:
        if self._closed:
            raise ValueError("emit() on a closed MetricStream")
        rec = {"step": int(step), "ts": time.time(), **_floats(metrics)}
        self.records.append(rec)
        for sink in self._sinks:
            sink(rec)
        if self._registry is not None:
            self._registry.counter(
                "stream_records_total", help="MetricStream records emitted"
            ).inc()
            for k, v in rec.items():
                if k in ("step", "ts") or not isinstance(v, (int, float)):
                    continue
                self._registry.gauge(
                    "stream_" + sanitize_metric_name(k),
                    help="latest stream value").set(v)

    def last(self) -> dict | None:
        return self.records[-1] if self.records else None


def _floats(metrics: dict) -> dict:
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = v
    return out


