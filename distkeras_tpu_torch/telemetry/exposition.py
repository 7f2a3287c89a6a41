"""Render a :class:`MetricsRegistry` for scraping.

Copy of the reference's ``distkeras_tpu/telemetry/exposition.py``, which imports no JAX;
only its imports differ.

Two formats, zero dependencies:

- :func:`prometheus_text` — the Prometheus text exposition format
  (``# TYPE``/``# HELP`` headers, ``_bucket{le=...}``/``_sum``/``_count``
  histogram series). The serving server returns it for
  ``{"cmd": "metricsz", "format": "prometheus"}`` so a sidecar can bridge
  the JSONL protocol to a real scrape endpoint with ``nc`` and a cron;
- :func:`write_snapshot_jsonl` — one JSON line per dump, appended, for
  offline analysis next to the per-step metric streams.
"""

from __future__ import annotations

import json
import math
import time

from distkeras_tpu_torch.telemetry.registry import MetricsRegistry

__all__ = ["prometheus_text", "write_snapshot_jsonl"]


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


def prometheus_text(registry: MetricsRegistry) -> str:
    """The registry as a Prometheus scrape page (text format 0.0.4)."""
    lines: list[str] = []
    seen_headers: set[str] = set()
    for m in registry.collect():
        if m.name not in seen_headers:
            seen_headers.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind == "histogram":
            for bound, acc in m.cumulative_counts():
                lines.append(
                    f"{m.name}_bucket"
                    f"{_fmt_labels(m.labels, {'le': _fmt_value(bound)})}"
                    f" {acc}"
                )
            lines.append(f"{m.name}_sum{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.sum)}")
            lines.append(f"{m.name}_count{_fmt_labels(m.labels)} {m.count}")
        else:
            lines.append(f"{m.name}{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.value)}")
    return "\n".join(lines) + "\n"


def write_snapshot_jsonl(registry: MetricsRegistry, path: str) -> dict:
    """Append one timestamped snapshot line to ``path``; returns the
    snapshot written."""
    snap = {"ts": time.time(), "metrics": registry.snapshot()}
    with open(path, "a") as f:
        f.write(json.dumps(snap) + "\n")
    return snap
