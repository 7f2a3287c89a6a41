"""Counter/gauge/histogram metrics registry.

Copy of the reference's ``distkeras_tpu/telemetry/registry.py`` (jax-free),
cut to what the parameter server, its HA clients, the training-health
layer and the trainers publish into: :class:`Counter`, :class:`Gauge`,
:class:`Histogram` (with its bucket-interpolated percentile),
:class:`MetricsRegistry`, the one exact :func:`percentile` and
:func:`sanitize_metric_name`. The fleet merge and delta surface and the
exposition formats belong to the serving slices.

Conventions (Prometheus-shaped): metric names ``[a-zA-Z_:][a-zA-Z0-9_:]*``,
counters end in ``_total``; labels are a frozen kwargs dict at
get-or-create time, and the same (name, labels) pair always returns the
same metric object.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentile",
    "sanitize_metric_name",
    "DEFAULT_BUCKETS",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def sanitize_metric_name(key: str) -> str:
    """A history or stream key as a valid metric name (the rule ``_NAME_RE``
    enforces): other characters become ``_``, and a leading digit gets a
    ``_`` prefix."""
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in str(key))
    if not out or out[0].isdigit():
        out = "_" + out
    return out

# Cumulative upper bounds tuned for latencies from sub-millisecond decode
# ticks to multi-second cold compiles; +Inf is implicit.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def hist_state_percentile(state: dict, q: float) -> float:
    """Bucket-interpolated percentile over a histogram ``state()`` dict.
    Edge cases match :func:`percentile`: empty raises, a single sample is
    returned exactly (the sum of one sample IS the sample)."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    n = int(state["count"])
    if n == 0:
        raise ValueError("percentile of empty histogram")
    if n == 1:
        return float(state["sum"])
    counts = state["counts"]
    bounds = state["buckets"]
    lo_obs = float(state["min"]) if state.get("min") is not None else 0.0
    hi_obs = (float(state["max"]) if state.get("max") is not None
              else float(bounds[-1]))
    rank = (q / 100.0) * n
    acc = 0.0
    for i, c in enumerate(counts):
        if acc + c >= rank and c > 0:
            lo = bounds[i - 1] if i > 0 else lo_obs
            hi = bounds[i] if i < len(bounds) else hi_obs
            frac = (rank - acc) / c
            est = lo + (hi - lo) * frac
            return min(max(est, lo_obs), hi_obs)
        acc += c
    return hi_obs


def percentile(values: Iterable[float], q: float) -> float:
    """Linear-interpolated percentile of ``values`` (any sized iterable);
    ``q`` in [0, 100]. Raises ``ValueError`` on empty input; a single
    sample is returned exactly for every q. The ONE percentile definition
    serving metrics, step timers, and histograms all share."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic float counter (``inc`` only)."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    """Set/inc point-in-time value."""

    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram with percentile estimation.

    ``observe(v)`` is O(log buckets); memory is O(buckets) regardless of
    sample count — the unbounded-list failure mode of per-module metric
    lists cannot recur here. ``percentile(q)`` linearly interpolates
    within the bucket containing the q-th sample, clamped to the observed
    [min, max] so estimates never leave the data's range.
    """

    kind = "histogram"

    def __init__(self, name, help="", labels=None, buckets=None):
        super().__init__(name, help, labels)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.bucket_bounds = bs  # +Inf bucket is implicit (the overflow)
        self._counts = [0] * (len(bs) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # Per-bucket exemplar: (worst value, label) — the label is a
        # trace_id in serving use, so a p99 spike on the scrape page
        # links straight to that request's flight-recorder timeline.
        # Fixed-size (one slot per bucket) and updated only when a new
        # within-bucket maximum lands, so steady-state cost is a compare.
        self._exemplars: list[tuple[float, object] | None] = (
            [None] * (len(bs) + 1))

    def observe(self, v: float, exemplar=None) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bucket_bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if exemplar is not None:
                cur = self._exemplars[i]
                if cur is None or v > cur[0]:
                    self._exemplars[i] = (v, exemplar)

    def exemplars(self) -> dict[str, dict]:
        """Worst-sample exemplar per occupied bucket, keyed by the
        bucket's ``le`` upper bound (``"+Inf"`` for the overflow)."""
        with self._lock:
            pairs = list(self._exemplars)
        out = {}
        for i, pair in enumerate(pairs):
            if pair is None:
                continue
            bound = (self.bucket_bounds[i]
                     if i < len(self.bucket_bounds) else math.inf)
            key = "+Inf" if bound == math.inf else repr(bound)
            out[key] = {"value": pair[0], "trace_id": pair[1]}
        return out

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float | None:
        return self._sum / self._count if self._count else None

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile estimate; agrees with the exact
        :func:`percentile` on the edge cases (empty raises, one sample is
        returned exactly)."""
        return hist_state_percentile(self.state(exemplars=False), q)

    def state(self, exemplars: bool = True) -> dict:
        """JSON-able snapshot: per-bucket counts (NON-cumulative),
        count/sum/min/max, bucket layout, and (optionally) the per-bucket
        worst-sample exemplars."""
        with self._lock:
            out = {
                "buckets": list(self.bucket_bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "min": (self._min if self._count else None),
                "max": (self._max if self._count else None),
            }
            if exemplars and any(e is not None for e in self._exemplars):
                out["exemplars"] = [
                    None if e is None else [e[0], e[1]]
                    for e in self._exemplars]
        return out


class MetricsRegistry:
    """Get-or-create home for metrics, keyed by (name, labels).

    Asking twice for the same (name, labels) returns the same object;
    asking with a different metric kind for an existing name raises —
    publisher modules can therefore declare their metrics at call sites
    without coordinating ownership.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, _Metric] = {}
        self._created = time.time()

    def _get_or_create(self, cls, name, help, labels, **kw):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}"
                    )
                return m
            m = cls(name, help=help, labels=labels, **kw)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", buckets=None,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def collect(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """JSON-able point-in-time dump (the ``metricsz`` JSON body)."""
        out: dict = {}
        for m in self.collect():
            key = m.name
            if m.labels:
                key += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(m.labels.items())) + "}"
            if m.kind == "histogram":
                entry: dict = {"kind": m.kind, "count": m.count,
                               "sum": round(m.sum, 9)}
                if m.count:
                    entry.update({
                        "p50": m.percentile(50), "p90": m.percentile(90),
                        "p99": m.percentile(99), "mean": m.mean,
                    })
                    ex = m.exemplars()
                    if ex:
                        entry["exemplars"] = ex
                out[key] = entry
            else:
                out[key] = {"kind": m.kind, "value": m.value}
        return out
