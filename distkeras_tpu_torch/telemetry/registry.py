"""Counter/gauge/histogram metrics registry.

Copy of the reference's ``distkeras_tpu/telemetry/registry.py``, which
imports no JAX.

The single sink the whole system publishes into — serving
(:class:`~distkeras_tpu_torch.serving.metrics.ServingMetrics`, the scheduler),
trainers, the PS/HA layer, and the recompile auditor — replacing the
ad-hoc per-module lists each of those grew separately. One registry is a
point-in-time queryable surface: :func:`~distkeras_tpu_torch.telemetry.
exposition.prometheus_text` renders it as a Prometheus scrape page,
``snapshot()`` as a JSON object for the serving server's ``metricsz``
control verb.

Conventions (Prometheus-shaped, dependency-free):

- metric names ``[a-zA-Z_:][a-zA-Z0-9_:]*``; counters end in ``_total``,
  durations are ``_seconds``;
- labels are a frozen kwargs dict at get-or-create time; the same
  (name, labels) pair always returns the same metric object;
- histograms use fixed cumulative buckets (defaults tuned for
  sub-second latencies) with linear-interpolated percentile estimation.

Percentile semantics are defined ONCE here — :func:`percentile` (exact,
over any sized sequence) and :meth:`Histogram.percentile` (bucket
estimate) agree on the edge cases: empty input raises ``ValueError``,
a single sample is returned exactly for every q.
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
    "log_buckets",
    "hist_state_delta",
    "hist_state_percentile",
    "merge_hist_states",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def sanitize_metric_name(key: str) -> str:
    """Coerce an arbitrary metric key (a stream/history dict key) into a
    valid registry metric name — the ONE encoding of the naming rule
    ``_NAME_RE`` enforces. Invalid characters become ``_``; a leading
    digit gets a ``_`` prefix."""
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


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple:
    """A fixed log-spaced bucket layout covering ``[lo, hi]`` with
    ``per_decade`` bounds per factor of 10. Fleet-mergeable histograms
    want every publisher on the SAME layout — building the layout from
    (lo, hi, per_decade) instead of hand-typed tuples makes "same
    layout" a constructor argument, not a copy-paste discipline. Bounds
    are rounded to 6 significant digits so independently constructed
    layouts compare equal."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    step = 10.0 ** (1.0 / per_decade)
    out, v = [], float(lo)
    while v < hi * (1.0 + 1e-9):
        out.append(float(f"{v:.6g}"))
        v *= step
    return tuple(out)


def hist_state_delta(cur: dict, prev: dict | None) -> dict:
    """Bucket-wise difference of two histogram ``state()`` snapshots of
    the SAME metric (``cur`` observed after ``prev``): the compact
    "what happened since the last push" payload a replica ships to the
    router. ``prev=None`` means the full state IS the delta (first
    push). The delta's min/max are the current snapshot's — bounded by
    one bucket width of the true window extremes, which is exactly the
    accuracy the bucket counts themselves carry. Exemplars ride the
    current per-bucket worst (merge takes per-bucket max, so replaying
    them is idempotent)."""
    if prev is None:
        return dict(cur)
    if list(cur["buckets"]) != list(prev["buckets"]):
        raise ValueError("histogram delta across different bucket layouts")
    counts = [int(c) - int(p)
              for c, p in zip(cur["counts"], prev["counts"])]
    if any(c < 0 for c in counts):
        # The source histogram was reset (replica restart): the full
        # current state is the honest delta.
        return dict(cur)
    out = {
        "buckets": list(cur["buckets"]),
        "counts": counts,
        "count": int(cur["count"]) - int(prev["count"]),
        "sum": float(cur["sum"]) - float(prev["sum"]),
        "min": cur["min"],
        "max": cur["max"],
    }
    if cur.get("exemplars"):
        out["exemplars"] = cur["exemplars"]
    return out


def merge_hist_states(*states: dict) -> dict:
    """Exact bucket-wise merge of histogram ``state()`` dicts sharing
    one layout — associative and commutative by construction (integer
    adds + min/max), so fleet aggregation can fold per-replica deltas
    in any arrival order and any grouping. Returns a new state dict."""
    states = [s for s in states if s]
    if not states:
        raise ValueError("merge of zero histogram states")
    base = states[0]
    counts = [0] * len(base["counts"])
    total, sm = 0, 0.0
    mn, mx = math.inf, -math.inf
    exemplars: list = [None] * len(counts)
    for s in states:
        if list(s["buckets"]) != list(base["buckets"]):
            raise ValueError(
                "histogram merge across different bucket layouts")
        for i, c in enumerate(s["counts"]):
            counts[i] += int(c)
        total += int(s["count"])
        sm += float(s["sum"])
        if s["count"]:
            mn = min(mn, float(s["min"]))
            mx = max(mx, float(s["max"]))
        for i, ex in enumerate(s.get("exemplars") or []):
            if ex is None:
                continue
            cur = exemplars[i]
            if cur is None or float(ex[0]) > float(cur[0]):
                exemplars[i] = [float(ex[0]), ex[1]]
    out = {
        "buckets": list(base["buckets"]),
        "counts": counts,
        "count": total,
        "sum": sm,
        "min": (mn if total else None),
        "max": (mx if total else None),
    }
    if any(e is not None for e in exemplars):
        out["exemplars"] = exemplars
    return out


def hist_state_percentile(state: dict, q: float) -> float:
    """Bucket-interpolated percentile over a histogram ``state()`` dict
    — the ONE estimator live histograms, fleet merges, and timeseries
    windows all share, so a fleet p99 and a single-replica p99 disagree
    only by what their bucket counts disagree by. Edge cases match
    :func:`percentile`: empty raises, a single sample is returned
    exactly (the sum of one sample IS the sample)."""
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
    """Set/inc/dec point-in-time value."""

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

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

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

    def cumulative_counts(self) -> list[tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, ending at (+inf, count)
        — the Prometheus ``_bucket{le=...}`` series."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for bound, c in zip(self.bucket_bounds, counts):
            acc += c
            out.append((bound, acc))
        out.append((math.inf, acc + counts[-1]))
        return out

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile estimate; agrees with the exact
        :func:`percentile` on the edge cases (empty raises, one sample is
        returned exactly)."""
        return hist_state_percentile(self.state(exemplars=False), q)

    # -- mergeable-histogram surface ----------------------------------------
    def state(self, exemplars: bool = True) -> dict:
        """JSON-able full snapshot of the histogram's mergeable state:
        per-bucket counts (NON-cumulative), count/sum/min/max, bucket
        layout, and (optionally) the per-bucket worst-sample exemplars.
        ``state()`` dicts are the unit of fleet telemetry: deltas
        (:func:`hist_state_delta`) ship over the wire, merges
        (:func:`merge_hist_states` / :meth:`merge_state`) fold them."""
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

    def merge_state(self, state: dict) -> None:
        """Fold a ``state()``/delta dict into this histogram — the
        bucket-exact merge the router applies to every pushed replica
        delta. Requires an identical bucket layout (fleet mergeability
        is why layouts are fixed at construction). Commutative and
        associative over the bucket state: any fold order yields the
        same counts/sum/min/max."""
        if list(state["buckets"]) != list(self.bucket_bounds):
            raise ValueError(
                f"cannot merge {self.name!r}: bucket layout "
                f"{state['buckets']} != {list(self.bucket_bounds)}")
        exemplars = state.get("exemplars") or []
        with self._lock:
            for i, c in enumerate(state["counts"]):
                self._counts[i] += int(c)
            self._count += int(state["count"])
            self._sum += float(state["sum"])
            if state["count"]:
                if state["min"] is not None:
                    self._min = min(self._min, float(state["min"]))
                if state["max"] is not None:
                    self._max = max(self._max, float(state["max"]))
            for i, ex in enumerate(exemplars):
                if ex is None or i >= len(self._exemplars):
                    continue
                cur = self._exemplars[i]
                if cur is None or float(ex[0]) > cur[0]:
                    self._exemplars[i] = (float(ex[0]), ex[1])

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram of the same bucket layout into this
        one (see :meth:`merge_state`)."""
        self.merge_state(other.state())


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

    def remove(self, metric) -> None:
        """Unregister a metric instance (e.g. a superseded info-style
        labeled series that would otherwise live in every scrape
        forever). No-op when it was never (or already un-) registered;
        existing handles to the object keep working but stop being
        collected."""
        with self._lock:
            for key, m in list(self._metrics.items()):
                if m is metric:
                    del self._metrics[key]
                    return

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
