"""Windowed fleet-telemetry aggregates: ring-buffer timeseries, delta
encoding, and the router-side fold.

Copy of the reference's ``distkeras_tpu/telemetry/timeseries.py``, which
imports no JAX; only its imports differ.

The registry (:mod:`.registry`) answers "what happened since process
start"; an SLO burn rate needs "what happened in the last N seconds",
fleet-wide. Three pieces close that gap, all dependency-free and
host-side only (nothing here may touch the device — telemetry must add zero
retraces):

- :class:`DeltaEncoder` — replica-side: snapshots a
  :class:`~distkeras_tpu_torch.telemetry.registry.MetricsRegistry` and emits
  the compact JSON-able **delta** since its previous call (histogram
  bucket-count diffs via :func:`~distkeras_tpu_torch.telemetry.registry.
  hist_state_delta`, counter diffs, gauge values). Zero-change metrics
  are omitted, so a quiet replica's push is a few bytes.
- :class:`TimeSeriesStore` — a per-metric ring buffer of fixed-width
  time windows. Each window keeps the histogram's NON-cumulative
  bucket counts, so a sliding p50/p99 over any span is an exact
  bucket-wise merge of windows (:meth:`TimeSeriesStore.summary`), not
  an estimate over estimates. Counters get per-window rates. Memory is
  O(metrics x capacity x buckets), independent of traffic.
- :class:`FleetAggregator` — router-side: folds replica delta payloads
  into (a) per-replica merged histograms/counters in a private
  registry (labels ``replica``/``role``, rendered on the fleet
  Prometheus page), (b) fleet-wide merged histograms (exact bucket
  merge across replicas — the true fleet p99 the pull-time JSON
  concatenation could never compute), and (c) the
  :class:`TimeSeriesStore` the SLO burn-rate engine
  (:mod:`distkeras_tpu_torch.serving.slo`) evaluates windows from.
"""

from __future__ import annotations

import collections
import threading
import time

from distkeras_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    hist_state_delta,
    hist_state_percentile,
    merge_hist_states,
)

__all__ = ["DeltaEncoder", "TimeSeriesStore", "FleetAggregator"]


class DeltaEncoder:
    """Replica-side telemetry delta source.

    Each :meth:`delta` call snapshots every metric in ``registry`` and
    returns what changed since the previous call::

        {"seq": 3, "t": <unix-ts>,
         "hists":    {"name{a=b}": <hist delta state>, ...},
         "counters": {"name{a=b}": <increment>, ...},
         "gauges":   {"name{a=b}": <value>, ...}}

    Histogram deltas are bucket-count diffs (a restarted/reset source
    re-ships its full state — :func:`hist_state_delta` detects the
    counter going backwards). Counters ship increments; gauges ship
    current values (a gauge has no meaningful delta). Metric keys carry
    the label set inline (``name{k=v,...}``) so the receiving fold can
    reconstruct (name, labels) exactly.
    """

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.seq = 0
        self._hist_prev: dict[str, dict] = {}
        self._counter_prev: dict[str, float] = {}

    @staticmethod
    def metric_key(m) -> str:
        key = m.name
        if m.labels:
            key += "{" + ",".join(
                f"{k}={v}" for k, v in sorted(m.labels.items())) + "}"
        return key

    @staticmethod
    def parse_key(key: str) -> tuple[str, dict]:
        """Inverse of :meth:`metric_key`: ``name{k=v,...}`` back to
        (name, labels)."""
        if "{" not in key:
            return key, {}
        name, _, body = key.partition("{")
        labels = {}
        for pair in body.rstrip("}").split(","):
            if "=" in pair:
                k, _, v = pair.partition("=")
                labels[k] = v
        return name, labels

    def delta(self, full: bool = False) -> dict:
        """The changes since the previous call (everything, when
        ``full`` or on the first call)."""
        self.seq += 1
        out = {"seq": self.seq, "t": time.time(),
               "hists": {}, "counters": {}, "gauges": {}}
        for m in self.registry.collect():
            key = self.metric_key(m)
            if m.kind == "histogram":
                cur = m.state()
                prev = None if full else self._hist_prev.get(key)
                try:
                    d = hist_state_delta(cur, prev)
                except ValueError:
                    d = cur  # layout changed (re-created metric)
                self._hist_prev[key] = cur
                if d["count"] or prev is None:
                    d["help"] = m.help
                    out["hists"][key] = d
            elif m.kind == "counter":
                prev = 0.0 if full else self._counter_prev.get(key, 0.0)
                inc = float(m.value) - prev
                if inc < 0:  # reset source: full value is the delta
                    inc = float(m.value)
                self._counter_prev[key] = float(m.value)
                if inc:
                    out["counters"][key] = inc
            else:
                out["gauges"][key] = float(m.value)
        return out


class TimeSeriesStore:
    """Ring buffer of per-window aggregates, one ring per metric name.

    ``record_hist(name, delta_state)`` folds a histogram delta into the
    OPEN window's accumulator; ``record_value(name, v)`` accumulates a
    counter increment. When the clock passes a window boundary the open
    window closes into the ring: histograms keep their merged bucket
    counts (so any-span percentiles stay bucket-exact), counters keep
    (value, rate).

    ``window_s`` is the resolution; ``capacity`` windows bound memory
    and the longest queryable span. ``clock`` is injectable for exact
    tests.
    """

    def __init__(self, window_s: float = 1.0, capacity: int = 512,
                 clock=time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._rings: dict[str, collections.deque] = {}
        self._open: dict[str, dict] = {}  # name -> accumulating entry
        self._open_t0: float | None = None

    # -- window lifecycle ---------------------------------------------------
    def _roll_locked(self, now: float) -> None:
        if self._open_t0 is None:
            self._open_t0 = now
            return
        while now - self._open_t0 >= self.window_s:
            t1 = self._open_t0 + self.window_s
            for name, acc in self._open.items():
                ring = self._rings.setdefault(
                    name, collections.deque(maxlen=self.capacity))
                entry = {"t0": self._open_t0, "t1": t1}
                if "hist" in acc:
                    entry["hist"] = acc["hist"]
                if "value" in acc:
                    entry["value"] = acc["value"]
                    entry["rate"] = acc["value"] / self.window_s
                if "gauge" in acc:
                    entry["gauge"] = acc["gauge"]
                    entry["last"] = acc["last"]
                ring.append(entry)
            self._open = {}
            self._open_t0 = t1
            # Skip straight to the window containing `now` (quiet gaps
            # produce no empty entries — a span query just sees fewer
            # windows, and rates divide by the windows that exist).
            if now - self._open_t0 >= self.window_s:
                gap = int((now - self._open_t0) / self.window_s)
                self._open_t0 += gap * self.window_s
                break

    def _acc_locked(self, name: str) -> dict:
        now = self._clock()
        self._roll_locked(now)
        return self._open.setdefault(name, {})

    # -- recording ----------------------------------------------------------
    def record_hist(self, name: str, delta_state: dict) -> None:
        """Fold a histogram delta ``state()`` dict into the open
        window."""
        if not delta_state.get("count"):
            return
        with self._lock:
            acc = self._acc_locked(name)
            cur = acc.get("hist")
            acc["hist"] = (dict(delta_state) if cur is None
                           else merge_hist_states(cur, delta_state))

    def record_value(self, name: str, v: float) -> None:
        """Accumulate a counter increment into the open window."""
        with self._lock:
            acc = self._acc_locked(name)
            acc["value"] = acc.get("value", 0.0) + float(v)

    def record_gauge(self, name: str, v: float) -> None:
        """Fold a gauge observation into the open window, keeping the
        window max (for pressure-style signals the worst value anywhere
        in the window is the one that matters) and the last value."""
        with self._lock:
            acc = self._acc_locked(name)
            acc["gauge"] = max(acc.get("gauge", float("-inf")), float(v))
            acc["last"] = float(v)

    def flush(self) -> None:
        """Force the open window closed (tests / shutdown snapshots)."""
        with self._lock:
            self._roll_locked(self._clock() + self.window_s)

    # -- queries ------------------------------------------------------------
    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def query(self, name: str, span_s: float | None = None) -> list[dict]:
        """Closed windows for ``name``, oldest first, restricted to the
        trailing ``span_s`` seconds when given."""
        with self._lock:
            self._roll_locked(self._clock())
            ring = list(self._rings.get(name, ()))
        if span_s is not None:
            cutoff = self._clock() - float(span_s)
            ring = [w for w in ring if w["t1"] > cutoff]
        return ring

    def summary(self, name: str, span_s: float | None = None) -> dict | None:
        """Merged aggregate over the span's windows: for histogram
        series the bucket-exact merged counts with sliding p50/p99 and
        an event rate; for counter series the summed value and mean
        rate. ``None`` when no window holds data."""
        windows = self.query(name, span_s)
        if not windows:
            return None
        t0, t1 = windows[0]["t0"], windows[-1]["t1"]
        hists = [w["hist"] for w in windows if "hist" in w]
        out: dict = {"t0": t0, "t1": t1, "windows": len(windows),
                     "span_s": t1 - t0}
        if hists:
            merged = merge_hist_states(*hists)
            out.update({
                "count": merged["count"],
                "sum": merged["sum"],
                "p50": hist_state_percentile(merged, 50),
                "p99": hist_state_percentile(merged, 99),
                "mean": merged["sum"] / merged["count"],
                "rate": merged["count"] / max(t1 - t0, 1e-9),
                "hist": merged,
            })
        vals = [w["value"] for w in windows if "value" in w]
        if vals:
            out["value"] = sum(vals)
            out["rate"] = out["value"] / max(t1 - t0, 1e-9)
        gauges = [w["gauge"] for w in windows if "gauge" in w]
        if gauges:
            out["gauge_max"] = max(gauges)
            out["gauge_last"] = windows[-1].get("last", gauges[-1])
        return out


class FleetAggregator:
    """Router-side fold of replica telemetry deltas.

    One instance per router. ``ingest(rid, role, payload)`` folds a
    :class:`DeltaEncoder` payload:

    - histograms/counters merge into the private fleet ``registry``
      twice — once labeled ``{replica=rid, role=role}`` (the
      per-replica series on the fleet Prometheus page) and once
      labeled ``{fleet="all"}`` (the exact fleet-wide merge);
    - gauges are set per-replica only (summing gauges across a fleet
      is usually a lie — occupancy ratios don't add);
    - fleet-wide histogram deltas and counter increments feed the
      :class:`TimeSeriesStore` (``store``) the SLO engine reads.

    ``staleness_s()`` reports the mean wall-clock age of payloads at
    fold time over a sliding window — the "aggregation staleness" the
    push plane exists to drive down vs poll-time concatenation.
    """

    FLEET_LABEL = {"fleet": "all"}

    def __init__(self, store: TimeSeriesStore | None = None):
        self.registry = MetricsRegistry()
        self.store = store if store is not None else TimeSeriesStore()
        self._lock = threading.Lock()
        self._staleness = collections.deque(maxlen=256)
        self.pushes = 0
        self.push_errors = 0
        self._last_seq: dict[str, int] = {}

    def ingest(self, rid: str, role: str | None, payload: dict) -> None:
        try:
            self._ingest(rid, role or "", payload)
            with self._lock:
                self.pushes += 1
                t = payload.get("t")
                if isinstance(t, (int, float)):
                    self._staleness.append(max(0.0, time.time() - t))
        except Exception:
            with self._lock:
                self.push_errors += 1

    def _ingest(self, rid: str, role: str, payload: dict) -> None:
        self._last_seq[rid] = int(payload.get("seq") or 0)
        per_replica = {"replica": rid, "role": role}
        for key, d in (payload.get("hists") or {}).items():
            name, labels = DeltaEncoder.parse_key(key)
            help = d.get("help", "")
            buckets = tuple(d["buckets"])
            self.registry.histogram(
                name, help=help, buckets=buckets,
                **{**labels, **per_replica}).merge_state(d)
            self.registry.histogram(
                name, help=help, buckets=buckets,
                **{**labels, **self.FLEET_LABEL}).merge_state(d)
            self.store.record_hist(key, d)
        for key, inc in (payload.get("counters") or {}).items():
            name, labels = DeltaEncoder.parse_key(key)
            self.registry.counter(
                name, **{**labels, **per_replica}).inc(float(inc))
            self.registry.counter(
                name, **{**labels, **self.FLEET_LABEL}).inc(float(inc))
            self.store.record_value(key, float(inc))
        for key, v in (payload.get("gauges") or {}).items():
            name, labels = DeltaEncoder.parse_key(key)
            self.registry.gauge(
                name, **{**labels, **per_replica}).set(float(v))
            self.store.record_gauge(key, float(v))

    def forget_replica(self, rid: str) -> None:
        """Drop a dead replica's gauge series (its counted history in
        the fleet merge stays — those events happened); wired to the
        supervisor's death callbacks so a restarted incarnation's
        gauges don't coexist with the corpse's."""
        with self._lock:
            self._last_seq.pop(rid, None)
        for m in self.registry.collect():
            if m.kind == "gauge" and m.labels.get("replica") == rid:
                self.registry.remove(m)

    def fleet_hist_state(self, name: str) -> dict | None:
        """The exact fleet-wide merged state of histogram ``name``
        (label-free lookup by metric name against the fleet series)."""
        for m in self.registry.collect():
            if (m.kind == "histogram" and m.name == name
                    and m.labels.get("fleet") == "all"):
                return m.state()
        return None

    def staleness_s(self) -> float | None:
        with self._lock:
            if not self._staleness:
                return None
            return sum(self._staleness) / len(self._staleness)

    def stats(self) -> dict:
        with self._lock:
            out = {"pushes": self.pushes,
                   "push_errors": self.push_errors,
                   "replicas": dict(self._last_seq)}
        st = self.staleness_s()
        if st is not None:
            out["staleness_s"] = round(st, 6)
        return out
