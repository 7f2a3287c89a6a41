"""Declarative SLOs evaluated as SRE-style multi-window burn rates.

Copy of the reference's ``distkeras_tpu/serving/slo.py``, which imports
no JAX; only its imports differ.

The fleet telemetry plane (:mod:`distkeras_tpu_torch.telemetry.timeseries`)
gives the router bucket-exact windowed aggregates; this module turns
them into operational judgement. Each :class:`Objective` declares what
"good" means — a latency threshold a target fraction of requests must
beat, a bad/total event ratio, or a pressure gauge's allowed
time-above-threshold — and the :class:`SLOEngine` evaluates every
objective over a FAST and a SLOW window as an error-budget **burn
rate**::

    burn = bad_fraction / (1 - target)

Burn 1.0 spends the budget exactly at its sustainable rate; the classic
SRE multiwindow alert pages when BOTH windows burn fast (fast window
confirms it's happening *now*, slow window confirms it isn't a blip).
Production tunings pair 5 min / 1 h windows with a 14.4x page factor
(budget gone in ~2 days) and 6x warn; the windows here default to
bench-scaled seconds and the factors carry over unchanged.

Each objective runs an ``ok -> warn -> page`` state machine. Every
transition is recorded as an event with the burn numbers and — for
latency objectives — **exemplar trace ids** harvested from the bucket
exemplars above the threshold, so a page arrives holding the ids of
actual slow requests to pull from ``tracez``. The router surfaces
:meth:`SLOEngine.snapshot` through its ``sloz`` verb and folds
:meth:`SLOEngine.overall` into ``healthz``.

Latency thresholds are snapped to the histogram's bucket bounds
(recorded as ``threshold_effective``) so the bad fraction is
bucket-exact rather than an interpolation — the same exactness contract
the merge layer keeps.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

__all__ = ["Objective", "SLOEngine", "default_objectives",
           "WARN_BURN", "PAGE_BURN"]

# Classic SRE multiwindow factors: page = budget gone in ~2 days,
# warn = budget gone in ~5 days (for a 28-day budget window).
WARN_BURN = 6.0
PAGE_BURN = 14.4

_STATE_RANK = {"ok": 0, "warn": 1, "page": 2}


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective.

    kind="latency": ``target`` fraction of observations in histogram
      ``metric`` must be <= ``threshold`` (seconds; snapped to a bucket
      bound). Bad fraction = tail mass above the snapped bound.
    kind="ratio": bad events (sum of ``bad`` counter series) over total
      events (sum of ``total`` counter series) must stay <= 1-target.
    kind="gauge": the windowed max of gauge ``metric`` may exceed
      ``threshold`` in at most 1-target of the span's windows
      (time-above-threshold as the bad fraction).

    Metric names are TimeSeriesStore keys — ``name`` or
    ``name{label=value,...}`` as produced by
    :meth:`~distkeras_tpu_torch.telemetry.timeseries.DeltaEncoder.metric_key`.
    """

    name: str
    kind: str  # "latency" | "ratio" | "gauge"
    target: float  # e.g. 0.99 => 1% error budget
    metric: str = ""  # latency/gauge: the series to evaluate
    threshold: float = 0.0  # latency: seconds; gauge: level
    bad: tuple = ()  # ratio: counter keys counting bad events
    total: tuple = ()  # ratio: counter keys counting all events
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("latency", "ratio", "gauge"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}")
        if self.kind in ("latency", "gauge") and not self.metric:
            raise ValueError(f"{self.kind} objective needs a metric")
        if self.kind == "ratio" and not (self.bad and self.total):
            raise ValueError("ratio objective needs bad and total series")


def default_objectives(
    ttft_threshold_s: float = 2.0,
    itl_threshold_s: float = 0.5,
    target: float = 0.99,
    error_target: float = 0.999,
    pool_pressure: float = 0.95,
    tier_host_budget_bytes: float | None = None,
) -> list[Objective]:
    """The serving fleet's standing objectives over the metric families
    :class:`~distkeras_tpu_torch.serving.metrics.ServingMetrics` pushes."""
    objs = [
        Objective(
            name="ttft_p99", kind="latency", target=target,
            metric="serving_ttft_seconds", threshold=ttft_threshold_s,
            description=f"{target:.0%} of requests see first token "
                        f"within {ttft_threshold_s}s"),
        Objective(
            name="itl_p99", kind="latency", target=target,
            metric="serving_inter_token_seconds",
            threshold=itl_threshold_s,
            description=f"{target:.0%} of decoded tokens arrive within "
                        f"{itl_threshold_s}s of the previous"),
        Objective(
            name="error_rate", kind="ratio", target=error_target,
            bad=("serving_requests_rejected_total",
                 "serving_requests_expired_total"),
            total=("serving_requests_completed_total",
                   "serving_requests_rejected_total",
                   "serving_requests_expired_total"),
            description="rejected + expired over all finished requests"),
        Objective(
            name="tenant_shed_rate", kind="ratio", target=target,
            bad=("serving_requests_rejected_total",),
            total=("serving_requests_completed_total",
                   "serving_requests_rejected_total"),
            description="backpressure sheds over completed + shed"),
        Objective(
            name="pool_pressure", kind="gauge", target=target,
            metric="serving_slot_occupancy", threshold=pool_pressure,
            description=f"decode slot occupancy above {pool_pressure} "
                        "counts as pressured time"),
    ]
    if tier_host_budget_bytes:
        objs.append(Objective(
            name="tier_pressure", kind="gauge", target=target,
            metric="kv_tier_host_bytes",
            threshold=0.9 * tier_host_budget_bytes,
            description="host KV tier above 90% of its byte budget"))
    return objs


class SLOEngine:
    """Evaluates objectives against a
    :class:`~distkeras_tpu_torch.telemetry.timeseries.TimeSeriesStore`.

    ``fast_window_s`` / ``slow_window_s`` are the two burn windows
    (production ~300 s / ~3600 s; defaults are bench-scaled). The store
    is usually a :class:`FleetAggregator`'s, so every fraction is
    fleet-wide. ``evaluate()`` is cheap — bucket sums over at most
    ``capacity`` ring windows per series — and its wall cost is
    self-reported (``eval_cost_s``) so the bench can record burn-engine
    overhead.
    """

    def __init__(self, store, objectives: list[Objective] | None = None,
                 fast_window_s: float = 2.0, slow_window_s: float = 15.0,
                 warn_burn: float = WARN_BURN,
                 page_burn: float = PAGE_BURN,
                 clock=time.monotonic):
        if fast_window_s >= slow_window_s:
            raise ValueError(
                f"fast window ({fast_window_s}s) must be shorter than "
                f"slow ({slow_window_s}s)")
        self.store = store
        self.objectives = list(
            default_objectives() if objectives is None else objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self._clock = clock
        self._state: dict[str, str] = {o.name: "ok"
                                       for o in self.objectives}
        self._since: dict[str, float] = {o.name: clock()
                                         for o in self.objectives}
        self.events: collections.deque = collections.deque(maxlen=128)
        self.evaluations = 0
        self.eval_cost_s = 0.0
        self._last: list[dict] = []

    # -- per-kind bad fractions --------------------------------------------
    def _latency_fraction(self, obj: Objective, span_s: float):
        """(bad_fraction, total, snapped threshold, exemplar ids)."""
        s = self.store.summary(obj.metric, span_s)
        if not s or "hist" not in s or not s["count"]:
            return None
        hist = s["hist"]
        bounds = hist["buckets"]
        # Snap to the first bound >= threshold: "within threshold"
        # becomes "within this bucket's upper bound", and the tail mass
        # above it is exact.
        bi = bisect.bisect_left(bounds, obj.threshold)
        eff = bounds[bi] if bi < len(bounds) else float("inf")
        bad = sum(hist["counts"][bi + 1:])
        exemplars = []
        for ex in (hist.get("exemplars") or [])[bi + 1:]:
            if ex and ex[1] is not None and ex[1] not in exemplars:
                exemplars.append(ex[1])
        return bad / s["count"], s["count"], eff, exemplars[:8]

    def _ratio_fraction(self, obj: Objective, span_s: float):
        bad = total = 0.0
        for key in obj.bad:
            s = self.store.summary(key, span_s)
            bad += s.get("value", 0.0) if s else 0.0
        for key in obj.total:
            s = self.store.summary(key, span_s)
            total += s.get("value", 0.0) if s else 0.0
        if total <= 0:
            return None
        return bad / total, total, None, []

    def _gauge_fraction(self, obj: Objective, span_s: float):
        windows = self.store.query(obj.metric, span_s)
        windows = [w for w in windows if "gauge" in w]
        if not windows:
            return None
        bad = sum(1 for w in windows if w["gauge"] > obj.threshold)
        return bad / len(windows), len(windows), obj.threshold, []

    # -- evaluation ---------------------------------------------------------
    def _window(self, obj: Objective, span_s: float):
        fn = {"latency": self._latency_fraction,
              "ratio": self._ratio_fraction,
              "gauge": self._gauge_fraction}[obj.kind]
        r = fn(obj, span_s)
        if r is None:
            return None
        frac, total, eff, exemplars = r
        budget = 1.0 - obj.target
        out = {"bad_fraction": frac, "total": total,
               "burn": frac / budget}
        if eff is not None:
            out["threshold_effective"] = eff
        if exemplars:
            out["exemplars"] = exemplars
        return out

    def evaluate(self) -> list[dict]:
        """Evaluate every objective; returns per-objective dicts and
        advances the state machines (transitions append to
        :attr:`events`)."""
        t0 = time.perf_counter()
        now = self._clock()
        results = []
        for obj in self.objectives:
            fast = self._window(obj, self.fast_window_s)
            slow = self._window(obj, self.slow_window_s)
            # No data in a window burns nothing: an idle fleet is not
            # out of SLO, and a brand-new objective starts ok.
            fb = fast["burn"] if fast else 0.0
            sb = slow["burn"] if slow else 0.0
            if fb >= self.page_burn and sb >= self.page_burn:
                state = "page"
            elif fb >= self.warn_burn and sb >= self.warn_burn:
                state = "warn"
            else:
                state = "ok"
            prev = self._state[obj.name]
            if state != prev:
                exemplars = ((fast or {}).get("exemplars")
                             or (slow or {}).get("exemplars") or [])
                self.events.append({
                    "t": time.time(), "objective": obj.name,
                    "from": prev, "to": state,
                    "fast_burn": round(fb, 3),
                    "slow_burn": round(sb, 3),
                    "exemplars": exemplars,
                })
                self._state[obj.name] = state
                self._since[obj.name] = now
            entry = {
                "objective": obj.name, "kind": obj.kind,
                "target": obj.target, "state": state,
                "since_s": round(now - self._since[obj.name], 3),
                "fast_burn": round(fb, 3), "slow_burn": round(sb, 3),
                "description": obj.description,
            }
            if fast:
                entry["fast"] = fast
            if slow:
                entry["slow"] = slow
            results.append(entry)
        self._last = results
        self.evaluations += 1
        self.eval_cost_s += time.perf_counter() - t0
        return results

    def overall(self) -> str:
        """Worst objective state from the most recent evaluation."""
        if not self._last:
            return "ok"
        return max((r["state"] for r in self._last),
                   key=_STATE_RANK.__getitem__)

    def snapshot(self) -> dict:
        """The ``sloz`` payload: config, latest per-objective results,
        recent transitions, and self-cost."""
        return {
            "overall": self.overall(),
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
            "burn_thresholds": {"warn": self.warn_burn,
                                "page": self.page_burn},
            "objectives": list(self._last),
            "events": list(self.events),
            "evaluations": self.evaluations,
            "eval_cost_s": round(self.eval_cost_s, 6),
        }
