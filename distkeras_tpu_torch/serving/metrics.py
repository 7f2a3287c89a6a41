"""Serving observability: latency-under-load metrics.

Copy of the reference's ``distkeras_tpu/serving/metrics.py``, which imports no JAX;
only its imports differ. ``MetricStream`` comes from the port's own ``tracing.py``.

Training benchmarks in this repo measure *throughput* (samples/sec/chip,
``tracing.StepTimer``); a serving engine is judged on *latency under
load*: TTFT (time to first token), inter-token latency (decode-step
cadence), queue depth, slot occupancy, and goodput (tokens/sec actually
delivered). TTFT is recorded **split into its two causes** — admission
wait (``queue_wait``: submit → slot grant, the scheduler's doing) and
prefill device time (``prefill_device``: the chunks' compute, the
model's doing; any gap between the two in chunked mode is decode-tick
interleave) — because the operator response differs: queueing delay
wants more slots or load shedding, prefill cost wants a prefix cache or
smaller chunks. :class:`ServingMetrics`
accumulates those and emits structured records through the same
:class:`distkeras_tpu_torch.tracing.MetricStream` JSONL sinks the trainers use;
:meth:`ServingMetrics.summary` follows ``StepTimer.summary``'s key
conventions (``*_p50_s`` etc.) with the tail percentiles (p95/p99) that
matter for serving SLOs.

Every event also publishes into a
:class:`~distkeras_tpu_torch.telemetry.registry.MetricsRegistry` (counters for
request outcomes, histograms for the latency series, gauges for queue
depth / occupancy) — the registry is what the server's ``metricsz``
control verb scrapes live, and the percentile definition is the ONE
shared :func:`distkeras_tpu_torch.telemetry.registry.percentile`.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable

from distkeras_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    percentile as _percentile,
)
from distkeras_tpu_torch.tracing import MetricStream

__all__ = ["BubbleTracker", "HostGapTracker", "ServingMetrics",
           "percentile"]

# Decode ticks and inter-token gaps sit well under the default buckets'
# upper range; keep a finer low end for them.
_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def percentile(values: Iterable[float], q: float) -> float:
    """Shared linear-interpolated percentile (``q`` in [0, 100]); see
    :func:`distkeras_tpu_torch.telemetry.registry.percentile` — kept as a
    re-export because serving callers historically imported it here."""
    return _percentile(values, q)


class HostGapTracker:
    """Per-tick device-idle accounting for the decode pipeline.

    Three observable instants exist per tick: **dispatch** (the jit call
    returned — work is queued on the device), **harvest start** (the
    host began the tick's one D2H read) and **harvest end** (the read
    returned — the device has certainly finished the tick). From those:

    - ``host gap``: how long the device queue sat EMPTY before a
      dispatch. It is measurable exactly when the previous tick was
      already harvested (the queue has been empty since at latest that
      harvest's end): ``gap = max(0, t_dispatch - t_prev_harvest_end)``.
      When a tick is still in flight at dispatch time (the pipelined
      steady state) the queue was never empty and the gap is 0 by
      construction. At ``pipeline_depth=0`` — harvest immediately after
      every dispatch — the gap is the full serialized host window: every
      microsecond of streaming/admission/socket work the device waited
      through. (When the harvest returned instantly the device had
      finished somewhere before harvest start, so the measured gap is a
      slight *under*-estimate; it can never over-report idleness.)
    - ``device idle ratio``: windowed ``sum(gaps) / sum(dispatch
      intervals)`` — the fraction of wall time between ticks the device
      was provably idle. The pipelined engine drives this toward 0.

    ``clock`` is injectable (a fake clock makes the accounting exactly
    testable); the optional histogram/gauge mirror the window into the
    registry (``serving_host_gap_seconds`` /
    ``serving_device_idle_ratio``)."""

    def __init__(self, histogram=None, idle_gauge=None,
                 clock=time.monotonic, window: int = 4096):
        self._clock = clock
        self._hist = histogram
        self._gauge = idle_gauge
        self._pending = 0           # dispatched, not yet harvested
        self._last_dispatch: float | None = None
        self._last_harvest_end: float | None = None
        self._harvest_start: float | None = None
        self.last_gap = 0.0
        self.last_harvest_wait = 0.0
        self.gaps = collections.deque(maxlen=window)
        self.intervals = collections.deque(maxlen=window)

    def tick_dispatched(self, t: float | None = None) -> float:
        t = self._clock() if t is None else t
        if self._pending == 0 and self._last_harvest_end is not None:
            gap = max(0.0, t - self._last_harvest_end)
        else:
            # Either the first tick ever, or a tick was still in
            # flight: the device queue was never observed empty.
            gap = 0.0
        self.last_gap = gap
        self.gaps.append(gap)
        if self._hist is not None:
            self._hist.observe(gap)
        if self._last_dispatch is not None:
            self.intervals.append(max(0.0, t - self._last_dispatch))
        self._last_dispatch = t
        self._pending += 1
        return t

    def harvest_started(self, t: float | None = None) -> float:
        self._harvest_start = self._clock() if t is None else t
        return self._harvest_start

    def harvest_ended(self, t: float | None = None) -> float:
        t = self._clock() if t is None else t
        self._pending = max(0, self._pending - 1)
        self._last_harvest_end = t
        self.last_harvest_wait = (max(0.0, t - self._harvest_start)
                                  if self._harvest_start is not None
                                  else 0.0)
        self._harvest_start = None
        if self._gauge is not None:
            self._gauge.set(self.idle_ratio or 0.0)
        return t

    @property
    def idle_ratio(self) -> float | None:
        """Windowed device-idle fraction; None until two ticks ran."""
        total = sum(self.intervals)
        if total <= 0:
            return None
        # gaps has one more entry than intervals (the first dispatch
        # has no interval); drop the first gap for a matched window.
        gaps = list(self.gaps)[-len(self.intervals):]
        return min(1.0, sum(gaps) / total)

    @property
    def gap_p50(self) -> float | None:
        return percentile(self.gaps, 50) if self.gaps else None

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {}
        if self.gaps:
            out["host_gap_p50_s"] = percentile(self.gaps, 50)
            out["host_gap_p99_s"] = percentile(self.gaps, 99)
            out["host_gap_mean_s"] = sum(self.gaps) / len(self.gaps)
        ratio = self.idle_ratio
        if ratio is not None:
            out["device_idle_ratio"] = ratio
        return out


class BubbleTracker:
    """Pipeline-stage idle ("bubble") accounting — the ``HostGapTracker``
    family's pp sibling, built from the SAME two host instants every
    tick already stamps (dispatch, harvest end).

    A decode tick on a ``pp=S`` mesh occupies each stage for roughly
    ``span / S`` of its dispatch→harvest span (the micro-batch flows
    through the S stage programs back to back). Over a window of ticks,
    total per-stage busy time is ``sum(spans) / S`` while per-stage
    capacity is the window's wall span — so

        ``bubble_fraction = 1 - (sum(spans) / S) / wall``

    is the fraction of stage-time the pipeline provably wasted. One
    tick in flight (``pipeline_depth<=1``) serializes the spans: wall ≈
    sum(spans) and the bubble sits near ``1 - 1/S`` (half the machine
    idle at S=2). ``pipeline_depth>=S`` overlaps micro-batches until
    wall ≈ sum(spans)/S and the bubble approaches 0 — exactly the
    ramp-up/drain-only residue the depth sweep in ``serving_bench
    --pp-ab`` measures. Host-side stalls inside a span bias the
    estimate toward LESS reported idleness, never more (same
    conservative direction as the host-gap tracker), and the fraction
    is clamped to [0, 1]."""

    def __init__(self, gauge=None, window: int = 4096):
        self._gauge = gauge
        self._spans = collections.deque(maxlen=window)
        self.num_stages = 1

    def record(self, t_dispatch: float, t_harvest: float,
               num_stages: int) -> None:
        """One completed tick's dispatch→harvest span."""
        self.num_stages = max(1, int(num_stages))
        self._spans.append((float(t_dispatch), float(t_harvest)))
        if self._gauge is not None:
            f = self.fraction
            if f is not None:
                self._gauge.set(f)

    def reset(self) -> None:
        self._spans.clear()

    @property
    def fraction(self) -> float | None:
        """Windowed stage-idle fraction; None until two ticks ran."""
        if len(self._spans) < 2:
            return None
        wall = (max(t1 for _, t1 in self._spans)
                - min(t0 for t0, _ in self._spans))
        if wall <= 0:
            return None
        busy = sum(t1 - t0 for t0, t1 in self._spans) / self.num_stages
        return min(1.0, max(0.0, 1.0 - busy / wall))

    def summary(self) -> dict[str, float]:
        f = self.fraction
        return {} if f is None else {"bubble_fraction": f}


class ServingMetrics:
    """Accumulates per-request and per-iteration serving metrics.

    ``stream``: optional :class:`MetricStream`; every :meth:`sample` call
    (one per engine decode iteration) emits a structured record, so a
    JSONL sink yields a time series of queue depth / occupancy /
    cumulative token counts alongside the trainers' step records.

    ``registry``: optional :class:`MetricsRegistry` to publish into; a
    private one is created when omitted (tests and multi-engine
    processes stay isolated; pass a shared registry to aggregate).

    Sample series are bounded sliding windows (``window`` most-recent
    entries) — the engine runs for the server's lifetime, and unbounded
    per-token lists would grow to hundreds of MB over a multi-day run.
    Counters (completed/rejected/tokens_out) are exact and unbounded;
    :meth:`summary` percentiles cover the window (the registry histograms
    cover the full lifetime, O(buckets) memory).
    """

    def __init__(self, stream: MetricStream | None = None,
                 window: int = 16384,
                 registry: MetricsRegistry | None = None):
        self.stream = stream
        self.registry = registry if registry is not None else MetricsRegistry()
        self.ttft = collections.deque(maxlen=window)
        self.inter_token = collections.deque(maxlen=window)
        self.queue_wait = collections.deque(maxlen=window)
        self.prefill_device = collections.deque(maxlen=window)
        self.prefill_chunks = collections.deque(maxlen=window)
        self.request_latency = collections.deque(maxlen=window)
        self._occupancy = collections.deque(maxlen=window)
        self._queue_depth = collections.deque(maxlen=window)
        self._iterations = 0
        self._t0 = time.monotonic()

        reg = self.registry
        self._c_completed = reg.counter(
            "serving_requests_completed_total", help="requests completed")
        self._c_rejected = reg.counter(
            "serving_requests_rejected_total", help="backpressure rejects")
        self._c_expired = reg.counter(
            "serving_requests_expired_total", help="deadline expiries")
        self._c_tokens = reg.counter(
            "serving_tokens_out_total", help="tokens streamed to clients")
        self._c_iterations = reg.counter(
            "serving_decode_iterations_total", help="decode loop iterations")
        self._h = {
            "ttft": reg.histogram(
                "serving_ttft_seconds", help="time to first token",
                buckets=_LATENCY_BUCKETS),
            "inter_token": reg.histogram(
                "serving_inter_token_seconds", help="inter-token latency",
                buckets=_LATENCY_BUCKETS),
            "queue_wait": reg.histogram(
                "serving_queue_wait_seconds",
                help="admission wait: submit to slot grant "
                     "(the queueing half of TTFT)",
                buckets=_LATENCY_BUCKETS),
            "prefill_device": reg.histogram(
                "serving_prefill_device_seconds",
                help="prefill device time per request, summed over chunks "
                     "(the compute half of TTFT)",
                buckets=_LATENCY_BUCKETS),
            "prefill_chunks": reg.histogram(
                "serving_prefill_chunks",
                help="prefill chunks per admission",
                buckets=(1, 2, 4, 8, 16, 32, 64)),
            "request_latency": reg.histogram(
                "serving_request_latency_seconds",
                help="submit-to-done latency", buckets=_LATENCY_BUCKETS),
        }
        # Decode-pipeline accounting: the per-tick host gap (device
        # provably idle before a dispatch) and the windowed device-idle
        # fraction — what the overlapped pipeline exists to drive to 0.
        self.host_gap = HostGapTracker(
            histogram=reg.histogram(
                "serving_host_gap_seconds",
                help="host-side gap the device sat idle before a decode "
                     "tick dispatch (pipeline_depth=0 pays this every "
                     "tick; depth 1 hides it behind the in-flight tick)",
                buckets=_LATENCY_BUCKETS),
            idle_gauge=reg.gauge(
                "serving_device_idle_ratio",
                help="windowed fraction of inter-tick wall time the "
                     "device was provably idle (host gap / dispatch "
                     "interval)"))
        # Pipeline-parallel stage-idle accounting: the fraction of
        # stage-time provably wasted to pipeline bubbles (1 - 1/pp at
        # depth<=1; driven toward 0 by depth>=pp micro-batch overlap).
        self.bubble = BubbleTracker(
            gauge=reg.gauge(
                "serving_bubble_fraction",
                help="windowed fraction of pipeline-stage time idle "
                     "between micro-batch ticks (pp meshes; lower is "
                     "better, 0 = every stage busy)"))
        # Speculative decoding: proposed vs committed draft tokens (the
        # ratio is the accept rate — THE health signal for a draft
        # model: it falling means the draft stopped predicting the
        # target and speculation is burning draft compute for nothing),
        # plus the per-row-per-tick accept-length histogram whose
        # exemplars name the request behind an accept-rate collapse.
        self._c_spec_draft = reg.counter(
            "spec_draft_tokens_total",
            help="draft tokens proposed by the speculative decoder")
        self._c_spec_accepted = reg.counter(
            "spec_accepted_tokens_total",
            help="draft tokens accepted (committed) by the target "
                 "verify step")
        self._h["spec_accept_len"] = reg.histogram(
            "serving_spec_accept_len",
            help="accepted drafts per speculating row per tick "
                 "(0..spec_k)",
            buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))
        self._c_slo_violations = reg.counter(
            "serving_slo_violations_total",
            help="requests that finished slower than the configured "
                 "latency SLO")
        # Paged-KV pool pressure (the pool itself publishes the
        # kv_pool_blocks_* occupancy gauges; these count the engine's
        # RESPONSES to pressure).
        self._c_preemptions = reg.counter(
            "kv_preemptions_total",
            help="decode slots evicted (blocks released, request "
                 "requeued) because the KV block pool ran dry")
        self._c_oom_rejections = reg.counter(
            "kv_oom_rejections_total",
            help="requests rejected because their full context can "
                 "never fit the KV block pool")
        # KV block migration (disaggregated prefill/decode + cross-
        # replica prefix sharing, serving/kv_transfer.py): adoptions of
        # a peer's blocks, bytes moved, fallbacks to monolithic
        # prefill, and the pull latency with trace exemplars — the
        # family the "decode fleet starving" runbook triages first.
        self._c_kv_migrations = reg.counter(
            "kv_migrations_total",
            help="KV block chains adopted from a peer replica "
                 "(disaggregated handoff / cross-replica prefix share "
                 "/ slot migration)")
        self._c_kv_migration_fallbacks = reg.counter(
            "kv_migration_fallbacks_total",
            help="KV migrations that fell back to monolithic prefill "
                 "(peer unreachable/miss, provenance mismatch, pool "
                 "dry) — never a client-visible error")
        self._c_kv_migration_bytes = reg.counter(
            "kv_migration_bytes_total",
            help="serialized KV block bytes adopted from peers")
        self._c_kv_exports = reg.counter(
            "kv_exports_total",
            help="KV block chains serialized and shipped to a peer")
        self._h["kv_migration"] = reg.histogram(
            "kv_migration_seconds",
            help="peer pull + adopt latency per KV migration",
            buckets=_LATENCY_BUCKETS)
        # Tiered KV cache (serving/kv_tier.py): device⇄host block
        # movement plus router-scheduled P→D pushes. The tier itself
        # publishes kv_tier_{host,disk}_bytes occupancy; these count
        # the ENGINE's traffic through it, exemplar'd with the trace
        # that triggered each move.
        self._c_kv_spills = reg.counter(
            "kv_tier_spills_total",
            help="trie eviction victims spilled D2H into the host tier")
        self._c_kv_spill_bytes = reg.counter(
            "kv_tier_spill_bytes_total",
            help="serialized KVX1 bytes spilled into the host tier")
        self._c_kv_readmits = reg.counter(
            "kv_tier_readmits_total",
            help="blocks re-admitted H2D from the host tier on a trie "
                 "miss during admission")
        self._c_kv_readmit_bytes = reg.counter(
            "kv_tier_readmit_bytes_total",
            help="serialized KVX1 bytes re-admitted from the host tier")
        self._c_kv_pushes = reg.counter(
            "kv_pushes_total",
            help="KV chains pushed to a peer (router-scheduled P→D "
                 "transfer, replacing an adopt-time pull)")
        self._c_kv_push_bytes = reg.counter(
            "kv_push_bytes_total",
            help="serialized KV bytes delivered by push transfers")
        self._c_kv_push_fallbacks = reg.counter(
            "kv_push_fallbacks_total",
            help="push transfers that failed (receiver pulls or "
                 "re-prefills instead) — never a client-visible error")
        self._h["kv_spill"] = reg.histogram(
            "kv_tier_spill_seconds",
            help="D2H gather + serialize latency per spilled block",
            buckets=_LATENCY_BUCKETS)
        self._h["kv_readmit"] = reg.histogram(
            "kv_tier_readmit_seconds",
            help="host-tier probe + H2D scatter latency per "
                 "re-admission burst",
            buckets=_LATENCY_BUCKETS)
        self._h["kv_push"] = reg.histogram(
            "kv_push_seconds",
            help="export + deliver + remote-adopt latency per push",
            buckets=_LATENCY_BUCKETS)
        self._g_kv_tier_resident = reg.gauge(
            "kv_tier_resident_bytes",
            help="bytes resident in the DEVICE pool tier (blocks_used "
                 "x bytes_per_block)")
        self._g_slo = reg.gauge(
            "serving_slo_seconds",
            help="configured request-latency SLO (0 = no SLO armed)")
        self._c_prefix_hit_tokens = reg.counter(
            "serving_prefix_hit_tokens_total",
            help="admitted prompt tokens served from the prefix cache")
        self._c_prompt_tokens = reg.counter(
            "serving_prompt_tokens_total",
            help="admitted prompt tokens total")
        # Weight provenance: numeric version gauge plus an info-style
        # gauge whose LABELS carry the digest (the Prometheus idiom for
        # string facts); superseded info series drop to 0 so a scrape
        # shows exactly one live (version, digest) at value 1.
        self._g_weight_version = reg.gauge(
            "serving_weight_version",
            help="monotonic version of the live weights (0 = unversioned "
                 "init)")
        self._last_weight_info: object | None = None
        self._prev_weight_info: object | None = None
        self._g_queue_depth = reg.gauge(
            "serving_queue_depth", help="queued requests")
        self._g_slots_active = reg.gauge(
            "serving_slots_active", help="occupied decode slots")
        self._g_occupancy = reg.gauge(
            "serving_slot_occupancy", help="occupied / total slots")
        # Multi-tenant accounting: lifetime completed/token counters and
        # the per-tenant occupancy gauge, all labeled by tenant through
        # ONE shared cardinality-capping labeler (the engine hands the
        # same instance to its Scheduler, so a tenant is labeled — or
        # folded into "__other__" — consistently across every family).
        from distkeras_tpu_torch.serving.scheduler import TenantLabeler

        self.tenant_labeler = TenantLabeler()
        self._tenant_completed: dict[str, int] = {}
        self._tenant_tokens: dict[str, int] = {}
        self._tenant_active_gauges: dict[str, object] = {}
        # Request kinds (generate / sample / score / embed): per-kind
        # admission counter (bounded label set — the kind vocabulary is
        # fixed), CoW fork block-share counter, and the mask-upload
        # latency of constrained decoding (the host-side cost of every
        # automaton state change; a regression here shows up as
        # inter-token jitter on constrained streams).
        self._kind_counters: dict[str, object] = {}
        self._c_fork_blocks = reg.counter(
            "kv_fork_blocks_total",
            help="extra copy-on-write shares handed out on KV blocks by "
                 "forked sampling (one per block per extra fork row)")
        self._h["mask_upload"] = reg.histogram(
            "mask_upload_seconds",
            help="host→device upload latency of the constrained-decoding "
                 "token mask (per dirty-mask decode dispatch)",
            buckets=_LATENCY_BUCKETS)

    # -- counter compatibility surface (pre-registry attribute names) -------
    @property
    def completed(self) -> int:
        return int(self._c_completed.value)

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def expired(self) -> int:
        return int(self._c_expired.value)

    @property
    def tokens_out(self) -> int:
        return int(self._c_tokens.value)

    # -- per-request events -------------------------------------------------
    def record_admit(self, queue_wait_s: float) -> None:
        """Admission wait: submit to slot grant (TTFT's queueing half)."""
        self.queue_wait.append(queue_wait_s)
        self._h["queue_wait"].observe(queue_wait_s)

    def record_prefill(self, device_s: float, chunks: int,
                       matched_tokens: int | None,
                       prompt_tokens: int) -> None:
        """Prefill completed: device seconds summed over its chunks
        (TTFT's compute half), chunk count, and how much of the prompt
        the prefix cache served (``matched_tokens`` of
        ``prompt_tokens``). ``matched_tokens=None`` means no prefix
        cache is configured — the hit counters stay untouched so
        summaries don't report a 0.0 hit rate for a cache that does not
        exist."""
        self.prefill_device.append(device_s)
        self._h["prefill_device"].observe(device_s)
        self.prefill_chunks.append(chunks)
        self._h["prefill_chunks"].observe(chunks)
        if matched_tokens is not None:
            self._c_prefix_hit_tokens.inc(matched_tokens)
            self._c_prompt_tokens.inc(prompt_tokens)

    def record_first_token(self, ttft_s: float,
                           trace_id: str | None = None) -> None:
        """``trace_id`` becomes the histogram's per-bucket worst-sample
        exemplar: a TTFT p99 spike on the scrape page names the request
        whose flight-recorder timeline explains it."""
        self.ttft.append(ttft_s)
        self._h["ttft"].observe(ttft_s, exemplar=trace_id)
        self._c_tokens.inc()

    def record_inter_token(self, gap_s: float,
                           trace_id: str | None = None) -> None:
        self.inter_token.append(gap_s)
        self._h["inter_token"].observe(gap_s, exemplar=trace_id)
        self._c_tokens.inc()

    def record_finish(self, latency_s: float) -> None:
        self._c_completed.inc()
        self.request_latency.append(latency_s)
        self._h["request_latency"].observe(latency_s)

    def record_reject(self) -> None:
        self._c_rejected.inc()

    def record_expire(self) -> None:
        self._c_expired.inc()

    def set_slo(self, slo_s: float) -> None:
        self._g_slo.set(slo_s)

    def set_weight_version(self, provenance: dict | None) -> None:
        """Publish the live weights' provenance: ``serving_weight_version``
        (numeric) and ``serving_weight_info{version=,digest=} 1`` (the
        digest as a label). The immediately-superseded info series is
        zeroed (the transition is visible on the next scrape); anything
        older is unregistered — a replica on a continuous reload
        cadence must not grow its scrape with one dead series per
        reload."""
        if not provenance:
            return
        version = int(provenance.get("version") or 0)
        self._g_weight_version.set(version)
        info = self.registry.gauge(
            "serving_weight_info",
            help="1 for the live weights' (version, digest); the "
                 "just-superseded series reads 0, older ones are dropped",
            version=str(version),
            digest=str(provenance.get("digest")))
        if self._last_weight_info is not None \
                and self._last_weight_info is not info:
            if self._prev_weight_info is not None \
                    and self._prev_weight_info is not info:
                self.registry.remove(self._prev_weight_info)
            self._last_weight_info.set(0)
            self._prev_weight_info = self._last_weight_info
        info.set(1)
        self._last_weight_info = info

    def record_spec(self, drafted: int, accepted: int,
                    trace_id: str | None = None) -> None:
        """One speculating row's tick: ``drafted`` tokens proposed that
        the row could actually use (spec_k, clamped by its remaining
        budget), ``accepted`` of them committed. ``trace_id`` pins the
        bucket's worst-sample exemplar so an accept-len p~0 bucket
        names a request whose stream the draft model cannot predict."""
        self._c_spec_draft.inc(drafted)
        self._c_spec_accepted.inc(accepted)
        self._h["spec_accept_len"].observe(accepted, exemplar=trace_id)

    @property
    def spec_draft_tokens(self) -> int:
        return int(self._c_spec_draft.value)

    @property
    def spec_accepted_tokens(self) -> int:
        return int(self._c_spec_accepted.value)

    def _tenant_label(self, tenant: str) -> str:
        return self.tenant_labeler(tenant)

    def record_tenant_done(self, tenant: str, tokens: int) -> None:
        """One completed request's per-tenant accounting: request and
        token counters, both as host dicts (healthz rollups) and labeled
        registry counters (metricsz)."""
        label = self._tenant_label(tenant)
        self._tenant_completed[label] = (
            self._tenant_completed.get(label, 0) + 1)
        self._tenant_tokens[label] = (
            self._tenant_tokens.get(label, 0) + int(tokens))
        self.registry.counter(
            "serving_tenant_requests_completed_total",
            help="completed requests per tenant", tenant=label).inc()
        self.registry.counter(
            "serving_tenant_tokens_out_total",
            help="tokens streamed per tenant", tenant=label).inc(
                int(tokens))

    # -- request kinds ------------------------------------------------------
    def record_request_kind(self, kind: str) -> None:
        """One admitted request of ``kind`` — the per-kind traffic
        counter ``serving_requests_total{kind=}``. The label set is the
        fixed kind vocabulary, so cardinality is bounded by
        construction (no labeler needed)."""
        c = self._kind_counters.get(kind)
        if c is None:
            c = self.registry.counter(
                "serving_requests_total",
                help="admitted requests per request kind",
                kind=str(kind))
            self._kind_counters[kind] = c
        c.inc()

    def kind_counters(self) -> dict[str, int]:
        return {k: int(c.value) for k, c in self._kind_counters.items()}

    def record_fork_blocks(self, n: int) -> None:
        """``n`` extra copy-on-write block shares handed out at a fork
        (blocks × (n_forks - 1)) — the block-sharing ratio's numerator
        in serving_bench's fork rows."""
        self._c_fork_blocks.inc(int(n))

    @property
    def fork_blocks(self) -> int:
        return int(self._c_fork_blocks.value)

    def record_mask_upload(self, seconds: float,
                           trace_id: str | None = None) -> None:
        """One dirty-mask host→device upload before a constrained decode
        dispatch; the exemplar names the constrained stream that paid a
        slow upload."""
        self._h["mask_upload"].observe(seconds, exemplar=trace_id)

    def tenant_counters(self) -> dict[str, dict]:
        return {t: {"completed": self._tenant_completed.get(t, 0),
                    "tokens_out": self._tenant_tokens.get(t, 0)}
                for t in self._tenant_completed}

    def set_tenant_active(self, active: dict[str, int]) -> None:
        """Refresh the per-tenant occupancy gauges; tenants that dropped
        to zero active slots read 0 (their series stays, bounded by the
        label cap) so a scrape sees the release, not a stale high.
        Counts aggregate per LABEL (over-cap tenants share
        ``__other__``) so the folded series reports the sum, not one
        arbitrary tenant's value."""
        by_label: dict[str, int] = {}
        for tenant, n in active.items():
            label = self._tenant_label(tenant)
            by_label[label] = by_label.get(label, 0) + int(n)
        for label, gauge in self._tenant_active_gauges.items():
            if label not in by_label:
                gauge.set(0)
        for label, n in by_label.items():
            g = self._tenant_active_gauges.get(label)
            if g is None:
                g = self.registry.gauge(
                    "serving_tenant_slots_active",
                    help="occupied decode slots per tenant",
                    tenant=label)
                self._tenant_active_gauges[label] = g
            g.set(n)

    def record_slo_violation(self) -> None:
        self._c_slo_violations.inc()

    @property
    def slo_violations(self) -> int:
        return int(self._c_slo_violations.value)

    def record_preemption(self) -> None:
        """A decode slot was evicted for KV blocks and its request
        requeued (paged oversubscription doing its job — frequent
        preemption means the pool is undersized for the offered load)."""
        self._c_preemptions.inc()

    def record_oom_reject(self) -> None:
        self._c_oom_rejections.inc()

    def record_kv_migration(self, nbytes: int, latency_s: float,
                            trace_id: str | None = None) -> None:
        """One adopted KV block migration: bytes moved + pull-to-adopt
        latency, exemplar'd with the request it served."""
        self._c_kv_migrations.inc()
        self._c_kv_migration_bytes.inc(int(nbytes))
        self._h["kv_migration"].observe(latency_s, exemplar=trace_id)

    def record_kv_migration_fallback(self) -> None:
        self._c_kv_migration_fallbacks.inc()

    def record_kv_export(self, nbytes: int) -> None:
        self._c_kv_exports.inc()

    def record_kv_spill(self, nbytes: int, latency_s: float,
                        trace_id: str | None = None) -> None:
        """One trie eviction victim spilled into the host tier."""
        self._c_kv_spills.inc()
        self._c_kv_spill_bytes.inc(int(nbytes))
        self._h["kv_spill"].observe(latency_s, exemplar=trace_id)

    def record_kv_readmit(self, blocks: int, nbytes: int, latency_s: float,
                          trace_id: str | None = None) -> None:
        """One admission-time re-admission burst from the host tier."""
        self._c_kv_readmits.inc(int(blocks))
        self._c_kv_readmit_bytes.inc(int(nbytes))
        self._h["kv_readmit"].observe(latency_s, exemplar=trace_id)

    def record_kv_push(self, nbytes: int, latency_s: float,
                       trace_id: str | None = None) -> None:
        """One KV chain pushed to a peer and adopted there."""
        self._c_kv_pushes.inc()
        self._c_kv_push_bytes.inc(int(nbytes))
        self._h["kv_push"].observe(latency_s, exemplar=trace_id)

    def record_kv_push_fallback(self) -> None:
        self._c_kv_push_fallbacks.inc()

    def set_kv_tier_resident_bytes(self, nbytes: int) -> None:
        self._g_kv_tier_resident.set(int(nbytes))

    @property
    def kv_migrations(self) -> int:
        return int(self._c_kv_migrations.value)

    @property
    def kv_migration_fallbacks(self) -> int:
        return int(self._c_kv_migration_fallbacks.value)

    @property
    def kv_migration_bytes(self) -> int:
        return int(self._c_kv_migration_bytes.value)

    @property
    def kv_exports(self) -> int:
        return int(self._c_kv_exports.value)

    @property
    def kv_spills(self) -> int:
        return int(self._c_kv_spills.value)

    @property
    def kv_spill_bytes(self) -> int:
        return int(self._c_kv_spill_bytes.value)

    @property
    def kv_readmits(self) -> int:
        return int(self._c_kv_readmits.value)

    @property
    def kv_readmit_bytes(self) -> int:
        return int(self._c_kv_readmit_bytes.value)

    @property
    def kv_pushes(self) -> int:
        return int(self._c_kv_pushes.value)

    @property
    def kv_push_bytes(self) -> int:
        return int(self._c_kv_push_bytes.value)

    @property
    def kv_push_fallbacks(self) -> int:
        return int(self._c_kv_push_fallbacks.value)

    @property
    def preemptions(self) -> int:
        return int(self._c_preemptions.value)

    @property
    def oom_rejections(self) -> int:
        return int(self._c_oom_rejections.value)

    @property
    def iterations(self) -> int:
        """Decode-loop iterations sampled so far (per-request timeline
        records diff this around a request's lifetime)."""
        return self._iterations

    # -- per-iteration sampling --------------------------------------------
    def sample(self, queue_depth: int, slots_active: int, slots_total: int) -> None:
        """Call once per decode iteration; emits one stream record."""
        self._iterations += 1
        self._c_iterations.inc()
        occ = slots_active / max(1, slots_total)
        self._occupancy.append(occ)
        self._queue_depth.append(queue_depth)
        self._g_queue_depth.set(queue_depth)
        self._g_slots_active.set(slots_active)
        self._g_occupancy.set(occ)
        if self.stream is not None:
            self.stream.emit(self._iterations, {
                "queue_depth": queue_depth,
                "slots_active": slots_active,
                "slot_occupancy": occ,
                "tokens_out": self.tokens_out,
                "completed": self.completed,
                "rejected": self.rejected,
                "expired": self.expired,
            })

    # -- rollup -------------------------------------------------------------
    def summary(self) -> dict[str, float]:
        """Percentile rollup (``StepTimer.summary`` key conventions)."""
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        out: dict[str, float] = {
            "requests_completed": float(self.completed),
            "requests_rejected": float(self.rejected),
            "requests_expired": float(self.expired),
            "tokens_out": float(self.tokens_out),
            "tokens_per_sec": self.tokens_out / elapsed,
            "elapsed_s": elapsed,
            "decode_iterations": float(self._iterations),
        }
        if self._g_slo.value:
            out["slo_violations"] = float(self.slo_violations)
        if self.preemptions or self.oom_rejections:
            out["kv_preemptions"] = float(self.preemptions)
            out["kv_oom_rejections"] = float(self.oom_rejections)
        for name, xs in (
            ("ttft", self.ttft),
            ("inter_token", self.inter_token),
            ("queue_wait", self.queue_wait),
            ("prefill_device", self.prefill_device),
            ("request_latency", self.request_latency),
        ):
            if xs:
                out[f"{name}_p50_s"] = percentile(xs, 50)
                out[f"{name}_p95_s"] = percentile(xs, 95)
                out[f"{name}_p99_s"] = percentile(xs, 99)
                out[f"{name}_mean_s"] = sum(xs) / len(xs)
        out.update(self.host_gap.summary())
        out.update(self.bubble.summary())
        if self.prefill_chunks:
            out["prefill_chunks_mean"] = (
                sum(self.prefill_chunks) / len(self.prefill_chunks))
            out["prefill_chunks_max"] = float(max(self.prefill_chunks))
        if self._c_prompt_tokens.value:
            out["prefix_hit_rate"] = (
                self._c_prefix_hit_tokens.value / self._c_prompt_tokens.value)
        if self.kv_spills or self.kv_readmits:
            out["kv_spills"] = float(self.kv_spills)
            out["kv_spill_bytes"] = float(self.kv_spill_bytes)
            out["kv_readmits"] = float(self.kv_readmits)
            out["kv_readmit_bytes"] = float(self.kv_readmit_bytes)
            if self._h["kv_spill"].count:
                out["kv_spill_latency_p99_s"] = (
                    self._h["kv_spill"].percentile(99))
            if self._h["kv_readmit"].count:
                out["kv_readmit_latency_p99_s"] = (
                    self._h["kv_readmit"].percentile(99))
        for kind, n in self.kind_counters().items():
            out[f"requests_kind_{kind}"] = float(n)
        if self.fork_blocks:
            out["kv_fork_blocks"] = float(self.fork_blocks)
        if self._h["mask_upload"].count:
            out["mask_upload_count"] = float(self._h["mask_upload"].count)
            out["mask_upload_mean_s"] = float(self._h["mask_upload"].mean)
            out["mask_upload_p99_s"] = self._h["mask_upload"].percentile(99)
        if self._c_spec_draft.value:
            out["spec_draft_tokens"] = float(self.spec_draft_tokens)
            out["spec_accepted_tokens"] = float(self.spec_accepted_tokens)
            out["spec_accept_rate"] = (
                self.spec_accepted_tokens / self.spec_draft_tokens)
        if self._occupancy:
            out["slot_occupancy_mean"] = (
                sum(self._occupancy) / len(self._occupancy)
            )
            out["queue_depth_max"] = float(max(self._queue_depth))
        return out

    def emit_summary(self, step: int = -1) -> dict[str, float]:
        """Emit the rollup through the stream (step -1 marks a summary
        record among the per-iteration series) and return it."""
        s = self.summary()
        if self.stream is not None:
            self.stream.emit(step, {"summary": 1.0, **s})
        return s
