"""Continuous-batching decode engine: one decode step, rotating slots.

Port of the dense engine of the reference's
``distkeras_tpu/serving/engine.py``. The offline path
(:func:`distkeras_tpu_torch.inference.generate.generate`) decodes a
*closed* batch: every row starts together and the whole batch runs
``max_new_tokens`` steps. An online server cannot do that: requests arrive
whenever they arrive, and draining the batch to admit one request wastes
every other slot's compute.

This engine keeps the shape discipline of the offline path (static
``[slots, max_seq_len, H, D]`` KV caches, ONE decode step of one abstract
signature for the lifetime of the server) while making the batch *open*:

- each of the ``slots`` rows of the decode batch is an independent
  request at its **own** sequence position (``BertConfig.decode_slots``
  turns the cache and positional indices into per-row vectors);
- a finished request frees its row; a queued request is admitted between
  decode iterations by a **prefill** on a single-row cache, padded to a
  power-of-two bucket of the prompt, whose cache is then written into the
  live batch cache's row (``_admit_fn``): the decode step never changes
  shape and never stops for admission;
- with a **prefix cache** (``prefix_cache_mb``), the prompt's longest
  cached block-chain prefix is copied from a device-resident pool
  (:mod:`distkeras_tpu_torch.serving.prefix_cache`) instead of
  recomputed: only the uncached tail runs through the prefill;
- with **chunked prefill** (``prefill_chunk``), that tail is split into
  fixed-size chunks and ONE chunk runs per engine iteration, interleaved
  with decode ticks, so admitting a long prompt never stalls the decode
  batch for more than one chunk's device time;
- free rows keep decoding garbage (their output is discarded): the cost
  of a fixed-shape batch.

Per-request sampling: ``temperature <= 0`` rows take
:func:`~distkeras_tpu_torch.inference.generate.greedy_ids` inside the same
step as sampled rows (a ``torch.where`` select), so greedy and sampled
requests share one batch. Sampling draws from a ``torch.Generator`` on the
device that the engine owns, seeded from ``seed``; ``top_k`` is
engine-wide.

**Overlapped decode pipeline** (``pipeline_depth=1``, the default): the
run loop dispatches tick N+1 *before* consuming tick N's tokens. CUDA
launches are asynchronous, so the only point the host waits for the
device is the one D2H of each tick's ``[slots]`` token vector (the
**harvest**); a CUDA event recorded after each dispatch tells whether the
tick has finished (``_tick_ready``). Each decode tick writes new tensors
(the cache's scatters are out of place, the tokens are a new vector), so
tick N's tokens are never overwritten by tick N+1 while the host has yet
to read them. A **pipeline barrier** (harvest, stream and teardown of the
in-flight tick) runs before every event that changes the batch's shape or
content: admission, chunked-prefill progress, cancel and expiry teardown,
idle and exit. Greedy output is token-identical to ``pipeline_depth=0``.

Device work runs in three places: the first decode dispatch and every
prefill in the event loop's executor (a thread), warm decode dispatches
inline on the loop thread. Grad mode is per thread, so every function
that touches the model enters ``torch.inference_mode()`` itself, and all
of them queue on the device's current stream, which threads share.

What the reference has and this engine refuses, each naming its ROADMAP
item: paged KV, its host and disk tiers, speculative decoding, constrained
decoding and the parameter swap (A7b); the KV export and import of the
fleet (A8); a device mesh and ``pipeline_depth > 1`` (A10). No step is a
CUDA graph: a warm decode dispatch is a full eager step on the loop
thread. ``HostGapTracker`` stamps a tick's dispatch before its launches,
so ``serving_device_idle_ratio`` counts the gaps between ticks; inside an
eager tick the device also idles between launches, which only a profiler
sees.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import dataclasses
import functools
import os
import time

import numpy as np
import torch

from distkeras_tpu_torch.inference.generate import (
    _check_context,
    _context_limit,
    _decode_module,
    cache_with_index,
    sample_rows,
)
from distkeras_tpu_torch.models.bert import decode_cache
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.prefix_cache import PrefixCache
from distkeras_tpu_torch.serving.scheduler import (
    REQUEST_KINDS,
    EngineStopped,
    Request,
    RequestCancelled,
    RequestTimeout,
    Scheduler,
    ServingError,
)
from distkeras_tpu_torch.telemetry.flight_recorder import FlightRecorder
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from distkeras_tpu_torch.telemetry.request_trace import TimelineRecord, TraceStore
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.telemetry.wide_events import WideEventStore
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["ServingEngine"]

_A7B = "ROADMAP.md §A item A7b"


@torch.inference_mode()
def _prefill_fn(module, top_k, gen, params, cache, padded, start, true_len, temp):
    """Run a right-padded ``[1, P]`` prompt *chunk* through the decode
    module at cache offset ``start``, extending the slot's single-row KV
    cache and sampling the token that follows the chunk (reference
    ``_prefill_fn``).

    Padding is benign: causal attention means real positions never see the
    pad tail, the sampled token comes from the logits at ``true_len - 1``,
    and the garbage K/V at ``[start + true_len, start + P)`` is masked out
    of every later step until overwritten by real tokens. The index leaves
    are set to ``start`` on entry and rewound to ``start + true_len`` on
    exit, so the next chunk (or decode) resumes at the real end."""
    cache = cache_with_index(cache, start)
    logits, cache = module.apply({**params, **cache}, padded)
    cache = cache_with_index(cache, start + true_len)
    last = logits[0, true_len - 1][None]  # [1, V]
    tok = sample_rows(last, temp[None], gen, top_k)[0]
    return cache, tok


@torch.inference_mode()
def _admit_fn(cache, tokens, temps, slot, pre_cache, first_tok, temp):
    """Write a prefilled single-row cache into batch row ``slot`` (the
    reference's leading-axis ``dynamic_update_slice``). Runs only after a
    pipeline barrier, when no dispatched tick still reads the batch cache,
    so the cache rows are written in place; the token and temperature
    vectors are new tensors."""
    for name, big in cache.items():
        big[slot] = pre_cache[name][0].to(big.dtype)
    tokens = tokens.clone()
    tokens[slot] = first_tok
    temps = temps.clone()
    temps[slot] = temp
    return cache, tokens, temps


@torch.inference_mode()
def _decode_fn(module, top_k, gen, params, cache, tokens, temps):
    """ONE decode iteration for the whole slot batch ``[B] -> [B]``."""
    logits, cache = module.apply({**params, **cache}, tokens[:, None])
    nxt = sample_rows(logits[:, -1], temps, gen, top_k)
    return cache, nxt


def _sign_prefill(args, kwargs):
    # (params, cache, padded, start, true_len, temp): start and true_len
    # are the reference's traced scalars, one program for every value.
    return args[1], args[2], args[5]


def _sign_admit(args, kwargs):
    # (cache, tokens, temps, slot, pre_cache, first_tok, temp): slot is a
    # traced scalar in the reference.
    return args[0], args[1], args[2], args[4], args[5], args[6]


def _sign_decode(args, kwargs):
    # (params, cache, tokens, temps): the params are fixed for the
    # engine's life (no swap in the dense engine), so they are left out of
    # the per-tick signature.
    return args[1:]


@dataclasses.dataclass
class _PrefillJob:
    """Partial-prefill progress for a slot still being admitted: the
    single-row cache under construction, how far into the prompt it is
    (prefix-cache splice included), and the pinned match to release."""

    cache: object                 # single-row KV cache
    pos: int                      # prompt tokens already in the cache
    match: object | None          # PrefixMatch to release on completion
    matched_tokens: int
    chunks_done: int = 0
    device_s: float = 0.0         # prefill device time (TTFT's other half)


def _tick_ready(tick) -> bool:
    """True when the tick's token vector has materialized on the device
    (the CUDA event recorded after its dispatch has completed): the
    harvest is then a plain copy, cheaper run inline than through an
    executor round trip. CPU work is synchronous, so a CPU tick is always
    ready."""
    ready = tick.ready
    return True if ready is None else bool(ready.query())


@dataclasses.dataclass
class _InflightTick:
    """A dispatched-but-unharvested decode tick: the device token vector
    the harvest will read, the CUDA event that marks it done, and the
    decodable rows the dispatch covered (a row streams iff it was
    decodable AT DISPATCH and its slot is still alive)."""

    kind: str                     # "decode"
    rows: tuple                   # decodable slots at dispatch
    t_dispatch: float
    tokens: object = None         # device token vector to harvest
    ready: object = None          # CUDA event recorded after the dispatch


def _public_provenance(provenance: dict | None) -> dict:
    """The client-facing face of a weights stamp: version + digest ONLY
    (never the server-side file path)."""
    if not provenance:
        return {"version": 0, "digest": None}
    return {"version": int(provenance.get("version") or 0),
            "digest": provenance.get("digest")}


@dataclasses.dataclass
class _SlotState:
    request: Request
    remaining: int  # tokens still to decode after the prefill token
    last_token_t: float
    # Non-None while the slot's prompt is still prefilling (chunked
    # admission): the row sits in the decode batch but its garbage output
    # is discarded until the finished cache is written in.
    prefill: _PrefillJob | None = None
    t_admit: float = 0.0


def _memory_rows(device: torch.device, registry, params_bytes: int) -> list[dict]:
    """The reference's ``publish_memory_gauges`` for one torch device:
    ``device_memory_stats_available`` always, the byte gauges only where
    the device reports them (CUDA; the CPU is the typed "no data"
    sentinel, never a fake 0), and ``model_params_bytes``."""
    name = f"{device.type}:{device.index or 0}"
    row = {"device": name, "available": device.type == "cuda",
           "bytes_in_use": None, "bytes_limit": None, "peak_bytes_in_use": None}
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        row.update(bytes_in_use=int(torch.cuda.memory_allocated(device)),
                   bytes_limit=int(total),
                   peak_bytes_in_use=int(torch.cuda.max_memory_allocated(device)))
        row["headroom_bytes"] = int(free)
    registry.gauge(
        "device_memory_stats_available",
        help="1 when the backend publishes memory stats for this device; "
             "0 = no data (byte gauges absent, not zero)",
        device=name).set(1.0 if row["available"] else 0.0)
    for key, metric, help_ in (
            ("bytes_in_use", "device_bytes_in_use", "live device bytes in use"),
            ("bytes_limit", "device_bytes_limit", "device memory capacity"),
            ("peak_bytes_in_use", "device_peak_bytes_in_use", "high-water device bytes"),
            ("headroom_bytes", "device_memory_headroom_bytes", "free device bytes")):
        if row.get(key) is not None:
            registry.gauge(metric, help=help_, device=name).set(row[key])
    registry.gauge("model_params_bytes",
                   help="bytes of the live model parameters").set(params_bytes)
    return [row]


class ServingEngine:
    """Fixed-slot continuous-batching server core (reference
    ``ServingEngine``, dense mode).

    ``model``/``variables``: a causal LM from the zoo (gpt_tiny/gpt_small)
    and its weights, the same pair :func:`generate` takes; the weights
    move to ``device`` (CUDA unless ``"cpu"`` is asked for; without a card
    and without ``"cpu"`` the engine raises, as ``generate()`` does).
    ``slots``: decode batch width. ``max_queue``: admission backpressure
    depth (:class:`QueueFullError` beyond it). ``top_k``: engine-wide top-k
    sampling (None = full vocab).

    ``prefill_chunk``: split each prompt's (uncached) prefill into chunks
    of this many tokens, ONE chunk per engine iteration (round-robin across
    admitting slots) interleaved with decode ticks. None (default) keeps
    monolithic admission. Greedy output is token-identical either way.

    ``prefix_cache_mb``: > 0 enables the device-resident prefix cache under
    that byte budget, with ``prefix_block_tokens``-token blocks; the
    scheduler then prefers cache-hitting requests within a priority class.
    Pass ``prefix_cache=`` to inject a pre-built pool. The cache is NOT
    thread-safe: one engine's loop drives it.

    ``max_context``: cap each request's context (prompt + new tokens)
    below the model's trained length; the per-slot cache shrinks to it.

    ``auditor``: a :class:`RecompileAuditor` wrapping the prefill, admit
    and decode callables (``serving_prefill``, ``serving_admit``,
    ``serving_decode``); with ``arm_auditor_after_warmup`` the decode step
    is armed after its first iteration, so a later change of its abstract
    signature raises :class:`RecompileError` at the call.

    Observability, as the reference's: ``trace_store``,
    ``flight_recorder``, ``wide_events`` (a capacity or a store; default
    4096), ``slo_s``; tenant weights and quotas through the scheduler.

    The reference's paged, tiered, speculative, constrained and sharded
    options raise naming their ROADMAP item (:meth:`_refuse_deferred`);
    ``kv_block_tokens``, ``kv_tier_watermark`` and ``spec_k`` only tune
    those and are accepted unused, as the reference's dense engine
    accepts them.

    Drive it with :meth:`submit` + :meth:`run` (asyncio).
    """

    def __init__(
        self,
        model,
        variables,
        *,
        slots: int = 4,
        max_queue: int = 64,
        top_k: int | None = None,
        metrics: ServingMetrics | None = None,
        seed: int = 0,
        min_prefill_bucket: int = 8,
        auditor: RecompileAuditor | None = None,
        arm_auditor_after_warmup: bool = False,
        prefill_chunk: int | None = None,
        prefix_cache_mb: float = 0.0,
        prefix_block_tokens: int = 16,
        prefix_cache: PrefixCache | None = None,
        paged: bool = False,
        kv_pool_mb: float = 0.0,
        kv_block_tokens: int = 16,
        kv_pool_blocks: int | None = None,
        kv_host_tier_mb: float = 0.0,
        kv_disk_tier_dir: str | None = None,
        kv_disk_tier_mb: float = 0.0,
        kv_tier_watermark: float = 0.8,
        max_context: int | None = None,
        draft_model=None,
        draft_variables=None,
        spec_k: int = 4,
        mesh=None,
        pipeline_depth: int = 1,
        trace_store: TraceStore | None = None,
        flight_recorder: FlightRecorder | None = None,
        wide_events: "WideEventStore | int | None" = 4096,
        slo_s: float | None = None,
        weight_version: dict | None = None,
        tenant_weights: dict | None = None,
        tenant_quotas: dict | None = None,
        quota_burst_s: float = 2.0,
        constrained: bool = False,
        device: str | torch.device | None = None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None, got {prefill_chunk}")
        if int(pipeline_depth) != pipeline_depth or pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be a non-negative int: 0 (serialized "
                f"dispatch+harvest), 1 (dispatch tick N+1 before consuming "
                f"tick N), or >1 (micro-batched ticks overlapping pipeline "
                f"stages; needs a pp mesh), got {pipeline_depth}")
        self._refuse_deferred(
            paged=paged, kv_pool_mb=kv_pool_mb, kv_pool_blocks=kv_pool_blocks,
            kv_host_tier_mb=kv_host_tier_mb, kv_disk_tier_dir=kv_disk_tier_dir,
            kv_disk_tier_mb=kv_disk_tier_mb, draft_model=draft_model,
            draft_variables=draft_variables, mesh=mesh,
            pipeline_depth=pipeline_depth, constrained=constrained)
        self.pipeline_depth = int(pipeline_depth)
        # Dispatched-but-unharvested ticks, oldest first (at most one), and
        # a bounded dispatch->harvest timeline (the tracez tick lane).
        self._inflight: collections.deque = collections.deque()
        self._tick_log: collections.deque = collections.deque(maxlen=256)
        # False until the first decode dispatch has run: it goes through
        # the executor (the first call builds cuBLAS handles and loads
        # kernels), every later one runs inline on the loop thread.
        self._dispatch_warm = False
        self.model = model
        self.device = resolve_device(device)
        _, base_cfg = _decode_module(model, slots=True)
        base_limit = _context_limit(model, base_cfg)
        if max_context is not None:
            if not 1 <= max_context <= base_limit:
                raise ValueError(
                    f"max_context={max_context} outside [1, trained "
                    f"context {base_limit}]")
            self.limit = int(max_context)
        else:
            self.limit = base_limit
        dense_len = (int(max_context) if max_context is not None
                     else base_cfg.max_seq_len)
        overrides = {}
        if max_context is not None:
            overrides["decode_cache_len"] = dense_len
        self._module, self._cfg = _decode_module(model, slots=True, **overrides)
        # Prefill pad-width bound: the request context.
        self._cache_len = dense_len
        if top_k is not None and not 1 <= top_k <= self._cfg.vocab_size:
            raise ValueError(
                f"top_k={top_k} outside [1, vocab_size={self._cfg.vocab_size}]"
            )
        dev = self.device
        # Device-resident params from the start (one transfer at
        # construction).
        self._params = {k: v.to(dev) for k, v in variables.items()}
        self.slots = int(slots)
        self.metrics = metrics or ServingMetrics()
        self.scheduler = Scheduler(
            max_depth=max_queue,
            registry=self.metrics.registry,
            tenant_weights=tenant_weights,
            tenant_quotas=tenant_quotas,
            quota_burst_s=quota_burst_s,
            # ONE labeler across the scheduler's and the metrics' tenant
            # families.
            tenant_labeler=getattr(self.metrics, "tenant_labeler", None))
        self._min_bucket = int(min_prefill_bucket)
        self._chunk = None if prefill_chunk is None else int(prefill_chunk)
        self._prefill_rr = 0  # round-robin cursor over prefilling slots
        # The sampling generator, on the device; every prefill and decode
        # tick draws from it in the loop's order.
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))

        # Device-resident batch state: the [slots, L, H, D] per-slot
        # caches, the last token of each row and its temperature.
        with torch.inference_mode():
            self._cache = decode_cache(self._cfg, self.slots, dev)
            self._tokens = torch.zeros((self.slots,), dtype=torch.int32, device=dev)
            self._temps = torch.zeros((self.slots,), dtype=torch.float32, device=dev)
        self._slot_state: list[_SlotState | None] = [None] * self.slots
        # Single-row cache geometry, as meta tensors (the reference's
        # eval_shape structs).
        self._row_shapes = decode_cache(self._cfg, 1, "meta")

        if prefix_cache is not None:
            self.prefix_cache = prefix_cache
        elif prefix_cache_mb > 0:
            self.prefix_cache = PrefixCache(
                self._row_shapes, block_tokens=prefix_block_tokens,
                budget_bytes=int(prefix_cache_mb * 2**20),
                registry=self.metrics.registry, device=dev)
        else:
            self.prefix_cache = None
        if self.prefix_cache is not None:
            # Cache-aware admission: the scheduler may prefer (within one
            # priority class, bounded window) the queued request whose
            # prefix is already resident.
            self.scheduler.cache_probe = self.prefix_cache.probe

        self._prefill = functools.partial(_prefill_fn, self._module, top_k, self._gen)
        self._admit = _admit_fn
        self._decode_step = functools.partial(_decode_fn, self._module, top_k, self._gen)

        # Recompile auditing: the one-signature decode invariant as a
        # runtime check. Without a caller's auditor the decode step is
        # still signed by a private one, which decode_compile_count reads.
        self.auditor = auditor
        self._arm_after_warmup = bool(arm_auditor_after_warmup)
        counter = auditor if auditor is not None else RecompileAuditor()
        self._counting_auditor = counter
        if auditor is not None:
            self._prefill = auditor.wrap(self._prefill, "serving_prefill",
                                         signature=_sign_prefill)
            self._admit = auditor.wrap(self._admit, "serving_admit",
                                       signature=_sign_admit)
        self._decode_step = counter.wrap(self._decode_step, "serving_decode",
                                         signature=_sign_decode)

        # Request tracing + flight recording: timelines are built only
        # when at least one sink exists.
        self.trace_store = trace_store
        self.flight_recorder = flight_recorder
        self.trace_source = (flight_recorder.source
                             if flight_recorder is not None
                             else f"pid:{os.getpid()}")
        self.serve_role = "monolithic"
        self.slo_s = None if slo_s is None else float(slo_s)
        self._trace_requests = (trace_store is not None
                                or flight_recorder is not None)
        # Wide-event analytics: one flat record per FINISHED request.
        if isinstance(wide_events, WideEventStore):
            self.wide_events: WideEventStore | None = wide_events
        elif wide_events:
            self.wide_events = WideEventStore(int(wide_events))
        else:
            self.wide_events = None
        if (flight_recorder is not None
                and getattr(flight_recorder, "wide_events", None) is None):
            flight_recorder.wide_events = self.wide_events
        if self.slo_s is not None:
            self.metrics.set_slo(self.slo_s)

        self.weight_version = _public_provenance(weight_version)
        self.metrics.set_weight_version(self.weight_version)
        self._params_bytes = sum(v.numel() * v.element_size()
                                 for v in self._params.values())

        self._running = False
        self._stopping = False
        self._draining = True
        # Fault-injection knob (the ``inject_latency`` control verb): a
        # host-side sleep per decode iteration.
        self.inject_decode_delay_s = 0.0

    @staticmethod
    def _refuse_deferred(*, paged, kv_pool_mb, kv_pool_blocks, kv_host_tier_mb,
                         kv_disk_tier_dir, kv_disk_tier_mb, draft_model,
                         draft_variables, mesh, pipeline_depth, constrained) -> None:
        """Options of the reference's engine that this port does not have
        yet raise here, each naming its ROADMAP item."""
        if constrained and not (paged or kv_pool_mb > 0 or kv_pool_blocks):
            raise ValueError(
                "constrained=True requires paged KV (kv_pool_mb / kv_pool_blocks): "
                f"the token-mask hook lives in the paged decode step, and paged KV "
                f"is not ported yet ({_A7B})")
        paged_opts = [name for name, on in (
            ("paged", paged), ("kv_pool_mb", kv_pool_mb > 0),
            ("kv_pool_blocks", kv_pool_blocks),
            ("kv_host_tier_mb", kv_host_tier_mb > 0),
            ("kv_disk_tier_dir", kv_disk_tier_dir),
            ("kv_disk_tier_mb", kv_disk_tier_mb > 0)) if on]
        if paged_opts:
            raise NotImplementedError(
                f"paged KV and its tiers ({', '.join(paged_opts)}) are not ported "
                f"yet: they come with {_A7B}")
        if draft_model is not None or draft_variables is not None:
            raise NotImplementedError(
                f"speculative decoding (draft_model) is not ported yet: it comes "
                f"with {_A7B}")
        if mesh is not None:
            raise NotImplementedError(
                "a serving mesh (tensor- or pipeline-parallel serving) is not "
                "ported yet: it comes with the multi-device slice (ROADMAP.md §A "
                "item A10)")
        if pipeline_depth > 1:
            raise ValueError(
                f"pipeline_depth={pipeline_depth} needs a pp>=2 serving mesh "
                f"(micro-batched ticks only overlap across pipeline stages; "
                f"--mesh-shape tp=N,pp=M), which is not ported yet (ROADMAP.md "
                f"§A item A10)")

    def decode_compile_count(self) -> int:
        """Number of abstract signatures the decode step has seen (must
        stay 1: admission must never change the decode step's shapes).
        Read from the caller's auditor, or the engine's private one."""
        return self._counting_auditor.compiles("serving_decode")

    def tick_timeline(self, n: int | None = None) -> list[dict]:
        """The bounded dispatch→harvest tick lane (most recent last): per
        tick, its dispatch/harvest stamps, how long the harvest blocked on
        the device, and the measured host gap."""
        log = list(self._tick_log)
        return log if n is None else log[-int(n):]

    def refresh_memory_metrics(self) -> list[dict]:
        """Publish the device's memory gauges (``torch.cuda``'s allocator
        on the card; the typed "no data" sentinel on the CPU) and this
        engine's parameter bytes; return the per-device rows for healthz.
        Host-only, called per metricsz/healthz scrape."""
        try:
            return _memory_rows(self.device, self.metrics.registry, self._params_bytes)
        except Exception:
            return []

    def tenant_snapshot(self) -> dict:
        """Per-tenant QoS rollup for healthz/debugz (refreshing the
        labeled tenant gauges on the way)."""
        active: dict[str, int] = {}
        for st in self._slot_state:
            if st is not None:
                t = st.request.tenant
                active[t] = active.get(t, 0) + 1
        out = self.scheduler.tenant_stats()
        for tenant, n in active.items():
            out.setdefault(tenant, {"queued": 0})["active_slots"] = n
        for tenant, counts in self.metrics.tenant_counters().items():
            out.setdefault(tenant, {"queued": 0}).update(counts)
        self.metrics.set_tenant_active(active)
        return out

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slot_state if s is not None)

    @property
    def free_slots(self) -> int:
        return self.slots - self.active_slots

    def debugz(self) -> dict:
        """Live state snapshot for the ``debugz`` control verb: the slot
        table (per-slot phase, trace_id, sequence depth, age), the
        scheduler queue, prefix-cache trie occupancy, and flight-recorder
        and SLO status. JSON-safe."""
        now = time.monotonic()
        slots = []
        for i, st in enumerate(self._slot_state):
            if st is None:
                slots.append({"slot": i, "state": "free"})
                continue
            req = st.request
            entry = {
                "slot": i,
                "state": "prefill" if st.prefill is not None else "decode",
                "kind": req.kind,
                "trace_id": req.trace_id,
                "tenant": req.tenant,
                "depth": len(req.prompt) + len(req.out_tokens),
                "remaining": st.remaining,
                "age_s": (round(now - req.t_submit, 6)
                          if req.t_submit is not None else None),
            }
            if st.prefill is not None:
                entry["prefill"] = {
                    "pos": st.prefill.pos,
                    "prompt_tokens": len(req.prompt),
                    "chunks_done": st.prefill.chunks_done,
                }
            slots.append(entry)
        out = {
            "slots": slots,
            "active_slots": self.active_slots,
            "queue": self.scheduler.debugz(now),
            "tenants": self.tenant_snapshot(),
            "stopping": self._stopping,
            "pending_swap": False,  # the dense engine has no swap (A7b)
            "decode_compile_count": self.decode_compile_count(),
            "weight_version": self.weight_version,
            "request_kinds": self.metrics.kind_counters(),
            "pipeline": {
                "depth": self.pipeline_depth,
                "inflight": (self._inflight[-1].kind
                             if self._inflight else None),
                "inflight_ticks": len(self._inflight),
                "ticks_logged": len(self._tick_log),
                "host_gap_p50_s": self.metrics.host_gap.gap_p50,
                "device_idle_ratio": self.metrics.host_gap.idle_ratio,
            },
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.debugz()
        if self.flight_recorder is not None:
            out["flight_recorder"] = self.flight_recorder.stats()
        if self.trace_store is not None:
            out["trace_store"] = self.trace_store.stats()
        if self.slo_s is not None:
            out["slo_s"] = self.slo_s
        return out

    # -- submission ---------------------------------------------------------
    def _build_request(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        priority: int = 0,
        timeout: float | None = None,
        trace_id: str | None = None,
        speculate: bool = True,
        tenant: str = "default",
        resume_tokens=None,
        kind: str = "generate",
        n: int = 1,
        constraint=None,
    ) -> Request:
        """Validation half of submission, shared by :meth:`submit` and
        :meth:`submit_many`: everything that can reject a request typed
        BEFORE it touches the scheduler. ``resume_tokens``: output tokens
        the client already received elsewhere; they pre-seed
        ``out_tokens``, so the prefill covers prompt + resume and the first
        sampled token continues the stream."""
        if self._stopping:
            raise EngineStopped("engine is shutting down; not admitting")
        kind = str(kind or "generate")
        n = int(n or 1)
        if kind not in REQUEST_KINDS:
            raise ValueError(
                f"unknown request kind {kind!r}; expected one of "
                f"{REQUEST_KINDS}")
        if kind != "generate":
            # The reference's own refusal on a dense engine; the paged
            # engine that serves these kinds is ROADMAP item A7b.
            raise ValueError(
                f"kind={kind!r} requires a paged single-stage engine "
                f"(kv_pool_mb / kv_pool_blocks, pp=1)")
        if n != 1:
            raise ValueError(f"n={n} requires kind='sample'")
        if constraint is not None:
            raise ValueError(
                "this engine was not built with constrained=True; "
                "token-mask constraints are unavailable")
        prompt_arr = np.asarray(prompt, np.int32)
        if prompt_arr.ndim == 2 and prompt_arr.shape[0] == 1:
            prompt_arr = prompt_arr[0]
        if prompt_arr.ndim != 1 or prompt_arr.size < 1:
            raise ValueError(f"prompt must be a non-empty 1-D token list; "
                             f"got shape {prompt_arr.shape}")
        _check_context(self.model, self._cfg, prompt_arr[None, :], max_new_tokens)
        if prompt_arr.size + max_new_tokens > self.limit:
            raise ValueError(
                f"prompt ({prompt_arr.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds this engine's context cap "
                f"{self.limit} (max_context)")
        req = Request(
            prompt_arr.tolist(), max_new_tokens, temperature=temperature,
            priority=priority, timeout=timeout, trace_id=trace_id,
            speculate=speculate, tenant=tenant, kind=kind, n=n,
        )
        if resume_tokens:
            try:
                resume = [int(t) for t in resume_tokens]
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad resume_tokens: {e}") from None
            if len(resume) >= max_new_tokens:
                raise ValueError(
                    f"resume_tokens ({len(resume)}) >= max_new_tokens "
                    f"({max_new_tokens}): nothing left to decode")
            req.out_tokens = resume
        if self._trace_requests:
            req.trace = TimelineRecord(req.trace_id, "engine",
                                       self.trace_source)
            req.trace.data["kind"] = req.kind
            req.trace.event("submit", prompt_tokens=len(req.prompt),
                            max_new_tokens=req.max_new_tokens,
                            priority=req.priority, tenant=req.tenant,
                            kind=req.kind)
        return req

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        priority: int = 0,
        timeout: float | None = None,
        trace_id: str | None = None,
        speculate: bool = True,
        tenant: str = "default",
        resume_tokens=None,
        kind: str = "generate",
        n: int = 1,
        constraint=None,
    ) -> Request:
        """Validate and enqueue a request; returns the streaming handle.

        Raises :class:`ValueError` (bad prompt / context overflow),
        :class:`QueueFullError` (backpressure), :class:`TenantOverQuota`,
        or :class:`EngineStopped` (shutting down), all before any device
        work."""
        req = self._build_request(
            prompt, max_new_tokens, temperature=temperature,
            priority=priority, timeout=timeout, trace_id=trace_id,
            speculate=speculate, tenant=tenant,
            resume_tokens=resume_tokens, kind=kind, n=n,
            constraint=constraint)
        try:
            self.scheduler.submit(req)
        except ServingError:
            self.metrics.record_reject()
            raise
        self.metrics.record_request_kind(req.kind)
        return req

    def submit_many(self, specs) -> list:
        """Batched admission for the binary front door: every spec is
        validated and handed to the scheduler in ONE ``submit_many`` call.
        Returns a list aligned with ``specs``: a :class:`Request` per
        accepted entry, the typed exception per rejected one."""
        built: list = []
        for spec in specs:
            try:
                built.append(self._build_request(
                    spec["prompt"], spec["max_new_tokens"],
                    temperature=float(spec.get("temperature", 0.0)),
                    priority=int(spec.get("priority", 0)),
                    timeout=spec.get("timeout"),
                    trace_id=spec.get("trace_id"),
                    speculate=bool(spec.get("speculate", True)),
                    tenant=str(spec.get("tenant") or "default"),
                    resume_tokens=spec.get("resume_tokens"),
                    kind=str(spec.get("kind") or "generate"),
                    n=int(spec.get("n") or 1),
                    constraint=spec.get("constraint"),
                ))
            except (ServingError, KeyError, TypeError, ValueError) as e:
                built.append(e)
        reqs = [r for r in built if isinstance(r, Request)]
        outcomes = iter(self.scheduler.submit_many(reqs))
        out: list = []
        for r in built:
            if not isinstance(r, Request):
                self.metrics.record_reject()
                out.append(r)
                continue
            err = next(outcomes)
            if err is not None:
                self.metrics.record_reject()
                out.append(err)
            else:
                self.metrics.record_request_kind(r.kind)
                out.append(r)
        return out

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self, drain: bool = True) -> None:
        """Stop admitting. ``drain=True`` finishes in-flight requests
        before :meth:`run` returns; ``drain=False`` errors them out."""
        self._stopping = True
        self._draining = drain
        if self.flight_recorder is not None:
            self.flight_recorder.record_event("shutdown", drain=drain)
        self.scheduler.kick()

    def request_param_swap(self, variables, provenance: dict | None = None):
        """The reference's in-place parameter swap (the ``reload`` verb):
        not ported yet."""
        raise NotImplementedError(
            f"the parameter swap (request_param_swap, the reload verb) is not "
            f"ported yet: it comes with {_A7B}")

    def request_kv_export(self, prompt):
        """The reference's KV block export (the fleet's disaggregated
        prefill): not ported yet."""
        raise NotImplementedError(
            "KV block export (request_kv_export) is not ported yet: it comes "
            "with the fleet (ROADMAP.md §A item A8)")

    def request_kv_import(self, payload: bytes):
        """The reference's KV block import: not ported yet."""
        raise NotImplementedError(
            "KV block import (request_kv_import) is not ported yet: it comes "
            "with the fleet (ROADMAP.md §A item A8)")

    async def run(self, idle_poll_s: float = 0.05) -> None:
        """Main loop: expire, admit, decode, stream — until shutdown."""
        if self._running:
            raise RuntimeError("engine.run() is already active")
        self._running = True
        if self.flight_recorder is not None:
            self.flight_recorder.record_event("engine_start",
                                              slots=self.slots)
        loop = asyncio.get_running_loop()
        try:
            while True:
                now = time.monotonic()
                # 1. Shed queued requests that died waiting: deadline
                # passed, or caller cancelled (client disconnect).
                for req in self.scheduler.expire(now):
                    if req.cancelled:
                        self._finish_error(req, RequestCancelled(
                            "cancelled while queued"))
                    else:
                        self.metrics.record_expire()
                        self._finish_error(req, RequestTimeout(
                            f"deadline exceeded after {req.timeout}s in queue"))
                # 2. Free active slots whose request died mid-decode,
                # after a pipeline barrier (which may FINISH some of them;
                # re-check before tearing down).
                dead = [i for i, st in enumerate(self._slot_state)
                        if st is not None
                        and (st.request.cancelled
                             or (st.request.deadline is not None
                                 and now > st.request.deadline))]
                if dead:
                    await self._pipeline_barrier(loop)
                for i in dead:
                    st = self._slot_state[i]
                    if st is None:
                        continue  # finished at the barrier
                    dl = st.request.deadline
                    if st.request.cancelled:
                        self._finish_error(st.request, RequestCancelled(
                            f"cancelled with {st.remaining} tokens undecoded"))
                        self._release_prefill(st)
                        self._slot_state[i] = None
                    elif dl is not None and now > dl:
                        self.metrics.record_expire()
                        self._finish_error(st.request, RequestTimeout(
                            f"deadline exceeded after {st.request.timeout}s "
                            f"with {st.remaining} tokens undecoded"))
                        self._release_prefill(st)
                        self._slot_state[i] = None
                # 3. Shutdown: flush the queue with typed errors.
                if self._stopping:
                    for req in self.scheduler.drain():
                        self._finish_error(
                            req, EngineStopped("engine shut down while queued"))
                # 4. Admission: prefill queued requests into free slots.
                # Admission writes into the batch: barrier first, so the
                # write lands on harvested token state.
                if (not self._stopping and len(self.scheduler)
                        and self.free_slots):
                    await self._pipeline_barrier(loop)
                if not self._stopping:
                    while self.free_slots and len(self.scheduler):
                        # Fresh clock per pop: an earlier admission's
                        # prefill may have outlived more queued deadlines.
                        req = self.scheduler.pop(time.monotonic())
                        if req is None:
                            break
                        slot = self._slot_state.index(None)
                        wait = time.monotonic() - req.t_submit
                        self.metrics.record_admit(wait)
                        if req.queue_wait_s is None:
                            req.queue_wait_s = wait
                            req.admit_iteration = self.metrics.iterations
                        if req.weight_version is None:
                            req.weight_version = self.weight_version
                        if req.trace is not None:
                            req.trace.data["weight_version"] = (
                                req.weight_version)
                            req.trace.event("admit", slot=slot,
                                            dur_s=round(wait, 9))
                            req.trace.data["queue_wait_s"] = round(wait, 9)
                            req.trace.data["admit_iteration"] = (
                                self.metrics.iterations)
                        if self.flight_recorder is not None:
                            self.flight_recorder.record_event(
                                "admit", trace_id=req.trace_id, slot=slot)
                        now_t = time.monotonic()
                        st = _SlotState(
                            req,
                            req.max_new_tokens - len(req.out_tokens),
                            now_t, t_admit=now_t)
                        self._slot_state[slot] = st
                        with span("admit", slot=slot,
                                  trace_id=req.trace_id,
                                  prompt_len=len(req.prompt),
                                  queue_wait_s=round(wait, 6)):
                            # Prefix-cache lookup + copy: a hit skips the
                            # matched prefix's prefill compute entirely.
                            st.prefill = await self._in_executor(
                                loop, self._begin_prefill, req)
                            if self._chunk is None:
                                # Monolithic prefill: the whole uncached
                                # tail, admitted inline (near-context-limit
                                # prompts may take a few pow2 sub-chunks).
                                tok0 = None
                                while tok0 is None:
                                    tok0 = await self._in_executor(
                                        loop, self._prefill_step, st, slot)
                                self._finish_admission(st, slot, tok0)
                # 4b. Chunked prefill: ONE chunk per iteration TOTAL,
                # round-robin across prefilling slots, interleaved with
                # the decode tick below. Runs during drain shutdown too.
                if self._chunk is not None:
                    pending = [i for i, st in enumerate(self._slot_state)
                               if st is not None and st.prefill is not None]
                    if pending:
                        await self._pipeline_barrier(loop)
                        start = self._prefill_rr
                        i = min(pending,
                                key=lambda s: (s - start) % self.slots)
                        self._prefill_rr = (i + 1) % self.slots
                        st = self._slot_state[i]
                        with span("prefill_tick", slot=i,
                                  offset=st.prefill.pos):
                            tok0 = await self._in_executor(
                                loop, self._prefill_step, st, i)
                        if tok0 is not None:
                            self._finish_admission(st, i, tok0)
                # 5. Nothing active? Flush the pipeline and wait.
                if self.active_slots == 0:
                    await self._pipeline_barrier(loop)
                    if self._stopping:
                        break
                    await self.scheduler.wait_for_request(idle_poll_s)
                    continue
                if self._stopping and not self._draining:
                    await self._pipeline_barrier(loop)
                    for i, st in enumerate(self._slot_state):
                        if st is not None:
                            self._finish_error(st.request, EngineStopped(
                                "engine shut down mid-decode"))
                            self._release_prefill(st)
                            self._slot_state[i] = None
                    break
                # 6. One decode iteration for the whole batch, skipped
                # while EVERY active slot is still mid-prefill.
                await self._tick_step(loop)
                if self.inject_decode_delay_s > 0:
                    await asyncio.sleep(self.inject_decode_delay_s)
                self.metrics.sample(
                    len(self.scheduler), self.active_slots, self.slots)
                # Yield so the server can read sockets between iterations.
                await asyncio.sleep(0)
        except BaseException as e:
            # A device failure, or the embedder cancelling the run() task,
            # must not strand clients: every in-flight and queued request
            # gets a terminal error event before the exception propagates.
            err = ServingError(f"engine failure: {e!r}")
            self._inflight.clear()
            for i, st in enumerate(self._slot_state):
                if st is not None:
                    self._finish_error(st.request, err)
                    self._release_prefill(st)
                    self._slot_state[i] = None
            for req in self.scheduler.drain():
                self._finish_error(req, err)
            self._stopping = True
            if self.flight_recorder is not None:
                self.flight_recorder.crash_dump(error=repr(e))
            raise
        finally:
            self._running = False

    # -- decode pipeline ----------------------------------------------------
    async def _tick_step(self, loop) -> None:
        """One decode tick, pipelined: dispatch tick N+1 FIRST, then
        harvest and stream tick N while N+1 executes. ``pipeline_depth=0``
        harvests right after the dispatch."""
        decodable = self._decodable()
        if not decodable:
            if self._inflight:
                # Every dispatched row disappeared (a cancel barrier tore
                # them down before the harvest): flush.
                await self._pipeline_barrier(loop)
            return
        with span("decode_tick", active=self.active_slots):
            self._inflight.append(await self._dispatch(
                loop, self._decode_dispatch))
        # Harvest the oldest tick past the in-flight window, with the
        # newest already on the device.
        while len(self._inflight) > 1:
            await self._complete_tick(loop, self._inflight.popleft())
        if self._arm_after_warmup and self.auditor is not None:
            # The first dispatch IS the warmup.
            self._arm_after_warmup = False
            self.auditor.arm("serving_decode")
        if self.pipeline_depth == 0:
            await self._pipeline_barrier(loop)

    async def _dispatch(self, loop, fn) -> _InflightTick:
        """Run one tick dispatch: the first ever in the executor, warm
        ones inline on the loop thread."""
        if self._dispatch_warm:
            return fn()
        tick = await self._in_executor(loop, fn)
        self._dispatch_warm = True
        return tick

    async def _pipeline_barrier(self, loop) -> None:
        """Drain the pipeline: harvest, stream, and tear down the in-flight
        tick (if any)."""
        while self._inflight:
            await self._complete_tick(loop, self._inflight.popleft())

    async def _complete_tick(self, loop, tick: _InflightTick) -> None:
        """Harvest one dispatched tick and do its host half: stream the
        token of every row that was decodable at dispatch and is still
        alive, then tear down rows that finished. A row whose slot emptied
        between dispatch and harvest is dropped like a mid-prefill garbage
        row."""
        if _tick_ready(tick):
            nxt = self._harvest_decode(tick)
        else:
            nxt = await self._in_executor(loop, self._harvest_decode, tick)
        t = time.monotonic()
        with span("stream", active=self.active_slots):
            for i in tick.rows:
                st = self._slot_state[i]
                if st is None or st.prefill is not None:
                    continue
                self._push_token(st, int(nxt[i]), t)
                if st.remaining == 0:
                    self._finish_ok(st.request)
                    self._slot_state[i] = None

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _in_executor(loop, fn, *args):
        """run_in_executor with contextvars propagated, so telemetry spans
        opened in the executor thread parent to the loop-side span that
        dispatched them."""
        ctx = contextvars.copy_context()
        return loop.run_in_executor(None, lambda: ctx.run(fn, *args))

    @staticmethod
    def _pow2_fit(P: int, room: int) -> int:
        """Shrink a pad width to the largest power of two that fits the
        remaining cache room (the prefill overshoot guard — see
        :meth:`_prefill_step`)."""
        if P > room:
            P = 1
            while P * 2 <= room:
                P *= 2
        return P

    def _bucket(self, n: int, cap: int | None = None) -> int:
        """Prefill pad length: next power of two >= n (>= min bucket),
        capped at the decodable context (and at ``cap``, the chunk size,
        for a ragged final chunk)."""
        b = self._min_bucket
        while b < n:
            b *= 2
        return min(b, self.limit if cap is None else min(cap, self.limit))

    def _release_prefill(self, st: _SlotState) -> None:
        """Drop a slot's pending prefill (cancel/expiry/shutdown paths):
        unpin its prefix-cache match so the blocks become evictable."""
        if st.prefill is not None:
            if self.prefix_cache is not None:
                self.prefix_cache.release(st.prefill.match)
            st.prefill = None

    def _finish_admission(self, st: _SlotState, slot: int, tok0: int) -> None:
        """Loop-thread bookkeeping once a slot's prefill completed: stream
        the first token (TTFT stamp) and free the slot if one token was all
        the request wanted."""
        t = time.monotonic()
        if st.request.t_first_token is None:
            self._push_token(st, tok0, t, first=True)
            st.remaining -= 1
        else:
            self._push_token(st, tok0, t)
        if st.remaining == 0:
            self._finish_ok(st.request)
            self._slot_state[slot] = None

    def _fresh_row_cache(self) -> dict:
        with torch.inference_mode():
            return decode_cache(self._cfg, 1, self.device)

    def _begin_prefill(self, req: Request) -> _PrefillJob:
        """Start a prompt's prefill (executor thread): build the single-row
        cache, on a prefix-cache hit straight from the matched pool blocks,
        on a miss as zeros. The uncached tail runs through
        :meth:`_prefill_step` chunk by chunk."""
        match, matched = None, 0
        if self.prefix_cache is not None:
            match = self.prefix_cache.match(req.prompt)
            matched = match.matched_tokens
        if matched:
            with span("prefix_splice", blocks=len(match.ids),
                      tokens=matched):
                cache = self.prefix_cache.materialize(match.ids)
        else:
            cache = self._fresh_row_cache()
        if req.trace is not None and matched:
            req.trace.event("prefix_splice", tokens=matched,
                            blocks=len(match.ids))
        return _PrefillJob(cache=cache, pos=matched, match=match,
                           matched_tokens=matched)

    @staticmethod
    def _resident_tokens(req: Request) -> list:
        """The slot's full resident sequence: prompt plus already-streamed
        tokens."""
        return (req.prompt + req.out_tokens if req.out_tokens
                else req.prompt)

    def _prefill_step(self, st: _SlotState, slot: int) -> int | None:
        """Run ONE prefill chunk for the slot (executor thread). Returns
        None while the prompt is still incomplete; on the final chunk,
        stores the prompt's new blocks into the prefix cache, writes the
        finished single-row cache into batch row ``slot`` and returns the
        request's first token."""
        req, job = st.request, st.prefill
        tokens = self._resident_tokens(req)
        s0 = len(tokens)
        rem = s0 - job.pos
        c = rem if self._chunk is None else min(self._chunk, rem)
        if self._chunk is None:
            P = self._bucket(c)
        elif c == self._chunk:
            P = self._chunk  # full chunk: ONE fixed width
        else:
            P = self._bucket(c, cap=self._chunk)  # ragged final chunk
        # The pad width must never overshoot the cache: with job.pos + P >
        # cache length the per-slot KV write would clamp its start backward
        # (the decode mode's OOB discipline) and overwrite the spliced
        # prefix rows. Shrink to the largest power of two that fits and
        # let the next call(s) finish the remainder.
        room = self._cache_len - job.pos
        if P > room:
            P = self._pow2_fit(P, room)
            c = min(c, P)
        padded = np.zeros((1, P), np.int32)
        padded[0, :c] = tokens[job.pos:job.pos + c]
        dev = self.device
        t0 = time.monotonic()
        hg = self.metrics.host_gap
        with span("prefill", bucket=P, offset=job.pos, prompt_len=s0):
            padded_dev = torch.from_numpy(padded).to(dev)
            temp = torch.full((), float(req.temperature), dtype=torch.float32, device=dev)
            # The chunk counts as dispatched device work (stamped before
            # its launches, as a decode tick is), so admission phases do
            # not book their prefill time as device idle.
            hg.tick_dispatched()
            job.cache, tok = self._prefill(
                self._params, job.cache, padded_dev, job.pos, c, temp)
            hg.harvest_started()
            tok0 = int(tok)  # blocks: honest device time per chunk
            hg.harvest_ended()
        chunk_s = time.monotonic() - t0
        job.device_s += chunk_s
        job.chunks_done += 1
        if req.trace is not None:
            req.trace.event("prefill_chunk", offset=job.pos, tokens=c,
                            bucket=P, dur_s=round(chunk_s, 9))
        job.pos += c
        if job.pos < s0:
            return None
        # Prompt complete: store the complete blocks this prefill computed
        # (future requests sharing the prefix hit them), then write the row
        # into the live batch cache.
        if self.prefix_cache is not None:
            with span("prefix_insert", prompt_len=s0):
                self.prefix_cache.insert(req.prompt, job.cache)
            self.prefix_cache.release(job.match)
        with span("cache_splice", slot=slot):
            self._cache, self._tokens, self._temps = self._admit(
                self._cache, self._tokens, self._temps, slot,
                job.cache, tok, temp)
        self.metrics.record_prefill(
            job.device_s, job.chunks_done,
            job.matched_tokens if self.prefix_cache is not None else None,
            s0)
        req.prefill_device_s += job.device_s
        req.prefill_chunks += job.chunks_done
        req.prefix_hit_tokens = int(job.matched_tokens or 0)
        if req.trace is not None:
            req.trace.data.update(
                prefill_device_s=round(job.device_s, 9),
                prefill_chunks=job.chunks_done,
                cache_hit_tokens=job.matched_tokens)
        st.prefill = None
        return tok0

    def _decodable(self) -> list[int]:
        """Slots whose row is live and past prefill: the rows whose tick
        output is streamed (everyone else decodes garbage)."""
        return [i for i in range(self.slots)
                if self._slot_state[i] is not None
                and self._slot_state[i].prefill is None]

    def _decode_dispatch(self) -> _InflightTick:
        """Queue ONE decode tick and return WITHOUT waiting for the device.
        The new token vector is the tick's harvest handle; the next tick
        reads it as its input and writes a new one."""
        rows = tuple(self._decodable())
        # Stamped before the launches: an eager step queues its first
        # kernel at once (a jit call queues all of its work only as it
        # returns), so the device's queue stops being empty here.
        t = self.metrics.host_gap.tick_dispatched()
        self._cache, self._tokens = self._decode_step(
            self._params, self._cache, self._tokens, self._temps)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return _InflightTick(kind="decode", rows=rows, t_dispatch=t,
                             tokens=self._tokens, ready=ready)

    def _harvest_decode(self, tick: _InflightTick) -> np.ndarray:
        """The one D2H per tick: blocks until the device finishes the tick,
        then hands its token vector to the loop thread for streaming."""
        hg = self.metrics.host_gap
        hg.harvest_started()
        nxt = tick.tokens.cpu().numpy()
        t = hg.harvest_ended()
        self._tick_log.append({
            "kind": tick.kind, "rows": len(tick.rows),
            "t_dispatch": tick.t_dispatch, "t_harvest": t,
            "harvest_wait_s": round(hg.last_harvest_wait, 9),
            "host_gap_s": round(hg.last_gap, 9),
        })
        return nxt

    def _push_token(self, st: _SlotState, tok: int, t: float,
                    first: bool = False) -> None:
        req = st.request
        if first:
            req.t_first_token = t
            self.metrics.record_first_token(t - req.t_submit,
                                            trace_id=req.trace_id)
            if req.trace is not None:
                req.trace.event("first_token",
                                ttft_s=round(t - req.t_submit, 9))
        else:
            self.metrics.record_inter_token(t - st.last_token_t,
                                            trace_id=req.trace_id)
            st.remaining -= 1
        st.last_token_t = t
        req.out_tokens.append(tok)
        req.events.put_nowait(("token", tok))

    def _finish_ok(self, req: Request) -> None:
        if req.t_done is not None:
            return
        req.t_done = time.monotonic()
        self.scheduler.release_quota(req)
        self.metrics.record_finish(req.t_done - req.t_submit)
        done_tokens = len(req.out_tokens)
        self.metrics.record_tenant_done(req.tenant, done_tokens)
        self._finalize_trace(req, "ok")
        done = {
            "tokens": done_tokens,
            "ttft_s": req.ttft,
            "latency_s": req.t_done - req.t_submit,
            "weight_version": req.weight_version,
            "tenant": req.tenant,
            "kind": req.kind,
        }
        req.events.put_nowait(("done", done))
        req.done.set()

    def _finish_error(self, req: Request, err: ServingError) -> None:
        if req.t_done is not None:
            return
        req.error = err
        req.t_done = time.monotonic()
        # Quota credit on EVERY terminal path.
        self.scheduler.release_quota(req)
        self._finalize_trace(req, err.code, message=str(err))
        req.events.put_nowait(("error", err))
        req.done.set()

    def _finalize_trace(self, req: Request, status: str,
                        message: str | None = None) -> None:
        """Terminal bookkeeping for one request: SLO verdict, the
        wide-event append, and timeline finalization into the trace store
        and flight recorder."""
        latency = (req.t_done - req.t_submit
                   if req.t_done is not None and req.t_submit is not None
                   else None)
        slow = (self.slo_s is not None and latency is not None
                and latency > self.slo_s)
        if slow:
            self.metrics.record_slo_violation()
        if self.wide_events is not None:
            self._emit_wide_event(req, status, latency, slow)
        rec = req.trace
        if rec is None:
            return
        req.trace = None  # finalize exactly once
        if status == "ok":
            rec.event("done", tokens=len(req.out_tokens))
        else:
            rec.event("error", code=status,
                      message=(message or "")[:200] or None)
        d = rec.data
        d["status"] = status
        d["tenant"] = req.tenant
        d["tokens_out"] = len(req.out_tokens)
        d["prompt_tokens"] = len(req.prompt)
        if latency is not None:
            d["latency_s"] = round(latency, 9)
        if req.ttft is not None:
            d["ttft_s"] = round(req.ttft, 9)
        if "admit_iteration" in d:
            d["decode_iterations"] = (self.metrics.iterations
                                      - d.pop("admit_iteration"))
        if slow:
            d["slo_violation"] = True
        recd = rec.to_dict()
        if self.trace_store is not None:
            self.trace_store.put(recd)
        if self.flight_recorder is not None:
            self.flight_recorder.record_timeline(recd, slow=slow)

    def _emit_wide_event(self, req: Request, status: str,
                         latency: float | None, slow: bool) -> None:
        """Append the one canonical flat record for a finished request,
        with the reference's columns (those of later slices at their
        empty values)."""
        prov = req.weight_version or self.weight_version or {}
        err_kind = ""
        if status != "ok":
            err_kind = (type(req.error).__name__
                        if req.error is not None else status)
        record = {
            "trace_id": req.trace_id,
            "t_done": time.time(),
            "tenant": req.tenant,
            "kind": req.kind,
            "priority": req.priority,
            "replica": self.trace_source,
            "role": self.serve_role,
            "mesh": "",
            "pp_depth": 1,
            "pp_stage": None,
            "weight_version": prov.get("version"),
            "weight_digest": prov.get("digest") or "",
            "prompt_tokens": len(req.prompt),
            "output_tokens": len(req.out_tokens),
            "max_new_tokens": req.max_new_tokens,
            "prefix_hit_tokens": req.prefix_hit_tokens,
            "kv_blocks": req.kv_blocks,
            "forks": 0,
            "n": req.n,
            "preemptions": req.preemptions,
            "migration": "",
            "queue_wait_s": req.queue_wait_s,
            "prefill_device_s": (req.prefill_device_s
                                 if req.prefill_chunks else None),
            "prefill_chunks": req.prefill_chunks,
            "ttft_s": req.ttft,
            "latency_s": latency,
            "decode_iterations": (
                self.metrics.iterations - req.admit_iteration
                if req.admit_iteration is not None else None),
            "spec_drafted": req.spec_drafted,
            "spec_accepted": req.spec_accepted,
            "spec_accept_rate": None,
            "mask_uploads": req.mask_uploads,
            "constrained": 0,
            "cache_overtaken": int(req.cache_overtaken),
            "speculate": int(req.speculate),
            "temperature": req.temperature,
            "status": status,
            "error_kind": err_kind,
            "slo_verdict": "slow" if slow else "ok",
            "timeout_s": req.timeout,
            "stream": int(req.kind == "generate"),
        }
        self.wide_events.append(record)
