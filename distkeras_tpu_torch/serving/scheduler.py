"""Request queue, admission control, and multi-tenant QoS for the
serving engine.

Copy of the reference's ``distkeras_tpu/serving/scheduler.py``, which imports no JAX;
only its imports differ.

Policy, in layers:

- **priority classes** (lower ``priority`` value is served first) —
  unchanged from the original FIFO scheduler;
- **weighted deficit round robin across tenants WITHIN a class**: every
  request carries a ``tenant`` id (default ``"default"``), and each
  class serves its tenants by DRR over *token* cost (a request costs its
  remaining ``max_new_tokens``) with per-tenant ``tenant_weights``. One
  tenant flooding the queue therefore cannot starve the others — it only
  deepens its OWN backlog. With a single tenant the DRR ring has one
  member and the scheduler degenerates to exactly the old FIFO order;
- **per-tenant token-rate quotas** (``tenant_quotas``: tokens/second
  budgets backed by a token bucket with ``quota_burst_s`` of burst):
  enforced at ``submit`` only — an over-quota tenant gets a typed
  :class:`TenantOverQuota` reject before any device work, and a stream
  that was admitted is NEVER killed mid-flight for quota. Unused charge
  (a stream that finished early) is credited back at completion;
- **bounded depth** (:class:`QueueFullError` past ``max_depth``) and
  **per-request deadlines**, as before.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import time
from typing import AsyncIterator, Sequence

from distkeras_tpu_torch.telemetry.request_trace import (
    new_trace_id,
    sanitize_trace_id,
)

__all__ = [
    "ServingError",
    "QueueFullError",
    "PoolExhausted",
    "RequestTimeout",
    "EngineStopped",
    "TenantOverQuota",
    "TenantQuota",
    "DEFAULT_TENANT",
    "REQUEST_KINDS",
    "SCORELIKE_KINDS",
    "SCORE_CLASS_SUFFIX",
    "Request",
    "Scheduler",
]

DEFAULT_TENANT = "default"


class ServingError(Exception):
    """Base class for typed serving failures (wire ``code`` per subclass).
    ``trace_id`` is attached when the failure is tied to one request
    whose id is known (client-side decode of error lines)."""

    code = "error"
    trace_id: str | None = None


class QueueFullError(ServingError):
    """Backpressure: queue is at ``max_depth``; retry later."""

    code = "queue_full"


class PoolExhausted(ServingError):
    """The request can NEVER fit the paged KV pool: the blocks its full
    context (prompt + max_new_tokens) needs exceed the pool's capacity.
    Rejected at admission, before any device work — unlike transient
    pressure (queued until blocks free, or resolved by preemption), this
    is a sizing error only a bigger ``--kv-pool-mb`` fixes."""

    code = "kv_oom"


class RequestTimeout(ServingError):
    """The request's deadline passed before it completed."""

    code = "timeout"


class EngineStopped(ServingError):
    """The engine is shutting down and no longer admits requests."""

    code = "stopped"


class RequestCancelled(ServingError):
    """The caller abandoned the request (e.g. client disconnected)."""

    code = "cancelled"


class TenantOverQuota(ServingError):
    """The tenant's token-rate quota has no room for this request's
    ``max_new_tokens``. Raised at submit ONLY — admitted streams are
    never cut mid-flight for quota; the reject is the tenant's signal to
    back off (a well-behaved client retries after ~need/rate seconds)."""

    code = "tenant_over_quota"


class TenantLabeler:
    """One shared cardinality cap for per-tenant label series: past
    ``cap`` distinct tenants, new ids map to ``__other__`` so id churn
    (or a hostile client minting tenants) cannot grow the scrape
    unbounded. The ENGINE hands one instance to both the scheduler and
    ServingMetrics, so a tenant is either labeled in every family or
    folded in every family — never half-joined across dashboards."""

    def __init__(self, cap: int = 32):
        self.cap = int(cap)
        self.seen: set[str] = set()

    def __call__(self, tenant: str) -> str:
        if tenant in self.seen or len(self.seen) < self.cap:
            self.seen.add(tenant)
            return tenant
        return "__other__"


class TenantQuota:
    """Token bucket for one tenant: refills at ``rate`` tokens/second up
    to ``rate * burst_s`` capacity. ``take`` charges a request's worst
    case (its ``max_new_tokens``) at submit; ``credit`` returns the
    unused part when the stream finishes short — so the quota meters
    tokens the tenant could actually have consumed, not its optimism."""

    def __init__(self, rate: float, burst_s: float = 2.0):
        if rate <= 0:
            raise ValueError(f"quota rate must be > 0 tok/s, got {rate}")
        self.rate = float(rate)
        self.capacity = max(self.rate * float(burst_s), 1.0)
        self.available = self.capacity
        self._t: float | None = None

    def _refill(self, now: float) -> None:
        if self._t is None:
            self._t = now
            return
        dt = now - self._t
        if dt > 0:
            self.available = min(self.capacity,
                                 self.available + dt * self.rate)
        self._t = now

    def take(self, n: float, now: float) -> bool:
        self._refill(now)
        if self.available >= n:
            self.available -= n
            return True
        return False

    def credit(self, n: float) -> None:
        if n > 0:
            self.available = min(self.capacity, self.available + n)

    def stats(self) -> dict:
        return {
            "rate_tokens_per_s": self.rate,
            "burst_capacity": round(self.capacity, 3),
            "available": round(self.available, 3),
        }


#: The typed request kinds the serving stack understands. ``generate``
#: is the classic single-completion stream; ``sample`` forks one prefill
#: into n decode rows over copy-on-write KV blocks; ``score`` returns
#: per-token logprobs of the prompt (prefill only); ``embed`` returns a
#: pooled hidden state (prefill only).
REQUEST_KINDS = ("generate", "sample", "score", "embed")

#: Kinds that run prefill only and never occupy a decode slot. They are
#: queued under a SEPARATE QoS identity (``tenant + "#score"``) so bulk
#: scoring traffic gets its own DRR weight and quota bucket and cannot
#: starve the same tenant's interactive decode.
SCORELIKE_KINDS = frozenset({"score", "embed"})

#: Suffix appended to a tenant id to form the scorelike traffic class.
SCORE_CLASS_SUFFIX = "#score"


class Request:
    """One generation request plus its streaming output channel.

    The engine pushes ``("token", id)`` events as tokens are decoded, then
    exactly one terminal event: ``("done", info)`` or ``("error", exc)``.
    Consume via :meth:`tokens` (async stream) or :meth:`result` (await
    completion, return the full token list).
    """

    def __init__(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        priority: int = 0,
        timeout: float | None = None,
        trace_id: str | None = None,
        speculate: bool = True,
        tenant: str = DEFAULT_TENANT,
        kind: str = "generate",
        n: int = 1,
        constraint: object = None,
    ):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)  # <= 0 means greedy
        # Per-request speculation opt-out: on an engine with a draft
        # model, a greedy request with speculate=False still takes the
        # one-token fallback path (A/B measurement, or a caller that
        # wants strictly minimal per-token latency jitter). Requests
        # with temperature > 0 never speculate regardless — acceptance
        # is a greedy-consistency rule.
        self.speculate = bool(speculate)
        self.priority = int(priority)
        # Multi-tenant QoS identity: rides the wire client -> router ->
        # replica, keys the scheduler's fair queueing and quotas, and is
        # echoed on the done line so per-tenant accounting closes the
        # loop. Cast defensively — it arrives from the wire.
        self.tenant = str(tenant) if tenant else DEFAULT_TENANT
        # Typed request kind — validated by the ENGINE's _build_request
        # (the scheduler stays policy-only), defaulting anything unset to
        # the classic generate stream so pre-kinds callers are untouched.
        self.kind = str(kind) if kind else "generate"
        # Fork fan-out for kind="sample": n decode rows share the prompt's
        # KV blocks copy-on-write; the done frame carries n completions.
        self.n = int(n) if n else 1
        # Wire-form constraint table (dict) or a compiled TokenDFA; the
        # engine compiles/validates at admission.
        self.constraint = constraint
        # Tokens charged against the tenant's quota at submit; the
        # scheduler credits back the unused part at completion.
        self.quota_charged = 0
        # Every request carries a trace id: the client's (propagated over
        # the wire, sanitized against junk) or a fresh mint — so
        # done/error replies, debugz slot tables, and histogram exemplars
        # can always name the request. The TIMELINE (``trace``) is only
        # attached by an engine with a trace store/flight recorder.
        self.trace_id = sanitize_trace_id(trace_id) or new_trace_id()
        self.trace = None  # TimelineRecord | None, engine-owned
        # Weight provenance ({"version", "digest", ...}), stamped by the
        # engine at ADMISSION (a request finishes under the weights it
        # was admitted with — param swaps only run at zero active
        # slots), echoed on the done line and in the trace timeline.
        self.weight_version: dict | None = None
        # Cast defensively: this arrives from the wire, and an uncastable
        # value must fail HERE (a bad_request to one client), not later as
        # a TypeError inside the engine loop's deadline arithmetic (which
        # would kill serving for everyone).
        self.timeout = None if timeout is None else float(timeout)
        # Engine-owned runtime state.
        self.cache_overtaken = 0  # times a cache hit was served over us
        self.events: asyncio.Queue = asyncio.Queue()
        self.out_tokens: list[int] = []
        # Kind-specific results, filled by the engine at completion:
        # sample -> n token lists; score -> per-token logprobs of the
        # prompt; embed -> pooled hidden-state vector.
        self.fork_completions: list[list[int]] | None = None
        self.logprobs: list[float] | None = None
        self.embedding: list[float] | None = None
        self.error: ServingError | None = None
        self.done = asyncio.Event()
        self.cancelled = False
        self.t_submit: float | None = None
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        # Wide-event counters: populated UNCONDITIONALLY by the engine
        # (plain attribute writes, never per-token) so the done-time
        # wide event is complete even with tracing disabled — the
        # timeline's `data` dict was trace-gated, which is exactly why
        # these live here instead.
        self.queue_wait_s: float | None = None
        self.admit_iteration: int | None = None
        self.prefill_device_s: float = 0.0
        self.prefill_chunks: int = 0
        self.prefix_hit_tokens: int = 0
        self.kv_blocks: int = 0
        self.preemptions: int = 0
        self.spec_drafted: int = 0
        self.spec_accepted: int = 0
        self.mask_uploads: int = 0

    def cancel(self) -> None:
        """Abandon the request: the engine frees its slot (or drops it
        from the queue) at the next loop iteration instead of decoding
        tokens nobody will read."""
        self.cancelled = True

    @property
    def qos_tenant(self) -> str:
        """The identity this request is QUEUED under: plain tenant for
        decode-shaped kinds, ``tenant#score`` for prefill-only scoring/
        embedding — a distinct traffic class with its own DRR ring slot,
        weight, and quota bucket, so a scoring flood deepens only its own
        backlog (bulk scoring can't starve interactive decode)."""
        if self.kind in SCORELIKE_KINDS:
            return self.tenant + SCORE_CLASS_SUFFIX
        return self.tenant

    def consumed_tokens(self) -> int:
        """Tokens this request actually consumed against its quota
        charge: decoded tokens for generate, the sum over all forks for
        sample, and the scored prompt length for score/embed (their cost
        is prefill compute, metered in prompt tokens)."""
        if self.kind == "sample" and self.fork_completions is not None:
            return sum(len(c) for c in self.fork_completions)
        if self.kind in SCORELIKE_KINDS:
            return len(self.prompt)
        return len(self.out_tokens)

    @property
    def deadline(self) -> float | None:
        if self.timeout is None or self.t_submit is None:
            return None
        return self.t_submit + self.timeout

    @property
    def ttft(self) -> float | None:
        if self.t_submit is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    async def tokens(self) -> AsyncIterator[int]:
        """Stream token ids as they decode; raises the terminal
        :class:`ServingError` if the request failed."""
        while True:
            kind, payload = await self.events.get()
            if kind == "token":
                yield payload
            elif kind == "done":
                return
            else:  # "error"
                raise payload


    async def result(self) -> list[int]:
        await self.done.wait()
        if self.error is not None:
            raise self.error
        return self.out_tokens


class _TenantQueue:
    """One tenant's FIFO within one priority class, plus its DRR
    deficit counter."""

    __slots__ = ("name", "q", "deficit", "turn_topped")

    def __init__(self, name: str):
        self.name = name
        self.q: collections.deque = collections.deque()  # (seq, Request)
        self.deficit = 0.0
        # One quantum top-up per service TURN (reset when the turn
        # passes): without this, the ring head would be re-funded on
        # every pop and never yield — the anti-starvation property DRR
        # exists for.
        self.turn_topped = False


class _PrioClass:
    """One priority value's tenants and their DRR service ring."""

    __slots__ = ("tenants", "ring")

    def __init__(self):
        self.tenants: dict[str, _TenantQueue] = {}
        self.ring: collections.deque = collections.deque()  # _TenantQueue


class Scheduler:
    """Bounded multi-tenant queue: priority classes served lowest-first,
    weighted deficit round robin across tenants within a class, FIFO
    within a tenant, deadline expiry, and per-tenant token-rate quotas.

    Pure bookkeeping — no device state. The engine calls :meth:`pop`
    between decode iterations to fill free slots and :meth:`expire` to
    shed requests whose deadline passed while queued.

    ``tenant_weights``: relative DRR weights (missing tenants weigh 1.0)
    — a weight-2 tenant is offered twice the token bandwidth of a
    weight-1 tenant when both have backlog. ``tenant_quotas``: tokens/
    second budgets (missing tenants are unmetered); ``quota_burst_s``
    sizes each bucket's burst. ``drr_quantum``: deficit added per
    service turn (tokens) — smaller interleaves finer, larger favors
    per-tenant batching; the default of 64 serves several typical
    requests per turn.
    """

    def __init__(self, max_depth: int = 64, registry=None, cache_probe=None,
                 probe_window: int = 8, max_overtake: int = 4,
                 tenant_weights: dict | None = None,
                 tenant_quotas: dict | None = None,
                 quota_burst_s: float = 2.0,
                 drr_quantum: int = 64,
                 tenant_labeler: TenantLabeler | None = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = int(max_depth)
        # Cache-aware admission: an optional ``prompt -> matched-token
        # count`` scorer (the prefix cache's ``probe``); when set, pop()
        # may serve a cache-hitting request ahead of colder ones within
        # the same priority class AND tenant (bounded by
        # ``probe_window``) — a hit admits nearly for free, so serving
        # it first raises goodput without starving anyone outside the
        # window. The window never crosses tenants: cache affinity must
        # not override fairness.
        self.cache_probe = cache_probe
        self.probe_window = int(probe_window)
        # Starvation bound: once a request has been overtaken this many
        # times while at the head of its queue, it is served regardless
        # of cache scores (otherwise steady cache-warm traffic refilling
        # the window could delay a cold head forever).
        self.max_overtake = int(max_overtake)
        self.tenant_weights = dict(tenant_weights or {})
        if drr_quantum < 1:
            raise ValueError(f"drr_quantum must be >= 1, got {drr_quantum}")
        self.drr_quantum = int(drr_quantum)
        self._quotas: dict[str, TenantQuota] = {}
        for name, rate in (tenant_quotas or {}).items():
            self._quotas[str(name)] = (
                rate if isinstance(rate, TenantQuota)
                else TenantQuota(float(rate), quota_burst_s))
        self._classes: dict[int, _PrioClass] = {}
        self._n = 0
        self._seq = itertools.count()
        # Requeues (preemption, admission park) jump to the FRONT of
        # their tenant's queue AND their tenant to the front of the DRR
        # ring: sequence numbers from a deeply negative counter keep
        # them ordered before every arrival in flattened views while
        # staying FIFO among requeues themselves.
        self._requeue_seq = itertools.count(-(2**62))
        self._arrival = asyncio.Event()
        # Tier-arrival event: set when KV bytes land in a tier (host
        # spill, re-admission, peer push/pull import). A fully-parked
        # tier-pending admission waits on THIS instead of polling the
        # pool version every idle tick.
        self._kv_arrival = asyncio.Event()
        # Requests found expired during pop(), awaiting pickup by expire().
        self._expired_backlog: list[Request] = []
        # Per-tenant shed accounting (quota rejects), served by
        # tenant_stats() / healthz even without a registry.
        self.over_quota_rejects: collections.Counter = collections.Counter()
        self._tenant_label = tenant_labeler or TenantLabeler()
        # Optional telemetry (MetricsRegistry): admission counters + live
        # depth gauge, so a scrape sees queue pressure without waiting for
        # the engine's next sample() record.
        self._registry = registry
        self._c_submitted = self._c_shed = self._g_depth = None
        self._c_cache_preferred = self._c_requeued = None
        if registry is not None:
            self._c_submitted = registry.counter(
                "scheduler_submitted_total", help="requests enqueued")
            self._c_shed = registry.counter(
                "scheduler_shed_total",
                help="requests shed from the queue (expired or cancelled)")
            self._g_depth = registry.gauge(
                "scheduler_queue_depth", help="requests currently queued")
            self._c_cache_preferred = registry.counter(
                "scheduler_cache_preferred_total",
                help="pops that served a prefix-cache hit ahead of an "
                     "older same-priority request")
            self._c_requeued = registry.counter(
                "scheduler_requeued_total",
                help="requests returned to the queue head (KV preemption "
                     "or admission parked on a dry pool)")

    def __len__(self) -> int:
        return self._n

    # -- tenant helpers -----------------------------------------------------
    def _weight(self, tenant: str) -> float:
        try:
            w = float(self.tenant_weights.get(tenant, 1.0))
        except (TypeError, ValueError):
            return 1.0
        return w if w > 0 else 1.0

    @staticmethod
    def _cost(request: Request) -> float:
        """DRR cost of serving a request, in tokens of compute: the
        decode tokens still owed (a preempted resume costs only its
        remainder), times the fork fan-out for ``sample``; prefill-only
        scoring/embedding costs its prompt length — their work IS the
        prefill."""
        if request.kind in SCORELIKE_KINDS:
            return float(max(1, len(request.prompt)))
        owed = max(1, request.max_new_tokens - len(request.out_tokens))
        if request.kind == "sample":
            owed *= max(1, request.n)
        return float(owed)

    def set_tenant_quota(self, tenant: str, rate: float,
                         burst_s: float = 2.0) -> None:
        """Install or replace one tenant's token-rate quota at runtime."""
        self._quotas[str(tenant)] = TenantQuota(float(rate), burst_s)

    def _note_depth(self) -> None:
        if self._g_depth is not None:
            self._g_depth.set(self._n)

    # -- submission ---------------------------------------------------------
    def _submit_one(self, request: Request, now: float) -> None:
        if self._n >= self.max_depth:
            raise QueueFullError(
                f"queue depth {self._n} at max_depth={self.max_depth}")
        qos_tenant = request.qos_tenant
        quota = self._quotas.get(qos_tenant)
        if quota is not None:
            # Worst-case token charge by kind: generate is its decode
            # budget, sample multiplies by the fork fan-out, scorelike
            # is metered in prompt (prefill) tokens.
            if request.kind in SCORELIKE_KINDS:
                need = max(1, len(request.prompt))
            elif request.kind == "sample":
                need = max(1, request.max_new_tokens) * max(1, request.n)
            else:
                need = max(1, request.max_new_tokens)
            if not quota.take(need, now):
                self.over_quota_rejects[qos_tenant] += 1
                if self._registry is not None:
                    self._registry.counter(
                        "scheduler_tenant_over_quota_total",
                        help="requests rejected at submit because the "
                             "tenant's token-rate quota had no room",
                        tenant=self._tenant_label(qos_tenant)).inc()
                if need > quota.capacity:
                    # Not a transient: no amount of waiting refills past
                    # the burst capacity — the retry advice below would
                    # be a lie (same stance as PoolExhausted's sizing
                    # reject).
                    raise TenantOverQuota(
                        f"tenant {qos_tenant!r}: request needs "
                        f"{need} tokens but the quota's burst capacity "
                        f"is {quota.capacity:g} (rate {quota.rate:g} "
                        f"tok/s) — it can NEVER be admitted; raise the "
                        f"quota/burst or lower max_new_tokens")
                raise TenantOverQuota(
                    f"tenant {qos_tenant!r} over quota: request needs "
                    f"{need} tokens, bucket has "
                    f"{quota.available:.1f} (rate "
                    f"{quota.rate:g} tok/s) — back off and retry")
            request.quota_charged = need
        request.t_submit = now
        self._push(request, next(self._seq))
        if self._c_submitted is not None:
            self._c_submitted.inc()

    def _push(self, request: Request, seq: int, front: bool = False) -> None:
        cls = self._classes.get(request.priority)
        if cls is None:
            cls = self._classes[request.priority] = _PrioClass()
        name = request.qos_tenant
        tq = cls.tenants.get(name)
        if tq is None:
            tq = cls.tenants[name] = _TenantQueue(name)
            cls.ring.append(tq)
        if front:
            tq.q.appendleft((seq, request))
        else:
            tq.q.append((seq, request))
        self._n += 1

    def submit(self, request: Request, now: float | None = None) -> None:
        """Enqueue; raises :class:`QueueFullError` at ``max_depth`` or
        :class:`TenantOverQuota` when the tenant's token budget has no
        room (both before any device work, both typed)."""
        self._submit_one(request,
                         time.monotonic() if now is None else now)
        self._note_depth()
        self._arrival.set()

    def submit_many(self, requests: Sequence[Request],
                    now: float | None = None) -> list:
        """Batched admission: enqueue every request under ONE clock and
        one arrival wake-up — the scheduler half of the front door's
        drain-all-ready-frames-per-tick path. Returns a list aligned
        with ``requests``: ``None`` for accepted entries, the typed
        :class:`ServingError` for rejected ones (per-request rejects
        must not fail the whole batch — they are different clients)."""
        now = time.monotonic() if now is None else now
        out: list = []
        for request in requests:
            try:
                self._submit_one(request, now)
            except ServingError as e:
                out.append(e)
            else:
                out.append(None)
        self._note_depth()
        if any(e is None for e in out):
            self._arrival.set()
        return out

    def requeue(self, request: Request) -> None:
        """Return an already-admitted (or popped-but-unadmittable)
        request to the FRONT of its priority class — the preempt-and-
        requeue half of KV-pool oversubscription. Bypasses ``max_depth``
        (shedding a request the engine itself displaced would turn a
        capacity wobble into a client-visible error) AND the tenant
        quota (its tokens were already charged at first admission), and
        keeps the original ``t_submit`` so the deadline clock never
        resets. The tenant moves to the front of its class's DRR ring
        with enough deficit banked to be served next."""
        self._push(request, next(self._requeue_seq), front=True)
        cls = self._classes[request.priority]
        tq = cls.tenants[request.qos_tenant]
        if cls.ring and cls.ring[0] is not tq:
            cls.ring.remove(tq)
            cls.ring.appendleft(tq)
        tq.deficit = max(tq.deficit, self._cost(request))
        if self._c_requeued is not None:
            self._c_requeued.inc()
        self._note_depth()
        self._arrival.set()

    # -- service ------------------------------------------------------------
    def _prune_head(self, tq: _TenantQueue, now: float) -> Request | None:
        """Drop dead (cancelled/expired) heads into the expired backlog;
        returns the live head or None when the tenant queue emptied."""
        while tq.q:
            req = tq.q[0][1]
            if req.cancelled or (req.deadline is not None
                                 and now > req.deadline):
                tq.q.popleft()
                self._n -= 1
                self._expired_backlog.append(req)
                continue
            return req
        return None

    def _drop_tenant(self, cls: _PrioClass, tq: _TenantQueue) -> None:
        del cls.tenants[tq.name]
        try:
            cls.ring.remove(tq)
        except ValueError:
            pass

    def _drr_pick(self, cls: _PrioClass, now: float):
        """The tenant whose head this class serves next: visit the ring,
        topping up deficits by weight x quantum, until one covers its
        head's cost. Terminates: every full cycle raises every backlog
        tenant's deficit, so the cheapest head qualifies within
        ``ceil(cost / quantum)`` cycles (one, in the common case)."""
        while cls.ring:
            tq = cls.ring[0]
            head = self._prune_head(tq, now)
            if head is None:
                self._drop_tenant(cls, tq)
                continue
            cost = self._cost(head)
            if tq.deficit >= cost:
                return tq
            if not tq.turn_topped:
                # One top-up per turn: a tenant serves until its banked
                # deficit runs out, then the turn passes — re-funding
                # the head on every pop would let it hog the ring.
                tq.turn_topped = True
                tq.deficit += self.drr_quantum * self._weight(tq.name)
                if tq.deficit >= cost:
                    return tq
            tq.turn_topped = False
            cls.ring.rotate(-1)
        return None

    def _serve(self, cls: _PrioClass, tq: _TenantQueue,
               now: float) -> Request:
        """Pop from the chosen tenant's queue — FIFO, except the bounded
        cache-probe window (same class, same tenant) may serve the best
        prefix hit first; ``max_overtake`` bounds how often the head can
        be passed over."""
        idx = 0
        head = tq.q[0][1]
        if (self.cache_probe is not None and len(tq.q) > 1
                and head.cache_overtaken < self.max_overtake):
            window = min(self.probe_window, len(tq.q))
            best_score = self.cache_probe(head.prompt)
            for i in range(1, window):
                req_i = tq.q[i][1]
                if req_i.cancelled or (req_i.deadline is not None
                                       and now > req_i.deadline):
                    continue
                score = self.cache_probe(req_i.prompt)
                # Strict >: equal scores preserve FIFO arrival order.
                if score > best_score:
                    idx, best_score = i, score
            if idx != 0:
                head.cache_overtaken += 1
                if self._c_cache_preferred is not None:
                    self._c_cache_preferred.inc()
        req = tq.q[idx][1]
        del tq.q[idx]
        self._n -= 1
        tq.deficit -= self._cost(req)
        if not tq.q:
            self._drop_tenant(cls, tq)
        return req

    def peek(self) -> Request | None:
        """Non-destructive view of the request :meth:`pop` would serve
        next (best-effort: deficits are not consumed), or None if empty.
        May return an expired/cancelled request — callers using peek()
        as an admission hint must still pop() for deadline handling."""
        for prio in sorted(self._classes):
            cls = self._classes[prio]
            for tq in cls.ring:
                if tq.q:
                    return tq.q[0][1]
        return None

    def has_streamed(self) -> bool:
        """True when any queued live request has already streamed tokens
        — a preempted-and-requeued resume. Such a request must finish
        under the weights that produced its streamed prefix, so the
        engine holds a pending param swap while the queue carries one
        (admission==completion provenance survives preempt-requeue)."""
        return any(req.out_tokens and not req.cancelled
                   for _, req in self._iter_items())

    def _iter_items(self):
        for cls in self._classes.values():
            for tq in cls.tenants.values():
                yield from tq.q

    def pop(self, now: float | None = None) -> Request | None:
        """Highest-priority non-expired request, or None if empty —
        within the class, the tenant DRR's pick; within the tenant,
        FIFO modulo the bounded cache-probe window."""
        now = time.monotonic() if now is None else now
        while self._classes:
            prio = min(self._classes)
            cls = self._classes[prio]
            tq = self._drr_pick(cls, now)
            if tq is None:
                # Class emptied while pruning dead heads.
                self._classes.pop(prio, None)
                continue
            req = self._serve(cls, tq, now)
            if not cls.tenants:
                # Empty classes are pruned so min() stays cheap.
                self._classes.pop(prio, None)
            self._note_depth()
            return req
        self._note_depth()
        return None

    def release_quota(self, request: Request) -> None:
        """Credit back the unused part of a finished request's quota
        charge (a stream that stopped early was charged its worst case).
        Called by the engine on every terminal path; a request that was
        never charged is a no-op."""
        if not request.quota_charged:
            return
        quota = self._quotas.get(request.qos_tenant)
        unused = request.quota_charged - request.consumed_tokens()
        request.quota_charged = 0
        if quota is not None and unused > 0:
            quota.credit(unused)

    def expire(self, now: float | None = None) -> list[Request]:
        """Remove and return every queued request whose deadline passed or
        that was cancelled (distinguish via ``req.cancelled``)."""
        now = time.monotonic() if now is None else now
        expired = self._expired_backlog
        self._expired_backlog = []
        for prio in list(self._classes):
            cls = self._classes[prio]
            for name in list(cls.tenants):
                tq = cls.tenants[name]
                keep = collections.deque()
                for item in tq.q:
                    req = item[1]
                    if req.cancelled or (req.deadline is not None
                                         and now > req.deadline):
                        expired.append(req)
                        self._n -= 1
                    else:
                        keep.append(item)
                tq.q = keep
                if not keep:
                    self._drop_tenant(cls, tq)
            if not cls.tenants:
                del self._classes[prio]
        if expired and self._c_shed is not None:
            self._c_shed.inc(len(expired))
        self._note_depth()
        return expired

    def tenant_stats(self) -> dict:
        """Per-tenant QoS snapshot: queue depth (across classes), DRR
        weight, quota bucket state, and over-quota shed count — the
        healthz/debugz payload, and the refresh point for the labeled
        ``scheduler_tenant_depth`` gauges (scrape-time, like the memory
        gauges: a passive registry cannot watch the queue itself)."""
        depth: collections.Counter = collections.Counter()
        for _, req in self._iter_items():
            depth[req.qos_tenant] += 1
        # Every tenant that EVER had a labeled series is refreshed, so
        # a tenant whose queue drained reads 0 on the next scrape
        # instead of its last nonzero depth forever.
        tenants = sorted(set(depth) | set(self._quotas)
                         | set(self.over_quota_rejects)
                         | self._tenant_label.seen)
        out = {}
        for name in tenants:
            entry: dict = {"queued": int(depth.get(name, 0))}
            if name in self.tenant_weights:
                entry["weight"] = self._weight(name)
            quota = self._quotas.get(name)
            if quota is not None:
                entry["quota"] = quota.stats()
            shed = int(self.over_quota_rejects.get(name, 0))
            if shed:
                entry["over_quota_rejects"] = shed
            out[name] = entry
        if self._registry is not None:
            # Aggregate per LABEL before setting: past the cap, many
            # tenants share "__other__", and last-writer-wins would
            # report one arbitrary tenant's depth instead of the sum.
            label_depth: collections.Counter = collections.Counter()
            for name in tenants:
                label_depth[self._tenant_label(name)] += depth.get(
                    name, 0)
            for label, d in label_depth.items():
                self._registry.gauge(
                    "scheduler_tenant_depth",
                    help="queued requests per tenant",
                    tenant=label).set(float(d))
        return out

    def debugz(self, now: float | None = None, limit: int = 64) -> dict:
        """Queue introspection for the ``debugz`` verb: depth plus the
        oldest ``limit`` queued requests in (priority, arrival) order
        with their ages — the page that answers "WHO is waiting and for
        how long" where the depth gauge only answers "how many" — and
        the per-tenant QoS table."""
        now = time.monotonic() if now is None else now
        items = sorted(
            ((req.priority, seq, req) for seq, req in self._iter_items()),
            key=lambda t: (t[0], t[1]))
        queued = []
        for prio, _, req in items[:int(limit)]:
            age = (now - req.t_submit) if req.t_submit is not None else 0.0
            entry = {
                "trace_id": req.trace_id,
                "tenant": req.tenant,
                "priority": prio,
                "age_s": round(age, 6),
                "prompt_tokens": len(req.prompt),
                "max_new_tokens": req.max_new_tokens,
            }
            if req.kind != "generate":
                entry["kind"] = req.kind
            if req.deadline is not None:
                entry["deadline_in_s"] = round(req.deadline - now, 6)
            queued.append(entry)
        return {
            "depth": self._n,
            "max_depth": self.max_depth,
            # Over the WHOLE queue, not just the listed window — the
            # starvation signal must survive a deep queue.
            "oldest_age_s": round(max(
                ((now - req.t_submit) for _, req in self._iter_items()
                 if req.t_submit is not None), default=0.0), 6),
            "queued": queued,
            "tenants": self.tenant_stats(),
        }

    def drain(self) -> list[Request]:
        """Remove and return everything queued (engine shutdown path),
        in (priority, arrival) order."""
        items = sorted(
            ((req.priority, seq, req) for seq, req in self._iter_items()),
            key=lambda t: (t[0], t[1]))
        out = [req for _, _, req in items]
        self._classes.clear()
        self._n = 0
        out.extend(self._expired_backlog)
        self._expired_backlog = []
        self._note_depth()
        return out

    async def wait_for_request(self, timeout: float | None = None) -> bool:
        """Block until something is submitted (or timeout); True if woken
        by an arrival."""
        if self._n:
            return True
        self._arrival.clear()
        try:
            await asyncio.wait_for(self._arrival.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def wait_for_wake(self, timeout: float | None = None) -> bool:
        """Like :meth:`wait_for_request` but WITHOUT the non-empty-queue
        shortcut: block until the next submit/kick (or timeout) even
        while requests are queued. The engine's fully-parked idle state
        (paged pool dry, queue head parked, zero active slots) waits
        here — ``wait_for_request`` would return immediately on the
        non-empty queue and the loop would hot-spin doing nothing but
        the park check. The clear-then-wait is race-free on one event
        loop: submits happen on the same loop, and no await separates
        the caller's park check from this clear."""
        self._arrival.clear()
        try:
            await asyncio.wait_for(self._arrival.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def kick(self) -> None:
        """Wake any waiter (e.g. so the engine loop notices shutdown)."""
        self._arrival.set()

    async def wait_for_kv_arrival(self, timeout: float | None = None) -> bool:
        """Block until KV blocks ARRIVE somewhere the parked head could
        use them (host-tier spill, tier re-admission, or a pushed/pulled
        peer import) — the tier-pending variant of :meth:`wait_for_wake`.
        A fully-parked admission whose prompt has blocks in flight waits
        here instead of polling ``pool.version`` each idle tick: the
        arrival wakes it immediately, and nothing else does (submits and
        kicks still land on the ordinary arrival event). Same race-free
        clear-then-wait as :meth:`wait_for_wake`."""
        self._kv_arrival.clear()
        try:
            await asyncio.wait_for(self._kv_arrival.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def note_kv_arrival(self) -> None:
        """Signal that KV bytes just landed in a tier (spill, re-admit,
        or peer import) — wakes both a tier-pending parked admission
        (:meth:`wait_for_kv_arrival`) and the ordinary idle wait, since
        an import also bumps ``pool.version``."""
        self._kv_arrival.set()
        self._arrival.set()

    def reset_loop_state(self) -> None:
        """Replace the arrival events: asyncio primitives bind to the loop
        they are first awaited on, so an engine reopened under a NEW event
        loop (multi-phase benches, sequential asyncio.run calls) needs
        fresh ones. Queued requests are untouched."""
        self._arrival = asyncio.Event()
        self._kv_arrival = asyncio.Event()
