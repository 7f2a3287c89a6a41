"""Per-request distributed tracing: trace ids, timeline records, stores.

Copy of the reference's ``distkeras_tpu/telemetry/request_trace.py``, which imports no JAX;
only its imports differ.

The spans answer "where does THIS PROCESS spend its wall clock"; they
cannot follow one request across the serving cluster's four processes
(client -> router -> replica server -> engine), where a retry, an
affinity spill, or a slow prefill on one hop is invisible from every
other hop's aggregate histograms. This module adds the request-scoped
layer:

- **trace ids** — :func:`new_trace_id` mints a short opaque id; the
  client generates one per request (or the router mints one for clients
  that don't) and it rides the JSONL protocol end to end, so every hop
  tags its spans, events, and error lines with the same id;
- **timeline records** (:class:`TimelineRecord`) — one per request per
  hop: an ordered event list (submit, admit with queue wait, prefill
  chunks with device time, first token, terminal status) plus summary
  data (cache-hit tokens, decode iterations, retries/replica hops).
  The engine assembles one per served request; the router assembles one
  per routed request with its dispatch/retry events;
- **stores** (:class:`TraceStore`) — bounded per-process map of
  completed records by trace id, queryable over the wire via the
  ``tracez`` control verb; the router's ``tracez`` merges its own record
  with every replica's into ONE cross-process trace
  (:func:`merge_trace`);
- **Chrome export** (:func:`chrome_trace`) — renders records in the same
  ``traceEvents`` JSON the span tracer emits, ONE LANE PER REQUEST
  (``tid`` = request), so Perfetto shows a swimlane per request with its
  queue wait, prefill chunks, and decode phase laid end to end.

Cost stance: everything here is **per-request**, never per-token — a
record is a list of a dozen small events over a request's lifetime.  The
per-token hot path (the decode loop's ``_push_token``) never touches a
timeline; with no store or recorder configured the engine skips record
construction entirely, keeping the spans' disabled-path bar.

Timestamps are ``time.time()`` (wall clock): cross-process merging needs
one clock every hop shares, and NTP-level skew is fine at the >= 1 ms
granularity request phases live at. Durations inside one process are
measured monotonically by their publishers and attached as ``dur_s``
attrs, so skew never corrupts a span's length.
"""

from __future__ import annotations

import binascii
import json
import os
import threading
import time
from collections import OrderedDict

__all__ = [
    "new_trace_id",
    "sanitize_trace_id",
    "TimelineRecord",
    "TailRetention",
    "TraceStore",
    "merge_trace",
    "chrome_trace",
    "export_chrome_trace",
]


def new_trace_id() -> str:
    """16 hex chars of OS randomness: unique enough for a fleet's
    retention window, short enough to read aloud off a log line."""
    return binascii.hexlify(os.urandom(8)).decode()


def sanitize_trace_id(trace_id) -> str | None:
    """The ONE sanitizer for wire-supplied trace ids (Request ctor, the
    router's minting path, the server's error lines all use it): cap the
    length against junk, and strip ``#`` — :class:`TraceStore` uses
    ``<id>#<n>`` keys for duplicate hops, so a client-chosen id
    containing ``#`` could address ANOTHER request's hop records. None
    for empty/falsy input (callers mint a fresh id)."""
    if not trace_id:
        return None
    tid = str(trace_id).replace("#", "")[:64]
    return tid or None


class TimelineRecord:
    """One request's life on one hop: ordered events plus summary data.

    ``role`` is ``"engine"`` (a replica's serving engine) or ``"router"``
    (the cluster front port); ``source`` identifies the process/replica
    (e.g. ``"r0"``, ``"engine:pid4242"``). Events are
    ``[name, wall_ts, attrs-or-None]`` triples appended in order by the
    single owner (the engine loop or the router handler — no locking
    needed until the record is finalized into a :class:`TraceStore`).
    """

    __slots__ = ("trace_id", "role", "source", "t_start", "events", "data")

    def __init__(self, trace_id: str, role: str, source: str = ""):
        self.trace_id = trace_id
        self.role = role
        self.source = source
        self.t_start = time.time()
        self.events: list[list] = []
        self.data: dict = {}

    def event(self, name: str, **attrs) -> None:
        """Append one event at the current wall clock. ``dur_s`` in attrs
        marks a timed phase (rendered as a Chrome complete event whose
        START is ``ts - dur_s``); other attrs are annotations."""
        self.events.append([name, time.time(), attrs or None])

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "role": self.role,
            "source": self.source,
            "t_start": self.t_start,
            "events": [list(e) for e in self.events],
            "data": dict(self.data),
        }


class TailRetention:
    """Done-time keep/discard scorer for finished timelines.

    A bounded trace ring under hot traffic evicts exactly the records an
    operator wants: the errors, the SLO breaches, the latency tail. This
    scorer decides AT COMPLETION — when a request's whole story is known
    — whether its timeline is worth holding past the sliding window,
    returning a keep reason or ``None`` (bulk discard, dropped early):

    - ``"error"`` — terminal status other than ok: always kept;
    - ``"slo"`` — the engine's SLO verdict said slow: always kept;
    - ``"tail"`` — latency at/above the running ``tail_q`` percentile
      of ITS KIND (per-kind, so a batch scoring job's normal minutes
      don't drown interactive sampling's abnormal seconds), after a
      ``warmup`` of samples for that kind;
    - ``"rare"`` — one of the first ``rare_below`` completions for its
      (tenant, kind) pair: a new tenant's first requests are kept even
      when perfectly healthy, because "what did it look like when it
      started" is exactly what gets asked later;
    - ``"baseline"`` — a deterministic 1-in-``baseline_every`` counter
      sample of healthy traffic (a counter, not an RNG, so tests and
      replays see the same keeps).

    Reasons are priority-ordered (:data:`REASON_PRIORITY`, lower keeps
    longer) for the keeper reservoir's eviction; latency tracking uses
    the same fixed histogram layout the wide-event store queries with,
    so "the tail" here and a ``queryz`` p-tail agree bucket-for-bucket.
    """

    #: Eviction order within a full keeper reservoir: higher numbers
    #: evict first. ``pinned`` is assigned by the store, never here.
    REASON_PRIORITY = {"pinned": 0, "error": 1, "slo": 2, "tail": 3,
                       "rare": 4, "baseline": 5}

    def __init__(self, tail_q: float = 90.0, warmup: int = 20,
                 rare_below: int = 3, baseline_every: int = 32):
        if not 0.0 < tail_q < 100.0:
            raise ValueError(f"tail_q must be in (0, 100), got {tail_q}")
        self.tail_q = float(tail_q)
        self.warmup = max(1, int(warmup))
        self.rare_below = max(0, int(rare_below))
        self.baseline_every = max(1, int(baseline_every))
        self._lock = threading.Lock()
        self._seen = 0
        self._pair_counts: dict[tuple, int] = {}
        self._kind_hists: dict[str, object] = {}

    def _kind_hist(self, kind: str):
        h = self._kind_hists.get(kind)
        if h is None:
            # Deferred import: registry is dependency-free but this
            # module is imported by crash tooling that wants the
            # cheapest possible import graph.
            from distkeras_tpu_torch.telemetry.registry import Histogram
            from distkeras_tpu_torch.telemetry.wide_events import (
                WIDE_HIST_BUCKETS)
            h = Histogram("trace_retention_latency",
                          buckets=WIDE_HIST_BUCKETS, labels={"kind": kind})
            self._kind_hists[kind] = h
        return h

    def score(self, rec: dict) -> str | None:
        """Keep reason for one finished record dict (reads its ``data``
        summary: status / slo_violation / latency_s / tenant / kind),
        or None. Also feeds the running per-kind latency and rarity
        state — call exactly once per finished record."""
        data = rec.get("data") or {}
        kind = str(data.get("kind", ""))
        tenant = str(data.get("tenant", ""))
        latency = data.get("latency_s")
        with self._lock:
            self._seen += 1
            baseline = (self._seen % self.baseline_every) == 0
            pair = (tenant, kind)
            pair_n = self._pair_counts.get(pair, 0) + 1
            self._pair_counts[pair] = pair_n
            tail = False
            if latency is not None:
                h = self._kind_hist(kind)
                if h.count >= self.warmup:
                    tail = float(latency) >= h.percentile(self.tail_q)
                h.observe(float(latency),
                          exemplar=rec.get("trace_id"))
        if str(data.get("status", "ok")) != "ok":
            return "error"
        if data.get("slo_violation"):
            return "slo"
        if tail:
            return "tail"
        if pair_n <= self.rare_below:
            return "rare"
        if baseline:
            return "baseline"
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"seen": self._seen,
                    "tenant_kind_pairs": len(self._pair_counts),
                    "kinds": sorted(self._kind_hists)}


class TraceStore:
    """Bounded per-process store of finished timeline records.

    Insertion-ordered with oldest-first eviction past ``capacity`` —
    long-lived servers keep a sliding window of recent requests, never an
    unbounded map (the exact failure mode the span tracer's
    ``max_events`` bounds against). Stores plain dicts so ``get`` replies
    are JSON-ready for the ``tracez`` verb. Thread-safe: the engine loop
    finalizes records while control handlers read them.

    With a :class:`TailRetention` attached, blind overwrite stops being
    the only policy: every finished record is scored at put-time, and
    keepers (errors, SLO breaches, latency tail, rare tenants/kinds, a
    1/N baseline) survive in a separate bounded reservoir after the
    sliding window has rolled past them — evicted keeper-priority-then-
    oldest when the reservoir fills. :meth:`pin` marks trace ids (SLO
    page-event exemplars) that must NEVER be evicted: a page alert's
    linked traces stay retrievable for as long as the process lives,
    regardless of traffic volume.
    """

    def __init__(self, capacity: int = 512,
                 retention: TailRetention | None = None,
                 keeper_capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if keeper_capacity < 1:
            raise ValueError(
                f"keeper_capacity must be >= 1, got {keeper_capacity}")
        self.capacity = int(capacity)
        self.retention = retention
        self.keeper_capacity = int(keeper_capacity)
        self._lock = threading.Lock()
        self._records: OrderedDict[str, dict] = OrderedDict()
        # key -> (record, reason); insertion-ordered so eviction can
        # take "oldest of the worst reason" deterministically.
        self._keepers: OrderedDict[str, tuple] = OrderedDict()
        self._pinned: set[str] = set()
        self.evicted = 0
        self.kept = 0
        self.keeper_evicted = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def put(self, record: "TimelineRecord | dict") -> None:
        rec = record.to_dict() if isinstance(record, TimelineRecord) else record
        tid = rec.get("trace_id")
        if not tid:
            return
        reason = (self.retention.score(rec)
                  if self.retention is not None else None)
        with self._lock:
            # A retried request revisits one trace_id on a second hop of
            # the SAME store only in single-process (LocalReplica) tests;
            # keep hops distinguishable by source-suffixing duplicates.
            key = tid
            n = 1
            while key in self._records or key in self._keepers:
                key = f"{tid}#{n}"
                n += 1
            if tid in self._pinned:
                reason = "pinned"
            if reason is not None:
                self._keepers[key] = (rec, reason)
                self.kept += 1
                self._evict_keepers_locked()
            self._records[key] = rec
            while len(self._records) > self.capacity:
                self._records.popitem(last=False)
                self.evicted += 1

    def _evict_keepers_locked(self) -> None:
        """Shrink the keeper reservoir to capacity: pinned entries are
        exempt; among the rest, drop the oldest record of the WORST
        (highest-numbered) reason present."""
        prio = TailRetention.REASON_PRIORITY
        while True:
            unpinned = [(key, reason)
                        for key, (rec, reason) in self._keepers.items()
                        if reason != "pinned"]
            if len(unpinned) <= self.keeper_capacity:
                return
            worst = max(prio.get(r, 99) for _, r in unpinned)
            for key, reason in unpinned:  # insertion order = oldest first
                if prio.get(reason, 99) == worst:
                    del self._keepers[key]
                    self.keeper_evicted += 1
                    break

    def pin(self, trace_id: str) -> bool:
        """Mark ``trace_id`` never-evictable (SLO page exemplars). Any
        hop records currently in the sliding window are promoted into
        the keeper reservoir immediately — pinning after the fact would
        otherwise race the window rolling past them. Future puts of the
        id are kept as pinned too. True when the id is now pinned (it
        need not be present yet: pin-before-arrival is how the router
        protects exemplars of requests other replicas served)."""
        tid = sanitize_trace_id(trace_id)
        if not tid:
            return False
        with self._lock:
            self._pinned.add(tid)
            for key, rec in self._records.items():
                if key == tid or key.startswith(f"{tid}#"):
                    cur = self._keepers.get(key)
                    self._keepers[key] = (rec, "pinned")
                    if cur is None:
                        self.kept += 1
            # A record already held as a keeper (e.g. as "tail") but
            # rolled out of the window upgrades in place.
            for key, (rec, reason) in list(self._keepers.items()):
                if reason != "pinned" and (
                        key == tid or key.startswith(f"{tid}#")):
                    self._keepers[key] = (rec, "pinned")
        return True

    def pinned(self) -> list[str]:
        with self._lock:
            return sorted(self._pinned)

    def get(self, trace_id: str) -> dict | None:
        """The record for ``trace_id`` (the FIRST hop when duplicated);
        see :meth:`get_all` for every hop recorded under the id."""
        hops = self.get_all(trace_id)
        return hops[0] if hops else None

    def get_all(self, trace_id: str) -> list[dict]:
        with self._lock:
            out, seen = [], set()
            for key, rec in self._records.items():
                if key == trace_id or key.startswith(f"{trace_id}#"):
                    out.append(rec)
                    seen.add(key)
            for key, (rec, _reason) in self._keepers.items():
                if key in seen:
                    continue
                if key == trace_id or key.startswith(f"{trace_id}#"):
                    out.append(rec)
            return out

    def recent(self, n: int = 20) -> list[dict]:
        n = int(n)
        if n <= 0:  # recs[-0:] would be the WHOLE store
            return []
        with self._lock:
            recs = list(self._records.values())
        return recs[-n:]

    def keepers(self, n: int | None = None, reason: str | None = None) \
            -> list[dict]:
        """Keeper-reservoir records (newest last), each annotated with
        its ``keep_reason``; optionally only one reason class."""
        with self._lock:
            out = []
            for rec, r in self._keepers.values():
                if reason is not None and r != reason:
                    continue
                annotated = dict(rec)
                annotated["keep_reason"] = r
                out.append(annotated)
        return out[-int(n):] if n else out

    def stats(self) -> dict:
        with self._lock:
            by_reason: dict[str, int] = {}
            for _rec, r in self._keepers.values():
                by_reason[r] = by_reason.get(r, 0) + 1
            out = {"records": len(self._records),
                   "capacity": self.capacity, "evicted": self.evicted}
            if self.retention is not None or self._keepers or self._pinned:
                out.update({
                    "keepers": len(self._keepers),
                    "keeper_capacity": self.keeper_capacity,
                    "keeper_evicted": self.keeper_evicted,
                    "kept": self.kept,
                    "pinned": len(self._pinned),
                    "keep_reasons": by_reason,
                })
            return out

    def export_chrome_trace(self, path: str, n: int | None = None) -> str:
        """Write the store's (most recent ``n``) records as Chrome-trace
        JSON, one lane per request hop."""
        recs = self.recent(n if n is not None else self.capacity)
        return export_chrome_trace(recs, path)


def merge_trace(trace_id: str, records) -> dict:
    """Assemble hop records (router + engines, dicts or
    :class:`TimelineRecord`) into ONE cross-process trace: the router
    record, engine hops ordered by start time, and a single
    wall-clock-sorted event list tagged with each event's source."""
    recs = []
    for r in records or []:
        if r is None:
            continue
        rec = r.to_dict() if isinstance(r, TimelineRecord) else r
        if rec.get("trace_id") == trace_id:
            recs.append(rec)
    routers = sorted((r for r in recs if r.get("role") == "router"),
                     key=lambda r: r.get("t_start", 0.0))
    engines = sorted((r for r in recs if r.get("role") == "engine"),
                     key=lambda r: r.get("t_start", 0.0))
    events = []
    for rec in recs:
        src = f"{rec.get('role', '?')}:{rec.get('source', '')}"
        for name, ts, attrs in rec.get("events", []):
            events.append([ts, src, name, attrs])
    events.sort(key=lambda e: e[0])
    return {
        "trace_id": trace_id,
        "router": routers[0] if routers else None,
        "engine_hops": engines,
        "hops": [e.get("source", "") for e in engines],
        "events": events,
    }


def chrome_trace(records) -> dict:
    """Records (or one merged trace) as Chrome ``traceEvents`` JSON —
    the format the span tracer already emits, loadable in Perfetto —
    with ONE LANE PER REQUEST HOP: ``tid`` is the hop, named
    ``<trace_id>:<role>:<source>``. Events carrying ``dur_s`` become
    complete (``X``) slices ending at their timestamp; the rest are
    instants, so a lane reads submit -> [queue] -> [prefill chunks] ->
    first_token -> done left to right."""
    recs = []
    for r in records or []:
        if isinstance(r, TimelineRecord):
            recs.append(r.to_dict())
        elif isinstance(r, dict) and "engine_hops" in r:  # merged trace
            recs.extend(x for x in
                        ([r.get("router")] + list(r.get("engine_hops", [])))
                        if x)
        elif isinstance(r, dict):
            recs.append(r)
    pid = os.getpid()
    out = []
    for tid_num, rec in enumerate(recs):
        lane = (f"{rec.get('trace_id', '?')[:16]}:{rec.get('role', '?')}"
                f":{rec.get('source', '')}")
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid_num, "args": {"name": lane}})
        for name, ts, attrs in rec.get("events", []):
            us = round(ts * 1e6, 3)
            args = dict(attrs) if attrs else {}
            dur = args.pop("dur_s", None)
            ev = {"name": name, "pid": pid, "tid": tid_num}
            if args or rec.get("trace_id"):
                args.setdefault("trace_id", rec.get("trace_id"))
                ev["args"] = args
            if dur is not None:
                ev.update(ph="X", ts=round(us - float(dur) * 1e6, 3),
                          dur=round(float(dur) * 1e6, 3))
            else:
                ev.update(ph="i", ts=us, s="t")
            out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(records, path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(records), f)
    return path
