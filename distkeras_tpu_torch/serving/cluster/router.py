"""Asyncio router: one front port over N serving replicas.

Copy of the reference's ``distkeras_tpu/serving/cluster/router.py``,
which imports no JAX; only its imports differ.

Speaks the SAME newline-delimited-JSON protocol as a single
:class:`~distkeras_tpu_torch.serving.server.ServingServer`, so every existing
client (``ServingClient``, ``nc``, the bench) points at a cluster by
changing nothing but the port. Per generation request the router:

1. **picks a replica**: least-outstanding-requests, biased by
   **prefix-cache affinity** — the first ``affinity_tokens`` prompt
   tokens hash to a *prompt family*, and rendezvous hashing pins each
   family to a stable READY replica so the radix-trie prefix cache
   keeps hitting (the same system prompt always lands where its KV
   blocks live). The pin yields to plain least-outstanding when the
   preferred replica is more than ``affinity_slack`` requests busier
   than the least-loaded one — affinity is a tiebreak, not a hotspot
   generator;
2. **relays the stream** token-line by token-line;
3. **retries idempotent work**: if the backend dies (connection drop, or
   a replica-side failure/shutdown error) while the request has streamed
   ZERO tokens, the request is re-dispatched to a surviving replica —
   the client never notices. Once tokens have streamed the request is
   not idempotent (the client has partial output) and the stream ends
   with a typed ``replica_lost`` error. Backend loss is also reported to
   the supervisor so the restart starts now, not at the next health
   tick.

Control verbs aggregate across the fleet: ``healthz`` returns the
replica table plus each live replica's own healthz; ``metricsz`` returns
the router's registry plus each replica's snapshot keyed by replica id
(``format="prometheus"`` returns the router's page FOLLOWED by the
fleet-merged page built from pushed replica histograms — one scrape
target covers the fleet; the table's host/port still provides
per-replica targets for drill-down).

**Fleet telemetry plane**: instead of poll-time aggregation on
hot signals, each replica PUSHES compact metric deltas to the router on
a cadence — a ``telemetry_start`` control frame opens one long-lived
stream per bin1 replica and ``T_TELEM`` frames ride the existing mux;
JSONL-only replicas are polled with the ``telemetryz`` verb on the same
cadence. The router folds deltas into fleet-level mergeable histograms
(:class:`~distkeras_tpu_torch.telemetry.timeseries.FleetAggregator`), keeps
windowed aggregates in a ring-buffer store, and runs an SRE-style SLO
burn-rate engine (:mod:`distkeras_tpu_torch.serving.slo`) over them — the
``sloz`` verb serves its state machine, burn rates, and breach
exemplars; ``healthz`` carries the one-word overall state.

``{"cmd": "reload", "weights": path}`` performs the **zero-downtime
rolling reload**: one replica at a time is marked DRAINING (the router
stops sending it new work), its outstanding count is drained to zero,
the replica-side ``reload`` verb swaps params from the checkpoint path
(flushing its prefix cache and rewarming one decode tick), and the
replica is readmitted — the cluster never serves fewer than N-1
replicas and no client stream is ever cut.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time
import zlib

from distkeras_tpu_torch.serving import wire
from distkeras_tpu_torch.serving.cluster.replicas import (
    DRAINING,
    READY,
    ReplicaInfo,
)
from distkeras_tpu_torch.serving.cluster.supervisor import ReplicaSupervisor
from distkeras_tpu_torch.serving.slo import SLOEngine
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.telemetry.timeseries import (
    FleetAggregator,
    TimeSeriesStore,
)
from distkeras_tpu_torch.telemetry.request_trace import (
    TailRetention,
    TimelineRecord,
    TraceStore,
    merge_trace,
    new_trace_id,
    sanitize_trace_id,
)
from distkeras_tpu_torch.telemetry.wide_events import merge_query_results

__all__ = ["Router", "ServingCluster"]

# Backend error codes that are safe to retry on another replica while
# zero tokens have streamed: the work provably never produced output.
# "stopped"/"error" are replica-side failures, "queue_full" is one
# replica's backpressure (another may have room), "busy" is a replica
# mid-reload. "timeout" (the request's own deadline) and "bad_request"
# (deterministic) are NOT retried.
_RETRYABLE_CODES = frozenset({"stopped", "error", "queue_full", "busy"})


class _BackendLost(Exception):
    """The backend connection died mid-request (EOF or reset)."""


class _ClientGone(Exception):
    """The CLIENT connection died mid-relay. Deliberately not an OSError
    subclass: _relay's backend-failure handler must never swallow it — a
    walked-away client is not a replica failure and must not feed the
    supervisor's death detection or burn a retry."""


class _RelayCtl:
    """Migration handle for one in-flight classic relay: the rolling
    reload's drain-by-migration path flips ``migrating`` and calls
    ``fire`` (queue a sentinel on a mux relay, close the backend
    connection on a jsonl relay); the relay then returns the
    ``"migrate"`` outcome with the tokens it streamed this hop, and the
    dispatch loop re-dispatches the request elsewhere with those tokens
    folded in as a resume."""

    __slots__ = ("fire", "migrating")

    def __init__(self, fire):
        self.fire = fire
        self.migrating = False


class _PooledConn:
    """One pooled backend connection plus the negotiation state it was
    created under. ``generation`` is the replica incarnation the
    connection was dialed against — checkout re-verifies it, so a
    replica restarted onto the SAME port can never be handed a socket
    (or a half-done handshake) from its previous life."""

    __slots__ = ("reader", "writer", "generation", "proto")

    def __init__(self, reader, writer, generation: int,
                 proto: str = wire.PROTO_JSONL):
        self.reader = reader
        self.writer = writer
        self.generation = generation
        self.proto = proto


class _FastStream:
    """One request on the router's zero-task fast path: a bin1 client
    stream switched straight onto a replica's mux. The mux read loop
    calls :meth:`on_frame` synchronously — token deltas and the DONE
    payload are RE-FRAMED (never re-encoded) into the client
    connection's coalescing sink, so the steady-state per-request cost
    is a few dict operations and buffer appends, with no task, no
    queue, and no JSON on the done path. Failure cases (backend loss,
    retryable reject with zero streamed tokens) hand the request to the
    classic slow-path dispatch, which owns retry/exclusion — rare by
    construction, so its task cost doesn't gate the ceiling."""

    __slots__ = ("router", "sink", "csid", "payload", "info", "mux",
                 "bsid", "streamed", "registry")

    def __init__(self, router, sink, csid, payload, info, mux, registry):
        self.router = router
        self.sink = sink
        self.csid = csid
        self.payload = payload
        self.info = info
        self.mux = mux
        self.bsid = None
        self.streamed = 0
        self.registry = registry  # this client connection's live table

    def _finish(self) -> None:
        self.info.outstanding -= 1
        self.registry.pop(self.csid, None)
        if self.bsid is not None:
            self.mux.release(self.bsid)

    def abandon(self) -> None:
        """Client cancelled / connection closed: stop the backend work."""
        self.info.outstanding -= 1
        self.registry.pop(self.csid, None)
        if self.bsid is not None:
            self.mux.cancel(self.bsid)

    def on_frame(self, ftype, payload) -> None:
        if ftype == wire.T_TOK:
            self.streamed += len(payload) // 4
            if self.sink.closed:
                # Client walked away mid-stream: cancel server-side
                # instead of decoding for nobody.
                self.abandon()
                return
            # Verbatim relay: the payload is already wire-format int32s.
            self.sink.forward_tokens(self.csid, payload)
        elif ftype == wire.T_DONE:
            self._finish()
            self.sink.send_raw(wire.T_DONE, self.csid, payload)
        elif ftype == wire.T_ERR:
            rec = wire.decode_json(payload)
            if self.streamed == 0 \
                    and rec.get("code") in _RETRYABLE_CODES:
                self._finish()
                self.router._fast_failover(self, rec)
                return
            self._finish()
            self.sink.send_raw(wire.T_ERR, self.csid, payload)
        else:  # ftype None: mux died
            self.info.outstanding -= 1
            self.registry.pop(self.csid, None)
            self.bsid = None
            self.router.supervisor.note_failure(self.info.rid)
            if self.streamed == 0:
                self.router._fast_failover(self, None)
            else:
                if self.router._c_lost is not None:
                    self.router._c_lost.inc()
                self.sink.send_error(self.csid, {
                    "error": f"replica {self.info.rid} lost after "
                             f"{self.streamed} streamed tokens",
                    "code": "replica_lost"})


class _JsonClientSink:
    """Client-facing output for a JSONL connection: one line per token,
    one line for the terminal record — the original wire behavior."""

    __slots__ = ("_writer",)

    def __init__(self, writer):
        self._writer = writer

    async def tokens(self, toks) -> None:
        for t in toks:
            await Router._send_client(self._writer, {"token": int(t)})

    async def final(self, rec: dict) -> None:
        await Router._send_client(self._writer, rec)


class _BinClientSink:
    """Client-facing output for one bin1 stream: token deltas go through
    the connection's shared coalescing :class:`wire.FrameSink` (one
    write per flush interval across ALL streams), terminal records as
    DONE/ERR frames."""

    __slots__ = ("_sink", "_sid")

    def __init__(self, sink: "wire.FrameSink", sid: int):
        self._sink = sink
        self._sid = sid

    async def tokens(self, toks) -> None:
        if self._sink.closed:
            raise _ClientGone()
        self._sink.add_tokens(self._sid, toks)

    async def final(self, rec: dict) -> None:
        if self._sink.closed:
            raise _ClientGone()
        if rec.get("done"):
            self._sink.send_done(self._sid, rec)
        else:
            self._sink.send_error(self._sid, rec)


class _BackendMux:
    """ONE bin1 connection to a replica carrying every in-flight stream
    the router routes there — the front door's core restructuring: the
    per-request exclusive pooled socket (and its per-token readline)
    becomes stream frames multiplexed over a single connection, so a
    decode tick's tokens for N requests arrive in a handful of reads
    and leave in coalesced writes.

    Per-stream events are delivered by CALLBACK — ``handler(ftype,
    payload)`` with the raw frame payload, or ``handler(None, None)``
    when the connection dies (every open stream is failed at once — the
    dispatcher's retry logic treats it exactly like a dropped exclusive
    connection). The router's fast path installs a zero-task forwarding
    handler; the slow path adapts the callback onto a queue."""

    def __init__(self, key, reader, writer):
        self.key = key
        self.reader = reader
        self.writer = writer
        self.dead = False
        self.streams: dict[int, object] = {}  # sid -> handler callable
        self._sid = itertools.count(1)
        self._out = bytearray()
        self._wscheduled = False
        self._kick = asyncio.Event()
        loop = asyncio.get_running_loop()
        self._reader_task = loop.create_task(self._read_loop())
        self._drain_task = loop.create_task(self._drain_loop())

    def open(self, handler) -> int:
        if self.dead:
            raise _BackendLost("mux connection is dead")
        sid = next(self._sid)
        self.streams[sid] = handler
        return sid

    def enqueue(self, frame: bytes) -> None:
        """Buffer one outgoing frame; every frame enqueued in the same
        event-loop tick leaves in ONE write — the batched-forwarding
        half of batched admission."""
        self._out += frame
        if not self._wscheduled and not self.dead:
            self._wscheduled = True
            asyncio.get_running_loop().call_soon(self._wflush)

    _MAX_BUFFER = 32 * 2 ** 20

    def _wflush(self) -> None:
        self._wscheduled = False
        if self.dead or not self._out:
            return
        data = bytes(self._out)
        self._out.clear()
        try:
            transport = self.writer.transport
            if transport is not None and (
                    transport.get_write_buffer_size() + len(data)
                    > self._MAX_BUFFER):
                # A replica that stopped reading is a dead replica:
                # failing the mux (streams retry / report lost) is the
                # bounded outcome, buffering toward OOM is not.
                self.fail("backend stopped reading (write buffer over "
                          "the cap)")
                return
            self.writer.write(data)
        except (ConnectionResetError, BrokenPipeError, OSError,
                RuntimeError) as e:
            self.fail(f"write failed: {e}")
            return
        self._kick.set()

    def send_req(self, sid: int, spec: dict) -> None:
        """Queue one REQ frame; may raise :class:`wire.WireError` on a
        spec binary encoding can't express (malformed prompt — the
        caller maps it to the same typed bad_request a replica would
        send)."""
        payload = wire.encode_request(spec)
        if self.dead:
            raise _BackendLost("mux connection is dead")
        self.enqueue(wire.encode_frame(wire.T_REQ, sid, payload))

    def cancel(self, sid: int) -> None:
        """Tell the replica to abandon one stream (client gone / dispatch
        cancelled) — a mux can't signal by closing the shared socket."""
        self.streams.pop(sid, None)
        if not self.dead:
            self.enqueue(wire.encode_frame(wire.T_CANCEL, sid, b""))

    def release(self, sid: int) -> None:
        self.streams.pop(sid, None)

    def fail(self, why: str) -> None:
        if self.dead:
            return
        self.dead = True
        self._out.clear()
        streams, self.streams = self.streams, {}
        for handler in streams.values():
            try:
                handler(None, None)
            except Exception:
                pass  # one stream's cleanup must not strand the rest
        self._kick.set()
        try:
            self.writer.close()
        except Exception:
            pass

    async def close(self) -> None:
        self.fail("closed")
        for task in (self._reader_task, self._drain_task):
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    async def _drain_loop(self) -> None:
        try:
            while not self.dead:
                await self._kick.wait()
                self._kick.clear()
                await self.writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError,
                asyncio.CancelledError, RuntimeError):
            self.fail("drain failed")

    async def _read_loop(self) -> None:
        decoder = wire.FrameDecoder()
        try:
            while True:
                data = await self.reader.read(2 ** 18)
                if not data:
                    self.fail("backend closed the connection")
                    return
                for ftype, sid, payload in decoder.feed(data):
                    handler = self.streams.get(sid)
                    if handler is None:
                        continue  # late frames of a cancelled stream
                    handler(ftype, payload)
        except asyncio.CancelledError:
            raise
        except (OSError, wire.WireError, ValueError) as e:
            self.fail(f"read failed: {e}")


class Router:
    """Front-port router over a :class:`ReplicaSupervisor`'s table.

    ``affinity_tokens``: prompt-family prefix length for cache affinity —
    match it to the backend engines' ``prefix_block_tokens`` (a family
    shorter than one cache block can't pin what the trie shares).
    ``affinity_slack``: max outstanding-request imbalance the pin may
    create before least-outstanding wins.
    ``max_retries``: re-dispatch budget for zero-streamed requests.
    ``pick_wait_s``: how long a dispatch waits for ANY replica to be
    READY (rolling restarts) before failing with ``unavailable``.
    ``trace_capacity``: bound of the router's per-request timeline store
    (dispatch/retry/terminal events per routed request, merged with the
    replicas' engine records by the ``tracez`` verb); 0 disables routing
    timelines. Default ON: the cost is a handful of per-REQUEST event
    appends — the per-token relay path records nothing.
    """

    def __init__(
        self,
        supervisor: ReplicaSupervisor,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        affinity_tokens: int = 16,
        affinity_slack: int = 4,
        max_retries: int = 2,
        pick_wait_s: float = 10.0,
        pool_size: int = 8,
        connect_timeout_s: float = 5.0,
        registry=None,
        trace_capacity: int = 512,
        wire_mode: str = "auto",
        flush_interval_s: float = 0.0,
        kv_prefill_timeout_s: float = 60.0,
        min_handoff_tokens: int | None = None,
        kv_push: bool = False,
        telemetry_interval_s: float = 0.25,
        telemetry_window_s: float = 0.5,
        slo_objectives=None,
        slo_kwargs: dict | None = None,
    ):
        if wire_mode not in ("auto", "jsonl"):
            raise ValueError(
                f"wire_mode must be 'auto' or 'jsonl', got {wire_mode!r}")
        self.supervisor = supervisor
        self.host = host
        self._requested_port = port
        self.affinity_tokens = int(affinity_tokens)
        self.affinity_slack = int(affinity_slack)
        self.max_retries = int(max_retries)
        self.pick_wait_s = float(pick_wait_s)
        self.pool_size = int(pool_size)
        self.connect_timeout_s = float(connect_timeout_s)
        # Front-door protocol policy, BOTH directions: "auto" accepts
        # the bin1 upgrade from clients and offers it to replicas (per
        # replica, falling back to jsonl for old ones); "jsonl" pins
        # everything to the original protocol (the rollback knob).
        self.wire_mode = wire_mode
        self.flush_interval_s = float(flush_interval_s)
        # Tail-based retention on the routing hops too: a dispatch that
        # ended in replica_lost/error is exactly the record a post-
        # mortem wants, and it must outlive the sliding window.
        self.trace_store = (TraceStore(trace_capacity,
                                       retention=TailRetention())
                            if trace_capacity else None)
        # SLO page exemplars already pinned fleet-wide (dedup so each
        # burn-rate transition's trace ids are pushed exactly once).
        self._slo_pinned: set[str] = set()
        # A DeployController (distkeras_tpu_torch.deploy) registers itself
        # here; the router then answers the ``deployz`` verb with its
        # state page. None = verb replies bad_request.
        self.deploy_controller = None
        self._server: asyncio.AbstractServer | None = None
        # Idle backend connections, keyed by (rid, port, generation): a
        # restarted replica bumps its generation even when the OS hands
        # it the SAME port back, so a stale pool is never hit again —
        # and checkout re-verifies the entry's recorded negotiation
        # state besides (belt and braces for hand-built tables).
        self._pools: dict[tuple[str, int, int], list[_PooledConn]] = {}
        # One multiplexed bin1 connection per replica incarnation, for
        # generation streams (control verbs keep pooled JSONL conns —
        # they are rare and aggregate-bound, not hot).
        self._muxes: dict[tuple[str, int, int], _BackendMux] = {}
        self._mux_locks: dict[str, asyncio.Lock] = {}
        # Strong refs for fast-path failover dispatch tasks (a bare
        # create_task result can be garbage-collected mid-flight).
        self._failover_tasks: set[asyncio.Task] = set()
        self._reload_lock = asyncio.Lock()
        # Disaggregated serving: bound on one prefill-replica handoff
        # (kv_prefill is a full prompt prefill — slower than a health
        # verb, still bounded so a wedged prefill replica costs one
        # timeout + fallback, never a hung dispatch), and the minimum
        # prompt length worth handing off (shorter prompts can't fill
        # one KV block; default: affinity_tokens).
        self.kv_prefill_timeout_s = float(kv_prefill_timeout_s)
        self.min_handoff_tokens = (self.affinity_tokens
                                   if min_handoff_tokens is None
                                   else int(min_handoff_tokens))
        # Fleet cache directory: prefix family -> which replica OWNS
        # the family's KV (its prefill/tier home) and which replicas
        # already HOLD a copy (adopted via push or pull). Entries
        # record the incarnation generation they were learned under;
        # lookups validate lazily against the supervisor (a dead or
        # restarted replica's claims are dropped, counted). With
        # ``kv_push`` on, the router schedules a P→D push right after
        # each handoff — the decode dispatch carries ``kv_wait``
        # instead of ``kv_from`` and the transfer overlaps the decode
        # replica's work on earlier requests; a decode replica that
        # already holds the family skips the transfer entirely.
        self.kv_push = bool(kv_push)
        self._kv_directory: dict[int, dict] = {}
        self._push_tasks: set[asyncio.Task] = set()
        supervisor.on_replica_death.append(self._forget_replica)
        # Fleet telemetry plane: replicas push metric deltas here on
        # ``telemetry_interval_s`` (0 disables the whole plane); the
        # aggregator folds them into fleet-merged histograms and the
        # windowed store; the SLO engine runs burn rates over the store.
        # Push subscriptions are keyed per incarnation — a restarted
        # replica is re-subscribed, a JSONL-only one is polled.
        self.telemetry_interval_s = float(telemetry_interval_s)
        self.fleet = FleetAggregator(
            TimeSeriesStore(window_s=float(telemetry_window_s)))
        self.slo = SLOEngine(self.fleet.store,
                             objectives=slo_objectives,
                             **(slo_kwargs or {}))
        self._telem_subs: dict[str, tuple[int, int]] = {}
        self._telem_task: asyncio.Task | None = None
        # In-flight classic relays per replica — what the rolling
        # reload's drain-by-migration fires. rid -> set[_RelayCtl].
        self._inflight: dict[str, set] = {}
        self.registry = registry
        self._c_requests = self._c_retries = self._c_affinity = None
        self._c_affinity_spill = self._c_lost = self._c_unavailable = None
        self._c_reloads = None
        self._c_handoffs = self._c_handoff_fallbacks = None
        self._c_migrations = None
        self._c_pushes = self._c_push_fallbacks = None
        self._c_push_bytes = self._c_push_saved_bytes = None
        self._c_dir_hits = self._c_dir_evictions = None
        self._c_dir_steered = None
        self._h_handoff = None
        if registry is not None:
            self._c_requests = registry.counter(
                "router_requests_total", help="generation requests routed")
            self._c_retries = registry.counter(
                "router_retries_total",
                help="zero-streamed requests re-dispatched after a backend "
                     "failure")
            self._c_affinity = registry.counter(
                "router_affinity_picks_total",
                help="dispatches that followed the prompt-family pin")
            self._c_affinity_spill = registry.counter(
                "router_affinity_spills_total",
                help="dispatches where load imbalance overrode the pin")
            self._c_lost = registry.counter(
                "router_streams_lost_total",
                help="streams terminated with replica_lost (tokens already "
                     "streamed when the backend died)")
            self._c_unavailable = registry.counter(
                "router_unavailable_total",
                help="requests failed with no READY replica")
            self._c_reloads = registry.counter(
                "router_rolling_reloads_total",
                help="rolling weight reloads completed")
            self._c_handoffs = registry.counter(
                "router_kv_handoffs_total",
                help="dispatches routed prefill-replica-first "
                     "(disaggregated handoff arranged)")
            self._c_handoff_fallbacks = registry.counter(
                "router_kv_handoff_fallbacks_total",
                help="dispatches that fell back to monolithic routing "
                     "(no prefill replica, prefill failed/timed out)")
            self._c_migrations = registry.counter(
                "router_stream_migrations_total",
                help="live streams migrated off a draining replica "
                     "(rolling reload drain-by-migration)")
            self._c_pushes = registry.counter(
                "router_kv_pushes_total",
                help="P→D push transfers scheduled and acked "
                     "(blocks resident on the decode replica before "
                     "admission)")
            self._c_push_fallbacks = registry.counter(
                "router_kv_push_fallbacks_total",
                help="scheduled pushes that failed or missed (decode "
                     "side pulls or re-prefills — counted, never a "
                     "client error)")
            self._c_push_bytes = registry.counter(
                "router_kv_push_bytes_total",
                help="serialized KV bytes moved by push transfers")
            self._c_push_saved_bytes = registry.counter(
                "router_kv_push_bytes_saved_total",
                help="transfer bytes avoided because the fleet cache "
                     "directory showed the decode replica already "
                     "holding the prefix family")
            self._c_dir_hits = registry.counter(
                "router_kv_directory_hits_total",
                help="dispatches where the directory found the family "
                     "already resident on the picked decode replica")
            self._c_dir_evictions = registry.counter(
                "router_kv_directory_evictions_total",
                help="directory entries dropped as stale (owner dead "
                     "or restarted under a new generation)")
            self._c_dir_steered = registry.counter(
                "router_kv_dir_steered_total",
                help="decode dispatches steered to a replica the cache "
                     "directory showed already holding the prompt's "
                     "prefix family (with KV capacity headroom) — the "
                     "whole transfer skipped by placement")
            self._h_handoff = registry.histogram(
                "router_kv_prefill_seconds",
                help="prefill-replica handoff latency (kv_prefill "
                     "round trip)",
                buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5,
                         1.0, 2.5, 5.0, 10.0))

    # -- lifecycle ----------------------------------------------------------
    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("router not started")
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self._requested_port)
        if self.telemetry_interval_s > 0:
            self._telem_task = asyncio.get_running_loop().create_task(
                self._telemetry_loop(), name="fleet-telemetry")

    async def stop(self) -> None:
        if self._telem_task is not None:
            self._telem_task.cancel()
            try:
                await self._telem_task
            except (asyncio.CancelledError, Exception):
                pass
            self._telem_task = None
        self._telem_subs.clear()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass
        for pool in self._pools.values():
            for conn in pool:
                conn.writer.close()
        self._pools.clear()
        for mux in list(self._muxes.values()):
            await mux.close()
        self._muxes.clear()
        for task in list(self._push_tasks):
            task.cancel()
        self._push_tasks.clear()

    # -- replica choice -----------------------------------------------------
    def _family(self, prompt) -> int:
        try:
            head = ",".join(
                str(int(t)) for t in prompt[:self.affinity_tokens])
        except (TypeError, ValueError):
            # Un-hashable junk (a string prompt, nested lists): no
            # affinity — the replica will reject it with a typed
            # bad_request, which is the reply the client should see.
            return 0
        return zlib.crc32(head.encode())

    def _roles_enabled(self) -> bool:
        """True when the fleet is disaggregated (any prefill replica
        exists, alive or not — the role is a property of the slot)."""
        return any(r.role == "prefill"
                   for r in self.supervisor.replicas.values())

    def _pick(self, prompt, exclude: set[str],
              kind: str = "generate") -> ReplicaInfo | None:
        # Prefill replicas never take generation dispatches — their job
        # is kv_prefill + export; decode replicas (and monolithic ones)
        # decode. Scoring/embedding requests are prefill-SHAPED (no
        # decode phase at all), so they invert the preference: steer
        # them at prefill/monolithic replicas least-outstanding, keeping
        # decode replicas' slots for streams — falling back to any READY
        # replica rather than failing.
        if kind in ("score", "embed"):
            ready = [r for r in self.supervisor.replicas.values()
                     if r.status == READY and r.rid not in exclude]
            if not ready:
                return None
            shaped = [r for r in ready if r.role != "decode"]
            return min(shaped or ready, key=lambda r: r.outstanding)
        ready = [r for r in self.supervisor.replicas.values()
                 if r.status == READY and r.rid not in exclude
                 and r.role != "prefill"]
        if not ready:
            return None
        if len(ready) == 1:
            return ready[0]
        if self._roles_enabled():
            # Cross-replica sharing supersedes affinity: a prompt
            # family's blocks live on its PREFILL replica (prefilled
            # once per fleet) and any decode replica adopts them, so a
            # decode-side pin would only manufacture hotspots. The
            # affinity_prefix is now purely a prefill-placement hint —
            # decode picks go least-outstanding... UNLESS the fleet
            # cache directory already shows the family resident on a
            # decode replica WITH KV capacity headroom: steering there
            # skips the transfer entirely (the cheapest byte is the one
            # never moved), bounded by the same affinity_slack so a hot
            # holder never turns into a hotspot. (docs/serving.md
            # "Disaggregated serving".)
            least = min(ready, key=lambda r: r.outstanding)
            fam = self._family(prompt)
            holders = [r for r in ready
                       if self._dir_holds(fam, r)
                       and self._kv_headroom(r)]
            if holders:
                pick = min(holders, key=lambda r: r.outstanding)
                if (pick.outstanding - least.outstanding
                        <= self.affinity_slack):
                    if self._c_dir_steered is not None:
                        self._c_dir_steered.inc()
                    return pick
            return least
        fam = self._family(prompt)
        # Rendezvous (highest-random-weight) hash: each family ranks every
        # replica; the top-ranked READY one wins. Replica death/drain only
        # remaps the families that were pinned to it — every other family
        # keeps its warm cache.
        preferred = max(
            ready, key=lambda r: zlib.crc32(f"{fam}:{r.rid}".encode()))
        least = min(ready, key=lambda r: r.outstanding)
        if preferred.outstanding - least.outstanding > self.affinity_slack:
            if self._c_affinity_spill is not None:
                self._c_affinity_spill.inc()
            return least
        if self._c_affinity is not None:
            self._c_affinity.inc()
        return preferred

    def _pick_prefill(self, prompt) -> ReplicaInfo | None:
        """The prefill replica for a prompt family: rendezvous-pinned so
        a hot prefix is prefilled ONCE per fleet (this is where the
        ``affinity_prefix`` placement hint now earns its keep), spilling
        to least-outstanding past ``affinity_slack`` like decode picks
        used to."""
        ready = [r for r in self.supervisor.replicas.values()
                 if r.status == READY and r.role == "prefill"]
        if not ready:
            return None
        if len(ready) == 1:
            return ready[0]
        fam = self._family(prompt)
        preferred = max(
            ready, key=lambda r: zlib.crc32(f"{fam}:{r.rid}".encode()))
        least = min(ready, key=lambda r: r.outstanding)
        if preferred.outstanding - least.outstanding > self.affinity_slack:
            return least
        return preferred

    async def _pick_wait(self, prompt, exclude: set[str],
                         kind: str = "generate"):
        """Pick a replica, waiting up to ``pick_wait_s`` for one to be
        READY (covers the restart window after a crash and the brief
        all-draining edge of a 1-replica reload)."""
        deadline = time.monotonic() + self.pick_wait_s
        while True:
            info = self._pick(prompt, exclude, kind)
            if info is not None:
                return info
            if exclude:
                # Every non-excluded replica is down; retrying on an
                # excluded-but-recovered one beats failing the request.
                exclude.clear()
                continue
            if time.monotonic() > deadline:
                return None
            await asyncio.sleep(0.02)

    # -- backend connections ------------------------------------------------
    def _prune_stale(self, info: ReplicaInfo) -> None:
        """Drop pools and muxes negotiated with a previous incarnation of
        this replica (different port OR different generation — a restart
        onto the SAME port still invalidates everything)."""
        live = (info.rid, info.port, info.generation)
        for key in [k for k in self._pools
                    if k[0] == info.rid and k != live]:
            for conn in self._pools.pop(key):
                conn.writer.close()
        for key in [k for k in self._muxes
                    if k[0] == info.rid and k != live]:
            self._muxes.pop(key).fail("replica restarted")

    async def _acquire(self, info: ReplicaInfo) -> _PooledConn:
        # A restarted replica bumps its generation (even on a reused
        # port): drop stale pools now, or a crash-looping replica
        # accretes one dead pool per restart for the router's lifetime.
        self._prune_stale(info)
        pool = self._pools.get((info.rid, info.port, info.generation))
        while pool:
            conn = pool.pop()
            # Checkout re-verification: the entry's recorded negotiation
            # state must match the replica's CURRENT incarnation — the
            # regression fix for a replica restarted onto the same port
            # being served by a connection from its previous life.
            if conn.generation != info.generation \
                    or conn.proto != wire.PROTO_JSONL:
                conn.writer.close()
                continue
            if not conn.writer.is_closing():
                return conn
            conn.writer.close()
        try:
            # Bounded connect (the OS default is minutes — a SYN-dropping
            # host must not stall dispatch, fleet aggregation, or a
            # rolling reload holding its lock) and a generous line limit:
            # an aggregate-bound metricsz snapshot is one long JSON line,
            # far past StreamReader's 64 KB default.
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(info.host, info.port, limit=2**24),
                self.connect_timeout_s)
            return _PooledConn(reader, writer, info.generation)
        except asyncio.TimeoutError as e:
            raise OSError(
                f"connect to {info.rid} ({info.host}:{info.port}) timed "
                f"out after {self.connect_timeout_s}s") from e

    def _release(self, info: ReplicaInfo, conn: _PooledConn,
                 healthy: bool) -> None:
        if not healthy or conn.writer.is_closing() \
                or conn.generation != info.generation:
            conn.writer.close()
            return
        pool = self._pools.setdefault(
            (info.rid, info.port, info.generation), [])
        if len(pool) < self.pool_size:
            pool.append(conn)
        else:
            conn.writer.close()

    async def _get_mux(self, info: ReplicaInfo) -> _BackendMux | None:
        """The replica's live bin1 mux, negotiating one on first use —
        or None when this replica (or this router) speaks JSONL only.
        The negotiated capability is cached per INCARNATION
        (``info.wire_proto``, reset by the supervisor on every restart),
        so a replica that comes back older — or on the same port — is
        re-probed, never assumed."""
        if self.wire_mode == "jsonl" or info.wire_proto == wire.PROTO_JSONL:
            return None
        key = (info.rid, info.port, info.generation)
        mux = self._muxes.get(key)
        if mux is not None and not mux.dead:
            return mux
        lock = self._mux_locks.setdefault(info.rid, asyncio.Lock())
        async with lock:
            mux = self._muxes.get(key)
            if mux is not None and not mux.dead:
                return mux
            if info.wire_proto == wire.PROTO_JSONL:
                return None
            self._prune_stale(info)
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(info.host, info.port,
                                            limit=2**24),
                    self.connect_timeout_s)
            except (OSError, asyncio.TimeoutError):
                return None  # dispatch's jsonl path will surface the loss
            try:
                writer.write(wire.hello_line())
                await writer.drain()
                line = await asyncio.wait_for(
                    reader.readline(), self.connect_timeout_s)
                rec = json.loads(line) if line else {}
            except (OSError, ValueError, asyncio.TimeoutError):
                writer.close()
                return None
            proto = wire.parse_hello(rec)
            info.wire_proto = proto
            if proto != wire.PROTO_BIN1:
                # Old replica: it answered the unknown hello verb with a
                # typed bad_request (or picked jsonl). Remember for this
                # incarnation and keep the probe connection pooled — it
                # is a perfectly good jsonl connection.
                self._release(info, _PooledConn(
                    reader, writer, info.generation), healthy=True)
                return None
            mux = _BackendMux(key, reader, writer)
            self._muxes[key] = mux
            return mux

    async def _backend_control(self, info: ReplicaInfo, spec: dict,
                               timeout: float = 5.0) -> dict:
        """One control verb against one replica over a pooled connection."""
        conn = await self._acquire(info)
        try:
            conn.writer.write((json.dumps(spec) + "\n").encode())
            await conn.writer.drain()
            line = await asyncio.wait_for(conn.reader.readline(), timeout)
            if not line:
                raise _BackendLost(f"{info.rid} closed the connection")
            rec = json.loads(line)
        except BaseException:
            self._release(info, conn, healthy=False)
            raise
        self._release(info, conn, healthy=True)
        return rec

    # -- fleet telemetry plane ----------------------------------------------
    async def _telemetry_loop(self) -> None:
        """The push plane's heartbeat: each tick (re)subscribes every
        routable replica that lost (or never had) a push stream, polls
        the JSONL-only ones, and runs one SLO evaluation over the
        windowed store. Pushed deltas arrive OUTSIDE this loop (the mux
        read loop ingests them as they land) — the tick only repairs
        subscriptions and advances the burn-rate state machine."""
        try:
            while True:
                await asyncio.gather(*(
                    self._subscribe_or_poll(info)
                    for info in list(self.supervisor.replicas.values())
                    if info.status in (READY, DRAINING)),
                    return_exceptions=True)
                try:
                    self.slo.evaluate()
                    # New page transitions pin their exemplar trace ids
                    # fleet-wide immediately — waiting for an operator's
                    # sloz call would race the trace windows rolling.
                    await self._pin_slo_exemplars()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass  # one bad evaluation must not kill the plane
                await asyncio.sleep(self.telemetry_interval_s)
        except asyncio.CancelledError:
            pass

    async def _subscribe_or_poll(self, info: ReplicaInfo) -> None:
        """Ensure one telemetry feed from this replica incarnation:
        prefer a push subscription over its bin1 mux (negotiating the
        mux on first contact — the plane wants the channel up before
        the first request anyway); fall back to one ``telemetryz`` poll
        for JSONL replicas. A dead mux clears the subscription (the
        handler sees ``None``), so the next tick re-subscribes."""
        live = (info.port, info.generation)
        if self._telem_subs.get(info.rid) == live:
            return
        try:
            mux = await self._get_mux(info)
        except Exception:
            mux = None
        if mux is not None and not mux.dead:
            try:
                self._subscribe_telemetry(info, mux)
                return
            except _BackendLost:
                pass
        await self._poll_telemetry(info)

    def _subscribe_telemetry(self, info: ReplicaInfo,
                             mux: _BackendMux) -> None:
        """Open the long-lived push stream: one mux sid whose handler
        folds every T_TELEM frame into the fleet aggregator. The
        replica's ``telemetry_start`` task pushes deltas on this sid
        until the connection dies — no per-delta round trip, no
        router-side poll on the hot path."""
        rid, role = info.rid, info.role
        live = (info.port, info.generation)

        def handler(ftype, payload):
            if ftype == wire.T_TELEM:
                try:
                    self.fleet.ingest(rid, role, json.loads(payload))
                except Exception:
                    pass  # counted by the aggregator where possible
            elif ftype is None and self._telem_subs.get(rid) == live:
                del self._telem_subs[rid]  # next tick re-subscribes
            # T_CTRLR: the telemetry_start ack — nothing to do.

        sid = mux.open(handler)
        mux.enqueue(wire.encode_json_frame(
            wire.T_CTRL, sid,
            {"cmd": "telemetry_start",
             "interval_s": self.telemetry_interval_s}))
        self._telem_subs[rid] = live

    async def _poll_telemetry(self, info: ReplicaInfo) -> None:
        """JSONL fallback: one ``telemetryz`` delta pull. The replica
        keeps one dedicated encoder for this verb, so the delta stream
        stays correct with the router as its single poller."""
        try:
            rep = await self._backend_control(
                info, {"cmd": "telemetryz"}, timeout=2.0)
        except (OSError, ValueError, asyncio.TimeoutError, _BackendLost):
            return  # health probing owns failure detection
        payload = rep.get("telemetryz")
        if isinstance(payload, dict):
            self.fleet.ingest(info.rid, info.role, payload)

    def telemetry_stats(self) -> dict:
        """Aggregation rollup for healthz/debugz/sloz."""
        out = self.fleet.stats()
        out["push_subscriptions"] = len(self._telem_subs)
        out["interval_s"] = self.telemetry_interval_s
        return out

    # -- request path -------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    spec = json.loads(line)
                    if not isinstance(spec, dict):
                        raise ValueError("request must be a JSON object")
                except ValueError as e:
                    await self._send(writer,
                                     {"error": str(e), "code": "bad_request"})
                    continue
                if spec.get("cmd") == "hello":
                    # The bin1 upgrade offer — same negotiation as a
                    # single ServingServer, so a client cannot tell a
                    # router from a replica.
                    proto = (wire.PROTO_JSONL if self.wire_mode == "jsonl"
                             else wire.choose_proto(spec.get("proto")))
                    await self._send(writer, {"hello": {
                        "proto": proto,
                        "fastwire": wire.native_available()}})
                    if proto == wire.PROTO_BIN1:
                        await self._handle_bin1(reader, writer)
                        return
                    continue
                if "cmd" in spec:
                    await self._send(writer, await self._control(spec))
                else:
                    await self._dispatch(spec, _JsonClientSink(writer))
        except (ConnectionResetError, BrokenPipeError, _ClientGone):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _handle_bin1(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """The negotiated binary front door for one client connection:
        pipelined REQ frames each dispatch as their own task (so many
        requests ride one connection concurrently), token output
        coalesces through one shared FrameSink, and every frame that
        arrived in one event-loop tick is drained in one read."""
        sink = wire.FrameSink(writer, self.flush_interval_s)
        decoder = wire.FrameDecoder()
        tasks: dict[int, asyncio.Task] = {}
        fast: dict[int, _FastStream] = {}
        loop = asyncio.get_running_loop()
        try:
            while True:
                data = await reader.read(2 ** 18)
                if not data:
                    break
                try:
                    frames = decoder.feed(data)
                except wire.WireError as e:
                    sink.send_error(0, {"error": str(e),
                                        "code": "bad_request"})
                    break
                # The READY list is shared by every REQ frame of this
                # read batch (status changes land between reads, and a
                # one-read-stale pick is indistinguishable from the
                # request having arrived a tick earlier).
                ready = None
                for ftype, sid, payload in frames:
                    if ftype == wire.T_REQ:
                        # Steady state: the zero-task switch. Falls back
                        # to a dispatch task for the cases that need one
                        # (first contact with a replica, tracing on,
                        # nothing READY).
                        if ready is None:
                            # Roles fleets always take the dispatch
                            # task: the handoff (kv_prefill before
                            # dispatch) and drain-by-migration both
                            # need the classic path's machinery.
                            ready = ([] if self.trace_store is not None
                                     or self.wire_mode == "jsonl"
                                     or self._roles_enabled() else
                                     [r for r in
                                      self.supervisor.replicas.values()
                                      if r.status == READY])
                        if self._fast_dispatch(payload, sid, sink, fast,
                                               ready):
                            continue
                        try:
                            spec = wire.decode_request(payload)
                        except wire.WireError as e:
                            sink.send_error(sid, {"error": str(e),
                                                  "code": "bad_request"})
                            continue
                        task = loop.create_task(self._dispatch_frame(
                            spec, _BinClientSink(sink, sid)))
                        tasks[sid] = task
                        task.add_done_callback(
                            lambda _t, s=sid: tasks.pop(s, None))
                    elif ftype == wire.T_CANCEL:
                        st = fast.get(sid)
                        if st is not None:
                            st.abandon()
                            continue
                        task = tasks.get(sid)
                        if task is not None:
                            task.cancel()
                    elif ftype == wire.T_CTRL:
                        # As a task, like REQ dispatch: a slow verb (an
                        # aggregate healthz with one wedged replica, a
                        # rolling reload) must not stall every
                        # multiplexed stream's frame processing.
                        ctrl = loop.create_task(
                            self._ctrl_frame(sid, payload, sink))
                        self._failover_tasks.add(ctrl)
                        ctrl.add_done_callback(
                            self._failover_tasks.discard)
                    else:
                        sink.send_error(sid, {
                            "error": f"unexpected frame type {ftype}",
                            "code": "bad_request"})
        finally:
            # Client gone: cancel every in-flight dispatch — each relay's
            # cleanup cancels its backend stream (mux CANCEL frame, or
            # closing an exclusive jsonl backend connection).
            for st in list(fast.values()):
                st.abandon()
            for task in list(tasks.values()):
                task.cancel()
            if tasks:
                await asyncio.gather(*tasks.values(),
                                     return_exceptions=True)
            await sink.aclose()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _ctrl_frame(self, sid: int, payload, sink) -> None:
        """One control verb off a bin1 connection, as its own task."""
        try:
            rep = await self._control(wire.decode_json(payload))
        except wire.WireError as e:
            rep = {"error": str(e), "code": "bad_request"}
        sink.send_json(wire.T_CTRLR, sid, rep)

    async def _dispatch_frame(self, spec: dict, sink, *,
                              exclude: set | None = None,
                              counted: bool = False) -> None:
        """One pipelined stream's dispatch task: client loss and
        cancellation are normal endings here, never connection-handler
        errors (other streams on the connection keep running)."""
        try:
            await self._dispatch(spec, sink, exclude=exclude,
                                 counted=counted)
        except (_ClientGone, asyncio.CancelledError):
            pass

    # -- the zero-task fast path -------------------------------------------
    def _fast_pick(self, ready: list, payload: bytes) -> ReplicaInfo:
        """The fast path's replica choice: same rendezvous-affinity +
        least-outstanding policy as :meth:`_pick`, but the prompt family
        hashes the REQ payload's raw prefix bytes (no int->str joins)
        and the per-replica rank seeds crc32 with the family instead of
        building strings. The family value differs from the JSONL
        path's string hash — affinity is a placement HINT, so bin1 and
        jsonl clients pinning the same prefix to different replicas
        costs cache warmth, never correctness."""
        if len(ready) == 1:
            return ready[0]
        fam = zlib.crc32(wire.affinity_prefix(payload,
                                              self.affinity_tokens))
        preferred = max(
            ready, key=lambda r: zlib.crc32(r.rid.encode(), fam))
        least = min(ready, key=lambda r: r.outstanding)
        if preferred.outstanding - least.outstanding > self.affinity_slack:
            if self._c_affinity_spill is not None:
                self._c_affinity_spill.inc()
            return least
        if self._c_affinity is not None:
            self._c_affinity.inc()
        return preferred

    def _fast_dispatch(self, payload: bytes, csid: int, sink,
                       registry: dict, ready: list) -> bool:
        """Switch one bin1 client stream straight onto a replica mux
        with NO per-request task, queue, or JSON: re-frame the payload
        under a backend stream id and let the mux read loop forward
        events through :class:`_FastStream`. Returns False when the
        fast path can't serve this request (tracing on, no READY
        replica, mux not negotiated yet, dead connection) — the caller
        falls back to the classic dispatch task, which also NEGOTIATES
        the mux, so only a replica's first request pays the slow path."""
        if not ready:
            return False
        if wire.request_flags(payload) & wire._F_EXTRAS:
            # Extras-bearing REQs (kind/n/constraint, kv_from, ...) need
            # the kind-aware classic path: scoring steers at
            # prefill-shaped replicas, and the fast path's raw-bytes
            # pick can't see inside the extras JSON.
            return False
        info = self._fast_pick(ready, payload)
        mux = self._muxes.get((info.rid, info.port, info.generation))
        if mux is None or mux.dead:
            return False
        st = _FastStream(self, sink, csid, payload, info, mux, registry)
        try:
            st.bsid = mux.open(st.on_frame)
        except _BackendLost:
            return False
        mux.enqueue(wire.encode_frame(wire.T_REQ, st.bsid, payload))
        registry[csid] = st
        info.outstanding += 1
        if self._c_requests is not None:
            self._c_requests.inc()
        return True

    def _fast_failover(self, st: "_FastStream", rec: dict | None) -> None:
        """A fast-path request hit a retryable failure (backend lost, or
        a typed reject with zero streamed tokens): hand it to the
        classic dispatch, excluding the replica that failed it. Rare by
        construction — the task cost lives off the ceiling path."""
        try:
            spec = wire.decode_request(st.payload)
        except wire.WireError as e:
            st.sink.send_error(st.csid, {"error": str(e),
                                         "code": "bad_request"})
            return
        if self._c_retries is not None:
            self._c_retries.inc()
        task = asyncio.get_running_loop().create_task(
            self._dispatch_frame(spec, _BinClientSink(st.sink, st.csid),
                                 exclude={st.info.rid}, counted=True))
        self._failover_tasks.add(task)
        task.add_done_callback(self._failover_tasks.discard)

    async def _dispatch(self, spec: dict, sink, *,
                        exclude: set | None = None,
                        counted: bool = False) -> None:
        """Route one generation request, retrying while idempotent.
        ``exclude`` pre-seeds the excluded-replica set (a fast-path
        failover already burned one attempt there); ``counted`` skips
        the request counter (the fast path already counted it).

        ``sink`` is the client-facing output (JSONL lines or bin1
        frames) — the retry loop is protocol-agnostic on BOTH sides.

        Trace context: the client's ``trace_id`` (or a router-minted one
        for bare clients) is forced into the forwarded spec, so the
        replica's engine tags its timeline with the same id; the router
        records its OWN timeline — every dispatch, retry, reject, and
        the terminal outcome — under that id, which is what lets the
        ``tracez`` verb show a retried request's two replica hops as one
        trace."""
        prompt = spec.get("prompt") or []
        trace_id = sanitize_trace_id(spec.get("trace_id")) or new_trace_id()
        spec["trace_id"] = trace_id
        trace = None
        if self.trace_store is not None:
            trace = TimelineRecord(trace_id, "router", "router")
            trace.event("request", prompt_tokens=len(prompt)
                        if isinstance(prompt, (list, tuple)) else None)
        if self._c_requests is not None and not counted:
            self._c_requests.inc()
        attempts = 0
        hops: list[str] = []
        exclude = set(exclude or ())
        try:
            # Disaggregated handoff: prefill the prompt on a PREFILL
            # replica first, then point the decode dispatch at its
            # blocks (spec["kv_from"]). Any failure simply skips the
            # hint — the decode replica prefills itself (monolithic),
            # so disaggregation can only help. A spec that already
            # carries kv_from (a migrating stream pulling from its
            # draining replica) keeps it.
            kind = str(spec.get("kind") or "generate")
            handoff_src = None
            if (self._roles_enabled() and "kv_from" not in spec
                    and "kv_wait" not in spec
                    and kind not in ("score", "embed")
                    and isinstance(prompt, (list, tuple))
                    and len(prompt) >= self.min_handoff_tokens):
                handoff_src = await self._prefill_handoff(spec, trace)
            while True:
                info = await self._pick_wait(prompt, exclude, kind)
                if info is None:
                    if self._c_unavailable is not None:
                        self._c_unavailable.inc()
                    if trace is not None:
                        trace.event("unavailable")
                        trace.data["status"] = "unavailable"
                    await sink.final({
                        "error": "no serving replica available",
                        "code": "unavailable", "trace_id": trace_id})
                    return
                hops.append(info.rid)
                if trace is not None:
                    trace.event("dispatch", replica=info.rid,
                                attempt=attempts,
                                outstanding=info.outstanding)
                if handoff_src is not None:
                    self._plan_kv_transfer(spec, handoff_src, info, trace)
                outcome, streamed, rec = await self._relay_any(
                    info, spec, sink)
                if outcome == "migrate":
                    # The replica is draining and this stream was asked
                    # to move: fold the tokens the client already has
                    # into a resume, point the next replica at the
                    # draining one's pool (its cancel path ADOPTED the
                    # slot's blocks, so the resume prefill is a KV pull
                    # + tail, not a recompute), and re-dispatch. Not a
                    # failure: no retry budget burned.
                    hop = (rec or {}).get("tokens") or []
                    spec = dict(spec)
                    resume = (list(spec.get("resume_tokens") or ())
                              + list(hop))
                    if self._c_migrations is not None:
                        self._c_migrations.inc()
                    if trace is not None:
                        trace.event("migrate", replica=info.rid,
                                    streamed=len(hop))
                    try:
                        max_new = int(spec.get("max_new_tokens"))
                    except (TypeError, ValueError):
                        max_new = None
                    if max_new is not None and len(resume) >= max_new:
                        # The poke raced the stream's LAST token: the
                        # client already holds the complete output and
                        # only the done record was lost with the
                        # connection — synthesize it instead of
                        # re-dispatching a resume the engine would
                        # rightly reject as having nothing to decode.
                        done_rec = {
                            "done": True, "tokens": resume,
                            "trace_id": trace_id,
                            "tenant": spec.get("tenant") or "default",
                            "migrated_final": True}
                        if trace is not None:
                            trace.data["status"] = "ok"
                        await sink.final(done_rec)
                        return
                    spec["resume_tokens"] = resume
                    spec["kv_from"] = {"host": info.host,
                                       "port": info.port}
                    exclude.add(info.rid)
                    continue
                if outcome == "terminal":
                    if trace is not None:
                        trace.event("terminal", replica=info.rid,
                                    streamed=streamed)
                        trace.data["status"] = (
                            "ok" if rec and rec.get("done")
                            else (rec or {}).get("code", "error"))
                    return
                # Backend failed. Retry only while provably idempotent.
                retryable = (streamed == 0 and attempts < self.max_retries)
                if outcome == "lost":
                    self.supervisor.note_failure(info.rid)
                if trace is not None:
                    trace.event("backend_lost" if outcome == "lost"
                                else "replica_reject",
                                replica=info.rid, streamed=streamed,
                                code=(rec or {}).get("code"))
                if retryable:
                    attempts += 1
                    exclude.add(info.rid)
                    if self._c_retries is not None:
                        self._c_retries.inc()
                    if trace is not None:
                        trace.event("retry", attempt=attempts)
                    continue
                if outcome == "reject":
                    # Retry budget spent on typed replica-side rejects
                    # (e.g. every replica at queue_full): forward the
                    # LAST replica's own error — it is the truthful
                    # backpressure signal, not a lost stream.
                    if trace is not None:
                        trace.data["status"] = rec.get("code", "error")
                    await sink.final(rec)
                    return
                if self._c_lost is not None:
                    self._c_lost.inc()
                if trace is not None:
                    trace.data["status"] = "replica_lost"
                await sink.final({
                    "error": f"replica {info.rid} lost after {streamed} "
                             f"streamed tokens",
                    "code": "replica_lost", "trace_id": trace_id})
                return
        finally:
            if trace is not None:
                trace.data["hops"] = hops
                trace.data["retries"] = attempts
                self.trace_store.put(trace)

    async def _prefill_handoff(self, spec: dict, trace):
        """Arrange the disaggregated handoff for one dispatch: run
        ``kv_prefill`` on the prompt family's prefill replica (ONE
        prefill per fleet for a hot prefix — repeats are trie hits
        there), then stamp ``spec["kv_from"]`` so the decode replica
        pulls the blocks instead of prefilling. Every failure mode
        falls back silently to monolithic dispatch. On success the
        family's fleet-cache-directory entry records this replica as
        OWNER and the prefill replica is returned (the dispatch loop
        plans the P→D transfer against the decode pick); fallback
        returns None."""

        def fallback(reason: str):
            if self._c_handoff_fallbacks is not None:
                self._c_handoff_fallbacks.inc()
            if trace is not None:
                trace.event("kv_handoff_fallback", reason=reason)
            return None

        info = self._pick_prefill(spec["prompt"])
        if info is None:
            return fallback("no_prefill_replica")
        # Count the prefill against the replica's outstanding work:
        # prefill load-balancing (the slack spill) and drain waits must
        # see it.
        info.outstanding += 1
        t0 = time.monotonic()
        try:
            rep = await self._backend_control(
                info, {"cmd": "kv_prefill", "prompt": spec["prompt"],
                       "trace_id": spec.get("trace_id"),
                       "tenant": spec.get("tenant"),
                       "priority": spec.get("priority", 0)},
                timeout=self.kv_prefill_timeout_s)
        except (OSError, ValueError, asyncio.TimeoutError,
                _BackendLost) as e:
            self.supervisor.note_failure(info.rid)
            return fallback(f"{type(e).__name__}: {e}")
        finally:
            info.outstanding -= 1
        if "error" in rep:
            return fallback(str(rep.get("code") or rep["error"]))
        dur = time.monotonic() - t0
        spec["kv_from"] = {"host": info.host, "port": info.port}
        if self._c_handoffs is not None:
            self._c_handoffs.inc()
        if self._h_handoff is not None:
            self._h_handoff.observe(dur, exemplar=spec.get("trace_id"))
        if trace is not None:
            trace.event("kv_prefill", replica=info.rid,
                        dur_s=round(dur, 9))
        # Directory: this replica now owns the family's warm chain
        # (its device trie, or — evicted later — its host tier, which
        # exports transparently).
        fam = self._family(spec["prompt"])
        entry = self._kv_directory.setdefault(fam, {"holders": {}})
        entry["owner"] = info.rid
        entry["generation"] = info.generation
        entry["holders"][info.rid] = info.generation
        entry["blocks"] = (rep.get("kv_prefill") or {}).get("blocks")
        return info

    # -- fleet cache directory ----------------------------------------------
    def _forget_replica(self, rid: str) -> None:
        """Supervisor death hook: drop every directory claim the dead
        incarnation made — entries it owned and copies it held. Lazy
        lookup validation catches generation bumps; this catches death
        promptly so dispatches stop steering adoptions at a corpse.
        Also tears down the dead incarnation's telemetry: its push
        subscription (re-opened against the restart) and its gauge
        series (counters/histograms are monotone fleet history and
        stay; a corpse's gauges would read as live state forever)."""
        self._telem_subs.pop(rid, None)
        self.fleet.forget_replica(rid)
        dropped = 0
        for fam in list(self._kv_directory):
            entry = self._kv_directory[fam]
            if entry["holders"].pop(rid, None) is not None:
                dropped += 1
            if entry.get("owner") == rid or not entry["holders"]:
                del self._kv_directory[fam]
                dropped += 1
        if dropped and self._c_dir_evictions is not None:
            self._c_dir_evictions.inc(dropped)

    def _dir_holds(self, fam: int, info: ReplicaInfo) -> bool:
        """True when the directory shows THIS incarnation of ``info``
        holding family ``fam``. Stale claims (replica restarted under a
        new generation) are dropped on sight, counted."""
        entry = self._kv_directory.get(fam)
        if entry is None:
            return False
        gen = entry["holders"].get(info.rid)
        if gen is None:
            return False
        if gen != info.generation:
            del entry["holders"][info.rid]
            if self._c_dir_evictions is not None:
                self._c_dir_evictions.inc()
            return False
        return True

    def _kv_headroom(self, info: ReplicaInfo) -> bool:
        """True when ``info``'s last health probe showed free KV pool
        capacity — the gate on directory steering (a full holder would
        just preempt what it holds to admit the steered request, losing
        the very blocks we steered for). A replica whose healthz never
        reported a pool (unpaged, or no probe yet) counts as capacious:
        steering is an optimization, not a correctness gate."""
        pool = (info.last_health or {}).get("kv_pool")
        if not isinstance(pool, dict) or "blocks_free" not in pool:
            return True
        try:
            return int(pool["blocks_free"]) > 0
        except (TypeError, ValueError):
            return True

    def _plan_kv_transfer(self, spec: dict, src: ReplicaInfo,
                          dst: ReplicaInfo, trace) -> None:
        """Decide how the decode pick ``dst`` gets the family's blocks
        from prefill owner ``src`` — called per dispatch attempt (a
        retry re-plans against the new pick). Three outcomes, best
        first: the directory shows ``dst`` already holding the family
        (skip the transfer, count the bytes saved); push mode schedules
        an overlapped P→D push and stamps ``kv_wait`` (the decode side
        parks on its tier-arrival event, pulling only if the push
        misses); otherwise keep the classic adopt-time pull
        (``kv_from``)."""
        fam = self._family(spec.get("prompt") or [])
        # Re-plan from a clean slate: a previous attempt may have
        # stamped kv_wait for a different pick.
        spec.pop("kv_wait", None)
        spec["kv_from"] = {"host": src.host, "port": src.port}
        if self._dir_holds(fam, dst):
            spec.pop("kv_from", None)
            if self._c_dir_hits is not None:
                self._c_dir_hits.inc()
            if self._c_push_saved_bytes is not None:
                entry = self._kv_directory.get(fam) or {}
                self._c_push_saved_bytes.inc(int(entry.get("bytes") or 0))
            if trace is not None:
                trace.event("kv_directory_hit", replica=dst.rid,
                            family=fam)
            return
        if not self.kv_push or src.rid == dst.rid:
            return
        spec.pop("kv_from", None)
        spec["kv_wait"] = {"host": src.host, "port": src.port}
        task = asyncio.get_running_loop().create_task(
            self._push_to(fam, src, dst, list(spec.get("prompt") or ()),
                          spec.get("trace_id"), trace))
        self._push_tasks.add(task)
        task.add_done_callback(self._push_tasks.discard)

    async def _push_to(self, fam: int, src: ReplicaInfo,
                       dst: ReplicaInfo, prompt, trace_id, trace) -> None:
        """Fire one P→D push (``kv_push`` verb on the owner) and record
        the outcome in the directory. Runs as its own task so the
        transfer overlaps the decode replica's work on earlier chunks;
        the dispatched request is already parked on ``kv_wait`` and
        wakes the moment the pushed import lands. Failures only count —
        the decode side's timeout pull (then monolithic prefill) is the
        fallback chain."""
        try:
            rep = await self._backend_control(
                src, {"cmd": "kv_push", "prompt": prompt,
                      "to_host": dst.host, "to_port": dst.port,
                      "trace_id": trace_id},
                timeout=self.kv_prefill_timeout_s)
        except (OSError, ValueError, asyncio.TimeoutError,
                _BackendLost) as e:
            if self._c_push_fallbacks is not None:
                self._c_push_fallbacks.inc()
            if trace is not None:
                trace.event("kv_push_fallback",
                            reason=f"{type(e).__name__}: {e}")
            return
        out = rep.get("kv_push") or {}
        if "error" in rep or not out.get("pushed"):
            if self._c_push_fallbacks is not None:
                self._c_push_fallbacks.inc()
            if trace is not None:
                trace.event("kv_push_fallback",
                            reason=str(rep.get("error")
                                       or "nothing_resident"))
            return
        entry = self._kv_directory.setdefault(fam, {"holders": {}})
        entry["holders"][dst.rid] = dst.generation
        if out.get("bytes"):
            entry["bytes"] = int(out["bytes"])
        if self._c_pushes is not None:
            self._c_pushes.inc()
        if self._c_push_bytes is not None:
            self._c_push_bytes.inc(int(out.get("bytes") or 0))
        if trace is not None:
            trace.event("kv_push", replica=dst.rid,
                        bytes=out.get("bytes"),
                        blocks=out.get("blocks"))

    def kv_directory_stats(self) -> dict:
        """Directory rollup for healthz/debugz: family count, copy
        count, and the push counters."""
        holders = sum(len(e["holders"]) for e in
                      self._kv_directory.values())
        out = {
            "families": len(self._kv_directory),
            "holders": holders,
            "push_enabled": self.kv_push,
        }
        for name, c in (("pushes", self._c_pushes),
                        ("push_fallbacks", self._c_push_fallbacks),
                        ("push_bytes", self._c_push_bytes),
                        ("push_bytes_saved", self._c_push_saved_bytes),
                        ("directory_hits", self._c_dir_hits),
                        ("directory_evictions", self._c_dir_evictions),
                        ("directory_steered", self._c_dir_steered)):
            if c is not None:
                out[name] = int(c.value)
        return out

    # -- drain-by-migration -------------------------------------------------
    def _register_relay(self, rid: str, ctl: _RelayCtl) -> None:
        self._inflight.setdefault(rid, set()).add(ctl)

    def _unregister_relay(self, rid: str, ctl: _RelayCtl) -> None:
        ctls = self._inflight.get(rid)
        if ctls is not None:
            ctls.discard(ctl)
            if not ctls:
                self._inflight.pop(rid, None)

    def migrate_streams(self, rid: str) -> int:
        """Ask every in-flight classic relay on ``rid`` to move NOW:
        each returns the ``"migrate"`` outcome and its dispatch loop
        re-sends the request elsewhere with the streamed tokens folded
        in (and the KV pulled from ``rid``'s pool, which adopted the
        cancelled slots' blocks). Returns how many streams were asked.
        Fast-path streams don't register here — roles fleets (the only
        ones that migrate) route everything through the classic path."""
        fired = 0
        for ctl in list(self._inflight.get(rid, ())):
            ctl.migrating = True
            try:
                ctl.fire()
            except Exception:
                pass  # one stream's poke must not strand the rest
            fired += 1
        return fired

    async def _relay_any(self, info: ReplicaInfo, spec: dict, sink):
        """One attempt through ``info`` over the best protocol it
        speaks: the multiplexed bin1 connection when negotiated, the
        classic exclusive JSONL connection otherwise (old replicas in a
        mixed fleet, or ``wire='jsonl'``)."""
        mux = await self._get_mux(info)
        if mux is not None:
            return await self._relay_mux(mux, info, spec, sink)
        return await self._relay(info, spec, sink)

    async def _relay_mux(self, mux: _BackendMux, info: ReplicaInfo,
                         spec: dict, sink):
        """Stream one attempt through the replica's bin1 mux. Same
        outcome contract as :meth:`_relay`. A client loss (or dispatch
        cancellation) sends the backend a CANCEL frame — the mux peer
        cannot be cancelled by closing the shared connection."""
        streamed = 0
        terminal = False
        sid = None
        q: asyncio.Queue = asyncio.Queue()
        hop_tokens: list[int] = []  # this hop's streamed token VALUES
        ctl = _RelayCtl(lambda: q.put_nowait(("migrate", None)))

        def handler(ftype, payload):
            # Callback -> queue adapter (the slow path keeps its awaitable
            # shape; the fast path skips the queue entirely).
            if ftype is None:
                q.put_nowait(("lost", None))
            elif ftype == wire.T_TOK:
                q.put_nowait(("tok", wire.decode_tokens(payload)))
            elif ftype == wire.T_DONE:
                q.put_nowait(("done", wire.decode_json(payload)))
            elif ftype == wire.T_ERR:
                q.put_nowait(("err", wire.decode_json(payload)))

        info.outstanding += 1
        self._register_relay(info.rid, ctl)
        try:
            try:
                sid = mux.open(handler)
                mux.send_req(sid, spec)
            except _BackendLost:
                return "lost", streamed, None
            except wire.WireError as e:
                # The spec can't be expressed in binary (malformed
                # prompt): the same typed bad_request a replica would
                # answer, synthesized at the router.
                terminal = True
                rec = {"error": str(e), "code": "bad_request",
                       "trace_id": spec.get("trace_id")}
                await sink.final(rec)
                return "terminal", streamed, rec
            while True:
                kind, payload = await q.get()
                if kind == "tok":
                    streamed += len(payload)
                    hop_tokens.extend(payload)
                    await sink.tokens(payload)
                elif kind == "done":
                    terminal = True
                    await sink.final(payload)
                    return "terminal", streamed, payload
                elif kind == "err":
                    code = payload.get("code")
                    if streamed == 0 and code in _RETRYABLE_CODES:
                        terminal = True  # replica answered; no cancel
                        return "reject", streamed, payload
                    terminal = True
                    await sink.final(payload)
                    return "terminal", streamed, payload
                elif kind == "migrate":
                    # Drain-by-migration: stop here (the finally's
                    # CANCEL frees the slot — its blocks are adopted)
                    # and hand the streamed tokens back for the resume.
                    # Tokens queued behind the sentinel are dropped;
                    # the resume re-decodes them (greedy: identically).
                    return "migrate", streamed, {"tokens": hop_tokens}
                else:  # lost
                    if ctl.migrating:
                        # The poke raced the connection teardown: still
                        # a migration, not a replica_lost.
                        return "migrate", streamed, {"tokens": hop_tokens}
                    return "lost", streamed, None
        finally:
            self._unregister_relay(info.rid, ctl)
            if sid is not None:
                if terminal:
                    mux.release(sid)
                else:
                    # Client gone / cancelled mid-stream: tell the
                    # replica to stop decoding for nobody.
                    mux.cancel(sid)
            info.outstanding -= 1

    async def _relay(self, info: ReplicaInfo, spec: dict, sink):
        """Stream one attempt through ``info`` over an exclusive JSONL
        connection. Returns ``(outcome, streamed, rec)`` where outcome
        is ``"terminal"`` (a final line reached the client — done, or a
        non-retryable/late error), ``"lost"`` (connection-level backend
        failure), or ``"reject"`` (typed replica-side error with zero
        tokens streamed — replica answered, caller may retry elsewhere;
        ``rec`` carries its error line). A client-side failure cancels
        the backend work by closing the backend connection."""
        streamed = 0
        info.outstanding += 1
        hop_tokens: list[int] = []
        try:
            try:
                conn = await self._acquire(info)
            except OSError:
                return "lost", streamed, None
            # Drain-by-migration poke: closing the backend connection
            # interrupts the readline below AND cancels the replica-side
            # request (its handler sees the reset; the cancel path
            # adopts the slot's blocks) — ctl.migrating tells the
            # failure handlers this was a migration, not a loss.
            ctl = _RelayCtl(conn.writer.close)
            self._register_relay(info.rid, ctl)
            healthy = False
            try:
                with span("route", replica=info.rid,
                          trace_id=spec.get("trace_id"),
                          outstanding=info.outstanding):
                    conn.writer.write((json.dumps(spec) + "\n").encode())
                    await conn.writer.drain()
                    while True:
                        line = await conn.reader.readline()
                        if not line:
                            if ctl.migrating:
                                return "migrate", streamed, {
                                    "tokens": hop_tokens}
                            return "lost", streamed, None
                        rec = json.loads(line)
                        if "token" in rec:
                            streamed += 1
                            hop_tokens.append(rec["token"])
                            await sink.tokens([rec["token"]])
                            continue
                        if rec.get("done"):
                            healthy = True
                            await sink.final(rec)
                            return "terminal", streamed, rec
                        # Terminal error line from the replica.
                        code = rec.get("code")
                        if streamed == 0 and code in _RETRYABLE_CODES:
                            healthy = True
                            return "reject", streamed, rec
                        healthy = True
                        await sink.final(rec)
                        return "terminal", streamed, rec
            except (OSError, ConnectionResetError, BrokenPipeError,
                    ValueError):
                # Backend-side failure only: _ClientGone is not an
                # OSError and propagates — closing the (unpooled, if
                # mid-stream) backend connection cancels the request
                # server-side instead of decoding for nobody.
                if ctl.migrating:
                    return "migrate", streamed, {"tokens": hop_tokens}
                return "lost", streamed, None
            finally:
                self._unregister_relay(info.rid, ctl)
                self._release(info, conn, healthy=healthy)
        finally:
            info.outstanding -= 1

    async def _fetch_verb(self, info: ReplicaInfo, cmd: str,
                          extra: dict | None = None):
        """One replica's own control-verb payload for the aggregate
        pages, or ``{"unreachable": ...}``; None for replicas not in a
        routable state."""
        if info.status not in (READY, DRAINING):
            return None
        try:
            rep = await self._backend_control(
                info, {"cmd": cmd, **(extra or {})})
            return rep.get(cmd, rep)
        except (OSError, ValueError, asyncio.TimeoutError,
                _BackendLost) as e:
            return {"unreachable": str(e)}

    # -- control verbs ------------------------------------------------------
    async def _control(self, spec: dict) -> dict:
        cmd = spec.get("cmd")
        if cmd == "healthz":
            infos = list(self.supervisor.replicas.items())
            # Concurrent fan-out: fleet healthz latency is the SLOWEST
            # replica's probe, not the sum (one wedged replica must not
            # stall the whole page for timeout x N).
            fetched = await asyncio.gather(*(
                self._fetch_verb(info, "healthz") for _, info in infos))
            replicas = {}
            versions: dict[str, int] = {}
            migration_totals: dict[str, int] = {}
            for (rid, info), sub in zip(infos, fetched):
                entry = info.public()
                if sub is not None:
                    entry["healthz"] = sub
                    # Weight-provenance rollup: count each reachable
                    # replica's live (version, digest) so a mixed-
                    # version fleet — a half-finished rolling reload, a
                    # replica restarted onto stale weights — is visible
                    # at the ROUTER, not only one replica at a time.
                    wv = (sub.get("weight_version")
                          if isinstance(sub, dict) else None)
                    if isinstance(wv, dict):
                        key = f"{wv.get('version')}:{wv.get('digest')}"
                        versions[key] = versions.get(key, 0) + 1
                    km = (sub.get("kv_migrations")
                          if isinstance(sub, dict) else None)
                    if isinstance(km, dict):
                        for k, v in km.items():
                            if isinstance(v, (int, float)):
                                migration_totals[k] = (
                                    migration_totals.get(k, 0) + int(v))
                replicas[rid] = entry
            router = {
                "replicas_total": len(self.supervisor.replicas),
                "replicas_ready": self.supervisor.ready_count,
                "outstanding_total": sum(
                    r.outstanding
                    for r in self.supervisor.replicas.values()),
            }
            roles: dict[str, int] = {}
            for r in self.supervisor.replicas.values():
                roles[r.role] = roles.get(r.role, 0) + 1
            if set(roles) != {"monolithic"}:
                # Disaggregated fleet: role census + fleet-summed
                # migration counters, so "are handoffs landing" is one
                # router healthz away.
                router["roles"] = roles
                if migration_totals:
                    router["kv_migrations"] = migration_totals
                if self._kv_directory or self.kv_push:
                    router["kv_directory"] = self.kv_directory_stats()
            if versions:
                router["weight_versions"] = versions
                router["mixed_weight_versions"] = len(versions) > 1
            if self.telemetry_interval_s > 0:
                router["slo"] = self.slo.overall()
                router["telemetry"] = self.telemetry_stats()
            crash = self.supervisor.last_crash_summary()
            if crash is not None:
                router["last_crash"] = crash
            return {"healthz": {
                "router": router,
                "replicas": replicas,
            }}
        if cmd == "metricsz":
            if spec.get("format") == "prometheus":
                from distkeras_tpu_torch.telemetry.exposition import prometheus_text

                # The router's own page followed by the fleet-merged
                # page (per-replica AND fleet="all" series folded from
                # pushed deltas) — one scrape target for the fleet.
                pages = []
                if self.registry is not None:
                    pages.append(prometheus_text(self.registry))
                pages.append(prometheus_text(self.fleet.registry))
                return {"metricsz": "\n".join(pages)}
            infos = list(self.supervisor.replicas.items())
            fetched = await asyncio.gather(*(
                self._fetch_verb(info, "metricsz") for _, info in infos))
            replicas = {rid: sub for (rid, _), sub in zip(infos, fetched)
                        if sub is not None}
            out = {"replicas": replicas}
            if self.registry is not None:
                out["router"] = self.registry.snapshot()
            return {"metricsz": out}
        if cmd == "debugz":
            infos = list(self.supervisor.replicas.items())
            fetched = await asyncio.gather(*(
                self._fetch_verb(info, "debugz") for _, info in infos))
            replicas = {}
            for (rid, info), sub in zip(infos, fetched):
                entry = info.public()
                # Backoff state: how suspicious the supervisor currently
                # is of this replica (exponent feeding the restart delay).
                entry["consecutive_restarts"] = info.consecutive_restarts
                if sub is not None:
                    entry["debugz"] = sub
                replicas[rid] = entry
            out = {
                "router": {
                    "replicas_total": len(self.supervisor.replicas),
                    "replicas_ready": self.supervisor.ready_count,
                    "outstanding_total": sum(
                        r.outstanding
                        for r in self.supervisor.replicas.values()),
                    "pooled_connections": sum(
                        len(p) for p in self._pools.values()),
                },
                "replicas": replicas,
                "restart_log": self.supervisor.restart_log_entries(),
            }
            if self.trace_store is not None:
                out["router"]["trace_store"] = self.trace_store.stats()
            if self._kv_directory or self.kv_push:
                out["router"]["kv_directory"] = self.kv_directory_stats()
            if self.telemetry_interval_s > 0:
                out["router"]["telemetry"] = self.telemetry_stats()
                out["slo"] = self.slo.snapshot()
            if self.supervisor.last_crash is not None:
                # The most recent crash's bounded flight-recorder dump
                # — healthz carries the pointer, debugz carries the
                # post-mortem itself.
                out["last_crash"] = self.supervisor.last_crash
            return {"debugz": out}
        if cmd == "sloz":
            # On-demand evaluation so the page is never staler than the
            # caller (the background loop also evaluates each tick).
            self.fleet.store.flush()
            try:
                self.slo.evaluate()
            except Exception:
                pass
            await self._pin_slo_exemplars()
            out = {**self.slo.snapshot(),
                   "aggregation": self.telemetry_stats()}
            if self._slo_pinned:
                out["pinned_exemplars"] = sorted(self._slo_pinned)
            return {"sloz": out}
        if cmd == "queryz":
            return await self._queryz(spec)
        if cmd == "tracez":
            return await self._tracez(spec)
        if cmd == "reload":
            return await self.rolling_reload(spec)
        if cmd == "deployz":
            if self.deploy_controller is None:
                return {"error": "no deploy controller is attached to "
                                 "this router (start one with `run.py "
                                 "deploy`)", "code": "bad_request"}
            return {"deployz": self.deploy_controller.deployz()}
        return {"error": f"unknown cmd {cmd!r}", "code": "bad_request"}

    async def _queryz(self, spec: dict) -> dict:
        """Fleet wide-event analytics: fan one query out to every
        routable replica's columnar store and merge the group rows.
        Counts and sums add exactly; every percentile aggregate carries
        its histogram state on the shared bucket layout, so the fleet
        p99 is folded bucket-exactly through ``merge_hist_states`` —
        the same merge the telemetry push plane trusts — never an
        average of per-replica p99s."""
        extra = {k: spec[k] for k in
                 ("where", "group_by", "aggs", "max_groups") if k in spec}
        infos = list(self.supervisor.replicas.items())
        fetched = await asyncio.gather(*(
            self._fetch_verb(info, "queryz", extra) for _, info in infos))
        replicas: dict[str, dict] = {}
        mergeable = []
        for (rid, _info), sub in zip(infos, fetched):
            if not isinstance(sub, dict):
                continue
            if "matched" in sub:
                entry = {"matched": sub.get("matched"),
                         "scanned": sub.get("scanned")}
                stats = sub.get("stats")
                if isinstance(stats, dict):
                    entry["appended"] = stats.get("appended")
                replicas[rid] = entry
                mergeable.append(sub)
            else:
                # Unreachable / bad_request from one replica: reported
                # per-replica, never sinking the whole fleet page.
                replicas[rid] = sub
        if not mergeable:
            for sub in replicas.values():
                if sub.get("code") == "bad_request":
                    # A typed query error is deterministic — every
                    # replica rejected it the same way; surface one.
                    return {"error": sub.get("error", "bad request"),
                            "code": "bad_request"}
            return {"error": "no replica returned wide-event results "
                             "(fleet empty, unreachable, or started "
                             "without --wide-events)",
                    "code": "unavailable", "replicas": replicas}
        merged = merge_query_results(mergeable)
        merged["replicas"] = replicas
        return {"queryz": merged}

    async def _pin_slo_exemplars(self) -> list[str]:
        """Pin every SLO page-event exemplar trace id fleet-wide: into
        the router's own store AND every routable replica's (a
        ``tracez`` pin fan-out), so the traces a page alert references
        stay retrievable no matter how much traffic rolls the sliding
        windows afterwards. Idempotent per id; replica-side pins are
        best-effort (a replica restarted later lost the engine record
        anyway — the router's routing hop survives here)."""
        fresh: list[str] = []
        for ev in list(self.slo.events):
            if ev.get("to") != "page":
                continue
            for tid in ev.get("exemplars") or ():
                tid = sanitize_trace_id(tid)
                if tid and tid not in self._slo_pinned:
                    self._slo_pinned.add(tid)
                    fresh.append(tid)
        if not fresh:
            return []
        if self.trace_store is not None:
            for tid in fresh:
                self.trace_store.pin(tid)
        infos = list(self.supervisor.replicas.items())
        await asyncio.gather(*(
            self._fetch_verb(info, "tracez", {"pin": fresh})
            for _, info in infos))
        return fresh

    async def _tracez(self, spec: dict) -> dict:
        """Cross-process trace assembly: the router's own routing record
        for ``trace_id`` merged with every live replica's engine
        record(s) for it — ONE trace spanning client-visible hops. A hop
        served by a replica that has since died is still visible through
        the router's dispatch events (and its engine timeline survives
        in that replica's flight-recorder dump)."""
        if self.trace_store is None:
            return {"error": "request tracing is not enabled on this "
                             "router", "code": "bad_request"}
        pins = spec.get("pin")
        if pins:
            if isinstance(pins, str):
                pins = [pins]
            pinned = [t for t in (sanitize_trace_id(p) for p in pins) if t]
            for t in pinned:
                self.trace_store.pin(t)
            # Forward fleet-wide: an operator pinning through the front
            # port means "keep this everywhere its hops live".
            infos = list(self.supervisor.replicas.items())
            await asyncio.gather(*(
                self._fetch_verb(info, "tracez", {"pin": pinned})
                for _, info in infos))
            return {"tracez": {"pinned": pinned,
                               "stats": self.trace_store.stats()}}
        tid = spec.get("trace_id")
        if not tid:
            try:
                n = int(spec.get("n", 20))
            except (TypeError, ValueError):
                return {"error": f"bad n {spec.get('n')!r}",
                        "code": "bad_request"}
            return {"tracez": {"recent": self.trace_store.recent(n),
                               **self.trace_store.stats()}}
        tid = str(tid)
        infos = list(self.supervisor.replicas.items())
        fetched = await asyncio.gather(*(
            self._fetch_verb(info, "tracez", {"trace_id": tid})
            for _, info in infos))
        records: list[dict] = list(self.trace_store.get_all(tid))
        for (_, info), sub in zip(infos, fetched):
            if isinstance(sub, dict):
                records.extend(h for h in sub.get("hops", [])
                               if isinstance(h, dict))
        return {"tracez": merge_trace(tid, records)}

    # -- rolling reload -----------------------------------------------------
    async def rolling_reload(self, spec: dict) -> dict:
        """Drain -> swap -> readmit, one replica at a time.

        At most one replica is ever out of routing, so a cluster of N
        serves on >= N-1 replicas throughout; in-flight streams on the
        draining replica run to completion before its swap (the replica
        table's ``outstanding`` count gates it), so no client sees a cut
        stream. Serialized: a concurrent reload waits its turn.
        """
        path = spec.get("weights")
        if not path:
            return {"error": "reload requires a 'weights' path",
                    "code": "bad_request"}
        try:
            drain_timeout = float(spec.get("drain_timeout", 60.0))
            swap_timeout = float(spec.get("timeout", 120.0))
        except (TypeError, ValueError) as e:
            # Wire input must fail typed, not kill the handler loop —
            # same stance as ServingServer's bad_request paths.
            return {"error": f"bad reload timeout: {e}",
                    "code": "bad_request"}
        # Drain-by-migration: instead of waiting out every in-flight
        # stream on the draining replica (a long generation holds the
        # roll hostage for its whole decode), actively MIGRATE them —
        # each classic relay is poked, its request re-dispatches to a
        # peer with the streamed tokens folded in as a resume and the
        # KV pulled from the draining replica's pool (the cancelled
        # slot's blocks were adopted there). The client stream is never
        # cut. Opt-in per reload (``migrate: true``); a migrated
        # stream's continuation runs under whatever weights its NEW
        # replica serves, so mid-roll migrations may hop onto the
        # candidate weights — the drain-wait default keeps strict
        # same-weights completion instead.
        migrate = bool(spec.get("migrate"))
        migrated = 0
        reloaded: list[str] = []
        failed: dict[str, str] = {}
        replicas: dict[str, dict] = {}
        async with self._reload_lock:
            with span("rolling_reload", weights=path):
                for rid, info in list(self.supervisor.replicas.items()):
                    if info.status != READY:
                        failed[rid] = f"skipped: status={info.status}"
                        continue
                    # Provenance BEFORE the swap: callers (the deploy
                    # controller, operators) verify the roll from this
                    # one reply instead of a second healthz fan-out.
                    # Probed while the replica is still READY — the
                    # version can't change before its own swap, and the
                    # probe's round trip must not widen the N-1 window.
                    before = None
                    try:
                        h = await self._backend_control(
                            info, {"cmd": "healthz"})
                        before = h.get("healthz", {}).get(
                            "weight_version")
                    except (OSError, ValueError,
                            asyncio.TimeoutError, _BackendLost):
                        pass  # the reload itself is the gate
                    info.status = DRAINING
                    try:
                        with span("reload_replica", replica=rid):
                            if migrate:
                                migrated += self.migrate_streams(rid)
                            deadline = time.monotonic() + drain_timeout
                            while info.outstanding > 0:
                                if time.monotonic() > deadline:
                                    raise TimeoutError(
                                        f"drain timed out with "
                                        f"{info.outstanding} outstanding")
                                await asyncio.sleep(0.01)
                            rep = await self._backend_control(
                                info,
                                {"cmd": "reload", "weights": path,
                                 "timeout": swap_timeout},
                                timeout=swap_timeout + 10.0)
                            if "error" in rep:
                                raise RuntimeError(rep["error"])
                            replicas[rid] = {
                                "before": before,
                                "after": rep.get("reload", {}).get(
                                    "weight_version"),
                            }
                        reloaded.append(rid)
                        # From the first successful swap on, this is the
                        # fleet's current version: any replica that
                        # (re)starts later — including one that was DEAD
                        # or failed during THIS roll — is brought to it
                        # before rejoining routing.
                        self.supervisor.current_weights = path
                    except (OSError, ValueError, RuntimeError,
                            TimeoutError, asyncio.TimeoutError,
                            _BackendLost) as e:
                        # The replica keeps its OLD weights but is still
                        # healthy — readmit it rather than shrink the
                        # fleet (a dead one is the supervisor's problem).
                        failed[rid] = str(e)
                    finally:
                        if info.status == DRAINING:
                            info.status = READY
        if not failed and self._c_reloads is not None:
            self._c_reloads.inc()
        out = {"reload": {"weights": path, "reloaded": reloaded,
                          "failed": failed, "ok": not failed,
                          "replicas": replicas}}
        if migrate:
            out["reload"]["migrated_streams"] = migrated
        return out

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, obj: dict) -> None:
        writer.write((json.dumps(obj) + "\n").encode())
        await writer.drain()

    @classmethod
    async def _send_client(cls, writer: asyncio.StreamWriter,
                           obj: dict) -> None:
        """Send to the CLIENT; a dead client raises :class:`_ClientGone`
        so relay/dispatch never mistake it for a replica failure."""
        try:
            await cls._send(writer, obj)
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            raise _ClientGone() from e


class ServingCluster:
    """Supervisor + router wired together: the one-call cluster.

    ``factory``: ``index -> ReplicaHandle`` (see :mod:`.replicas`).
    Extra keyword groups pass through: ``supervisor_kwargs`` to
    :class:`ReplicaSupervisor`, ``router_kwargs`` to :class:`Router`;
    a shared ``registry`` feeds both (and the router's ``metricsz``).
    """

    def __init__(self, factory, n: int, *, host: str = "127.0.0.1",
                 port: int = 0, registry=None,
                 supervisor_kwargs: dict | None = None,
                 router_kwargs: dict | None = None,
                 roles=None):
        self.supervisor = ReplicaSupervisor(
            factory, n, registry=registry, roles=roles,
            **(supervisor_kwargs or {}))
        self.router = Router(self.supervisor, host=host, port=port,
                             registry=registry, **(router_kwargs or {}))
        self._health_task: asyncio.Task | None = None

    @property
    def port(self) -> int:
        return self.router.port

    @property
    def replicas(self) -> dict[str, ReplicaInfo]:
        return self.supervisor.replicas

    async def start(self) -> None:
        await self.supervisor.start()
        self._health_task = asyncio.get_running_loop().create_task(
            self.supervisor.run(), name="replica-health")
        try:
            await self.router.start()
        except BaseException:
            # A front-port bind failure (EADDRINUSE) must not orphan the
            # already-started replica processes or the health task.
            await self.stop()
            raise

    async def stop(self) -> None:
        await self.router.stop()
        await self.supervisor.stop()
        if self._health_task is not None:
            try:
                await asyncio.wait_for(self._health_task, 10.0)
            except asyncio.TimeoutError:
                self._health_task.cancel()

    async def __aenter__(self) -> "ServingCluster":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()
