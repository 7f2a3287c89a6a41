"""Asyncio TCP front end for the serving engine.

Port of the reference's ``distkeras_tpu/serving/server.py`` over the
port's dense :class:`~distkeras_tpu_torch.serving.engine.ServingEngine`:
JSONL and the negotiated bin1 frames (:mod:`.wire`), the ``metricsz``,
``healthz``, ``queryz``, ``tracez``, ``debugz`` and ``inject_latency``
verbs, and the graceful ``stop()``. The verbs and frames of later slices
answer with the reference's typed error record (``{"error": ...,
"code": "bad_request"}``) naming their ROADMAP item: ``kv_export``, ``kv_push``, ``kv_prefill``,
KVBLK frames and the ``kv_from``/``kv_wait`` request hints (the fleet,
A8); ``reload`` (the parameter swap, A7b); ``telemetry_start``,
``telemetry_stop`` and ``telemetryz`` (the pushed telemetry plane of
``telemetry/timeseries.py``, A8).

Wire protocol: newline-delimited JSON, one request object per line in,
a stream of single-line events out:

    -> {"prompt": [1, 2, 3], "max_new_tokens": 8, "temperature": 0.0,
        "priority": 0, "timeout": 30.0}
    <- {"token": 17}              (one line per decoded token, streamed)
    <- {"done": true, "tokens": [17, ...], "ttft_ms": 12.3,
        "latency_ms": 45.6}
    or {"error": "...", "code": "queue_full" | "timeout" | "stopped"
        | "bad_request"}

Control verbs (one reply line, no stream) ride the same protocol:

    -> {"cmd": "metricsz"}                      (live registry snapshot)
    <- {"metricsz": {"serving_ttft_seconds": {...}, ...}}
    -> {"cmd": "metricsz", "format": "prometheus"}
    <- {"metricsz": "# TYPE serving_ttft_seconds histogram\n..."}
    -> {"cmd": "healthz"}
    <- {"healthz": {"slots": 4, "active_slots": 1, "queue_depth": 0,
                    "decode_compile_count": 1, ...}}

``metricsz`` scrapes the engine's
:class:`~distkeras_tpu_torch.telemetry.registry.MetricsRegistry` — the
Prometheus form is the standard text exposition format, so a one-line
sidecar (``echo '{"cmd":"metricsz","format":"prometheus"}' | nc``)
bridges it to a real scrape endpoint without HTTP in-process.

A connection may send requests sequentially (next request after the
previous one's terminal line). JSON-over-TCP rather than HTTP keeps the
dependency surface at zero (same stance as the gRPC-optional PS
transport) while exercising the full online path: admission backpressure,
streaming, and graceful shutdown.
"""

from __future__ import annotations

import asyncio
import json

from distkeras_tpu_torch.serving import wire
from distkeras_tpu_torch.serving.engine import ServingEngine
from distkeras_tpu_torch.serving.scheduler import Request, ServingError
from distkeras_tpu_torch.telemetry.request_trace import sanitize_trace_id

__all__ = ["ServingServer"]

_A8 = "the fleet (ROADMAP.md §A item A8)"
# Verbs of later slices and the item each waits for.
_DEFERRED_VERBS = {
    "kv_export": _A8,
    "kv_push": _A8,
    "kv_prefill": _A8,
    "telemetry_start": "telemetry/timeseries.py (ROADMAP.md §A item A8)",
    "telemetry_stop": "telemetry/timeseries.py (ROADMAP.md §A item A8)",
    "telemetryz": "telemetry/timeseries.py (ROADMAP.md §A item A8)",
    "reload": "the parameter swap (ROADMAP.md §A item A7b)",
}


def _deferred(what: str, item: str) -> dict:
    """The typed error record of a verb or frame of a later slice."""
    return {"error": f"{what} is not ported yet: it comes with {item}",
            "code": "bad_request"}


class ServingServer:
    """TCP wrapper: owns the engine's run() task and the listener.

    ``port=0`` binds an ephemeral port (read back via :attr:`port`) —
    the test/bench-friendly default.

    ``wire``: front-door protocol policy. ``"auto"`` (default) serves
    JSONL exactly as before AND accepts the bin1 upgrade from clients
    that offer it via the hello line (see :mod:`.wire`); ``"jsonl"``
    refuses the upgrade (every peer stays on JSONL — the rollback knob).
    ``flush_interval_s`` is the bin1 token-coalescing window per
    connection: 0 batches within one event-loop tick (no added
    latency), a small positive value trades first-token latency for
    fewer, larger writes under many concurrent streams.
    """

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, *, wire_mode: str = "auto",
                 flush_interval_s: float = 0.0):
        if wire_mode not in ("auto", "jsonl"):
            raise ValueError(
                f"wire_mode must be 'auto' or 'jsonl', got {wire_mode!r}")
        self.engine = engine
        self.host = host
        self.wire_mode = wire_mode
        self.flush_interval_s = float(flush_interval_s)
        self._requested_port = port
        self._server: asyncio.AbstractServer | None = None
        self._engine_task: asyncio.Task | None = None

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("server not started")
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._engine_task = asyncio.create_task(self.engine.run())
        self._server = await asyncio.start_server(
            self._handle, self.host, self._requested_port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._server.serve_forever()

    async def stop(self, drain: bool = True,
                   handler_grace_s: float = 5.0) -> None:
        """Graceful shutdown: stop accepting connections, stop admitting,
        drain in-flight slots (unless ``drain=False``), then return.

        Ordering matters: on Python >= 3.12.1 ``wait_closed()`` blocks
        until every client handler exits, and handlers only exit on
        client EOF — so the engine drain must come FIRST (it terminates
        every stream, letting handlers flush their final lines), and the
        wait for lingering idle connections is bounded by
        ``handler_grace_s`` rather than a client's goodwill."""
        if self._server is not None:
            self._server.close()
        self.engine.shutdown(drain=drain)
        if self._engine_task is not None:
            try:
                await self._engine_task
            except asyncio.CancelledError:
                # The embedder cancelled the engine task directly; the
                # engine has already flushed its requests with errors.
                pass
        if self._server is not None:
            try:
                await asyncio.wait_for(
                    self._server.wait_closed(), handler_grace_s)
            except asyncio.TimeoutError:
                pass  # idle keep-alive clients; loop cleanup cancels them

    def _submit_spec(self, spec: dict) -> Request:
        """One wire spec (JSONL line or decoded bin1 REQ frame) into the
        engine — the protocol-agnostic submit point."""
        return self.engine.submit(
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
        )

    @staticmethod
    def _done_record(req: Request) -> dict:
        done = {
            "done": True,
            "tokens": req.out_tokens,
            "trace_id": req.trace_id,
            "tenant": req.tenant,
            "ttft_ms": round(1e3 * req.ttft, 3),
            "latency_ms": round(1e3 * (req.t_done - req.t_submit), 3),
        }
        if req.kind != "generate":
            done["kind"] = req.kind
        if req.weight_version is not None:
            # Provenance: the exact checkpoint (version + content
            # digest) the serving params came from — a bad answer
            # names its weights.
            done["weight_version"] = req.weight_version
        return done

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                spec: dict = {}
                try:
                    spec = json.loads(line)
                    if isinstance(spec, dict) and spec.get("cmd") == "hello":
                        # Protocol negotiation: a bin1-capable client's
                        # upgrade offer. Unknown peers never send it, so
                        # the JSONL path below stays byte-for-byte.
                        proto = (wire.PROTO_JSONL
                                 if self.wire_mode == "jsonl"
                                 else wire.choose_proto(spec.get("proto")))
                        await self._send(writer, {"hello": {
                            "proto": proto,
                            "fastwire": wire.native_available()}})
                        if proto == wire.PROTO_BIN1:
                            await self._handle_bin1(reader, writer)
                            return  # the frame loop owned the connection
                        continue
                    if isinstance(spec, dict) and "cmd" in spec:
                        await self._send(writer, await self._control(spec))
                        continue
                    if isinstance(spec, dict) and ("kv_from" in spec
                                                   or "kv_wait" in spec):
                        rec = _deferred("a KV handoff (kv_from/kv_wait)", _A8)
                        tid = sanitize_trace_id(spec.get("trace_id"))
                        if tid:
                            rec["trace_id"] = tid
                        await self._send(writer, rec)
                        continue
                    req = self._submit_spec(spec)
                except ServingError as e:
                    await self._send(writer, self._error(e, spec))
                    continue
                except (KeyError, TypeError, ValueError) as e:
                    await self._send(writer, self._error(e, spec,
                                                         code="bad_request"))
                    continue
                try:
                    async for tok in req.tokens():
                        await self._send(writer, {"token": tok})
                except ServingError as e:
                    await self._send(writer, {"error": str(e), "code": e.code,
                                              "trace_id": req.trace_id})
                    continue
                except (ConnectionResetError, BrokenPipeError):
                    # Client walked away mid-stream: release the decode
                    # slot instead of generating tokens nobody will read.
                    req.cancel()
                    raise
                await self._send(writer, self._done_record(req))
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _handle_bin1(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """The negotiated binary front door for one connection.

        Streams are pipelined: any number of REQ frames may be in
        flight, each tagged with the client's stream id. Every REQ that
        arrived in one read is validated and admitted through ONE
        ``engine.submit_many`` call (batched admission), token output is
        coalesced per flush interval into one write for ALL streams
        (:class:`wire.FrameSink`), and a corrupt or oversized frame is a
        typed ``bad_request`` followed by connection close — framing
        cannot be resynchronized, but the failure is never a hung
        read."""
        sink = wire.FrameSink(writer, self.flush_interval_s)
        decoder = wire.FrameDecoder()
        live: dict[int, Request] = {}
        pumps: set[asyncio.Task] = set()
        ctrls: set[asyncio.Task] = set()
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
                batch: list[tuple[int, dict]] = []
                precancelled: set[int] = set()
                for ftype, sid, payload in frames:
                    if ftype == wire.T_REQ:
                        try:
                            batch.append((sid, wire.decode_request(payload)))
                        except wire.WireError as e:
                            sink.send_error(sid, {"error": str(e),
                                                  "code": "bad_request"})
                    elif ftype == wire.T_CANCEL:
                        req = live.get(sid)
                        if req is not None:
                            req.cancel()
                        else:
                            # The REQ may sit in THIS read's batch,
                            # not yet submitted — remember, or a
                            # same-tick cancel is silently lost and the
                            # slot decodes for nobody.
                            precancelled.add(sid)
                    elif ftype == wire.T_CTRL:
                        # As a task: a slow verb must not stall every
                        # multiplexed stream on this connection.
                        ctrl = asyncio.get_running_loop().create_task(
                            self._ctrl_bin1(sid, payload, sink))
                        ctrls.add(ctrl)
                        ctrl.add_done_callback(ctrls.discard)
                    elif ftype == wire.T_KVBLK:
                        sink.send_error(sid, _deferred("a KVBLK frame (kv_import)", _A8))
                    else:
                        sink.send_error(sid, {
                            "error": f"unexpected frame type {ftype}",
                            "code": "bad_request"})
                if batch:
                    plain = []
                    for sid, spec in batch:
                        if "kv_from" in spec or "kv_wait" in spec:
                            sink.send_error(sid, _deferred(
                                "a KV handoff (kv_from/kv_wait)", _A8))
                        else:
                            plain.append((sid, spec))
                    self._admit_bin1(plain, precancelled, live, pumps, sink)
        finally:
            # Client gone (EOF, reset, or corrupt framing): release every
            # in-flight slot instead of decoding for nobody.
            for req in live.values():
                req.cancel()
            for task in list(ctrls):
                task.cancel()
            if pumps or ctrls:
                await asyncio.gather(*pumps, *ctrls,
                                     return_exceptions=True)
            await sink.aclose()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    def _admit_bin1(self, batch, cancelled, live, pumps, sink) -> None:
        """Admit one bin1 read batch's decoded specs through ONE
        ``submit_many`` and start their pumps. ``cancelled`` holds sids
        whose CANCEL raced admission."""
        if not batch:
            return
        loop = asyncio.get_running_loop()
        results = self.engine.submit_many([spec for _, spec in batch])
        for (sid, spec), res in zip(batch, results):
            if isinstance(res, Request):
                live[sid] = res
                if sid in cancelled:
                    res.cancel()
                task = loop.create_task(
                    self._pump_bin1(sid, res, sink, live))
                pumps.add(task)
                task.add_done_callback(pumps.discard)
            else:
                code = ("bad_request"
                        if not isinstance(res, ServingError) else None)
                sink.send_error(sid, self._error(res, spec, code=code))

    async def _ctrl_bin1(self, sid: int, payload,
                         sink: "wire.FrameSink") -> None:
        """One control verb off a bin1 connection, as its own task."""
        try:
            spec = wire.decode_json(payload)
        except wire.WireError as e:
            sink.send_json(wire.T_CTRLR, sid,
                           {"error": str(e), "code": "bad_request"})
            return
        sink.send_json(wire.T_CTRLR, sid, await self._control(spec))

    async def _pump_bin1(self, sid: int, req: Request,
                         sink: "wire.FrameSink",
                         live: dict[int, Request]) -> None:
        """Relay one stream's events into the shared frame sink. Token
        pushes are synchronous buffer appends — the coalescer turns a
        whole decode tick's output across all of this connection's
        streams into one write."""
        try:
            async for tok in req.tokens():
                sink.add_token(sid, tok)
            sink.send_done(sid, self._done_record(req))
        except ServingError as e:
            sink.send_error(sid, {"error": str(e), "code": e.code,
                                  "trace_id": req.trace_id})
        finally:
            live.pop(sid, None)

    @staticmethod
    def _error(e: Exception, spec: dict, code: str | None = None) -> dict:
        """Typed error line; carries the request's trace_id when the wire
        spec supplied one (a rejected request never built a Request, but
        the client's id must still come back so ITS records correlate)."""
        out = {"error": str(e), "code": code or getattr(e, "code", "error")}
        tid = sanitize_trace_id(spec.get("trace_id"))
        if tid:
            out["trace_id"] = tid
        return out

    async def _control(self, spec: dict) -> dict:
        """Handle a control verb; returns the single reply object."""
        cmd = spec.get("cmd")
        if cmd in _DEFERRED_VERBS:
            return _deferred(f"the {cmd} verb", _DEFERRED_VERBS[cmd])
        if cmd == "inject_latency":
            # Fault injection (the SLO bench's breach phase): a host-
            # side sleep per decode iteration. 0 clears it.
            try:
                delay = float(spec.get("decode_delay_s", 0.0))
            except (TypeError, ValueError):
                return {"error": f"bad decode_delay_s "
                                 f"{spec.get('decode_delay_s')!r}",
                        "code": "bad_request"}
            if delay < 0 or delay > 10.0:
                return {"error": f"decode_delay_s out of range ({delay})",
                        "code": "bad_request"}
            self.engine.inject_decode_delay_s = delay
            return {"inject_latency": {"decode_delay_s": delay}}
        if cmd == "debugz":
            return {"debugz": self.engine.debugz()}
        if cmd == "tracez":
            return self._tracez(spec)
        if cmd == "queryz":
            return self._queryz(spec)
        if cmd == "metricsz":
            registry = self.engine.metrics.registry
            # Memory and tenant gauges are refreshed per scrape (a
            # passive registry cannot probe devices or the queue itself).
            self.engine.refresh_memory_metrics()
            self.engine.tenant_snapshot()
            if spec.get("format") == "prometheus":
                from distkeras_tpu_torch.telemetry.exposition import prometheus_text

                return {"metricsz": prometheus_text(registry)}
            return {"metricsz": registry.snapshot()}
        if cmd == "healthz":
            engine = self.engine
            health = {
                "slots": engine.slots,
                "active_slots": engine.active_slots,
                "queue_depth": len(engine.scheduler),
                "decode_compile_count": engine.decode_compile_count(),
                "stopping": engine._stopping,
                "weight_version": engine.weight_version,
                "device_memory": engine.refresh_memory_metrics(),
                # Per-tenant occupancy / queue depth / quota + shed
                # counters — the "is one tenant starving the fleet"
                # page (refreshes the labeled tenant gauges too).
                "tenants": engine.tenant_snapshot(),
                # Decode-pipeline vitals: configured depth + the
                # windowed host-gap view (what depth 1 is hiding).
                "pipeline": {
                    "depth": engine.pipeline_depth,
                    "host_gap_p50_s": engine.metrics.host_gap.gap_p50,
                    "device_idle_ratio":
                        engine.metrics.host_gap.idle_ratio,
                },
            }
            if engine.prefix_cache is not None:
                health["prefix_cache"] = engine.prefix_cache.stats()
            if engine.auditor is not None:
                health["recompile_audit"] = engine.auditor.report()
            if engine.slo_s is not None:
                health["slo_s"] = engine.slo_s
                health["slo_violations"] = engine.metrics.slo_violations
            if engine.flight_recorder is not None:
                health["flight_recorder"] = engine.flight_recorder.stats()
            if engine.wide_events is not None:
                health["wide_events"] = engine.wide_events.stats()
            if engine.trace_store is not None:
                health["trace_store"] = engine.trace_store.stats()
            return {"healthz": health}
        return {"error": f"unknown cmd {cmd!r}", "code": "bad_request"}

    def _queryz(self, spec: dict) -> dict:
        """``{"cmd": "queryz", "where": [...], "group_by": [...],
        "aggs": [...]}``: run one filter/group/aggregate pass over this
        replica's wide-event ring. The reply's percentile payloads
        carry mergeable histogram states — the router fans this verb
        out and folds the group rows bucket-exactly. A parse error
        (unknown column, bad op, >2 group columns) comes back as a
        typed ``bad_request``, never a silent empty result."""
        store = self.engine.wide_events
        if store is None:
            return {"error": "wide-event analytics is disabled on this "
                             "server (wide_events=0)",
                    "code": "bad_request"}
        try:
            kw = {}
            if spec.get("max_groups") is not None:
                kw["max_groups"] = int(spec["max_groups"])
            result = store.query(where=spec.get("where"),
                                 group_by=spec.get("group_by"),
                                 aggs=spec.get("aggs"), **kw)
        except (TypeError, ValueError) as e:
            return {"error": str(e), "code": "bad_request"}
        result["stats"] = store.stats()
        return {"queryz": result}

    def _tracez(self, spec: dict) -> dict:
        """``{"cmd": "tracez", "trace_id": ...}``: this engine's timeline
        record(s) for one request — or, with no trace_id, the most recent
        ``n`` records. The router's tracez merges these per-hop replies
        into the one cross-process trace."""
        store = self.engine.trace_store
        if store is None:
            return {"error": "request tracing is not enabled on this "
                             "server (no trace store)",
                    "code": "bad_request"}
        if spec.get("pin"):
            # SLO page-event exemplar protection: mark ids never-
            # evictable (present or not — pin-before-arrival covers
            # requests another hop finishes later).
            pins = spec["pin"]
            if not isinstance(pins, (list, tuple)):
                pins = [pins]
            pinned = [str(t) for t in pins if store.pin(str(t))]
            # "stats" nests the store counters: its own "pinned" COUNT
            # must not clobber the list of ids just pinned.
            return {"tracez": {"pinned": pinned, "stats": store.stats()}}
        tid = spec.get("trace_id")
        if tid:
            return {"tracez": {"trace_id": str(tid),
                               "hops": store.get_all(str(tid))}}
        try:
            n = int(spec.get("n", 20))
        except (TypeError, ValueError):
            return {"error": f"bad n {spec.get('n')!r}",
                    "code": "bad_request"}
        return {"tracez": {"recent": store.recent(n),
                           # The engine's dispatch->harvest tick lane:
                           # the per-tick view of what the decode
                           # pipeline hides (and what it does not).
                           "ticks": self.engine.tick_timeline(n),
                           **store.stats()}}

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, obj: dict) -> None:
        writer.write((json.dumps(obj) + "\n").encode())
        await writer.drain()
