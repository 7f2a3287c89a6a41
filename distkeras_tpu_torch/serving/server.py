"""Asyncio TCP front end for the serving engine.

Copy of the reference's ``distkeras_tpu/serving/server.py`` over the
port's :class:`~distkeras_tpu_torch.serving.engine.ServingEngine`; only its
imports differ, and the pipeline-stage and mesh rows of ``healthz``, which
come with the multi-device slice (ROADMAP.md §A item A10), are left out.

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
import time

from distkeras_tpu_torch.serving import wire
from distkeras_tpu_torch.serving.engine import ServingEngine
from distkeras_tpu_torch.serving.kv_transfer import KVTransferError, fetch_blocks
from distkeras_tpu_torch.serving.scheduler import Request, ServingError
from distkeras_tpu_torch.telemetry.request_trace import sanitize_trace_id

__all__ = ["ServingServer"]


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
                 flush_interval_s: float = 0.0,
                 kv_transfer_timeout_s: float = 10.0):
        if wire_mode not in ("auto", "jsonl"):
            raise ValueError(
                f"wire_mode must be 'auto' or 'jsonl', got {wire_mode!r}")
        self.engine = engine
        self.host = host
        self.wire_mode = wire_mode
        self.flush_interval_s = float(flush_interval_s)
        # Bound on one KV block migration (peer pull + local adopt):
        # past it the request simply prefills monolithic — a slow link
        # must cost latency once, never wedge admission.
        self.kv_transfer_timeout_s = float(kv_transfer_timeout_s)
        self._requested_port = port
        self._server: asyncio.AbstractServer | None = None
        self._engine_task: asyncio.Task | None = None
        # JSONL telemetry fallback: one shared DeltaEncoder, lazily
        # created — the ``telemetryz`` verb returns "what changed since
        # the last poll" for pollers that never negotiated bin1.
        self._telemetryz_enc = None

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

    async def _import_from_peer(self, spec: dict) -> dict | None:
        """Disaggregated handoff, receiving side: a spec carrying
        ``kv_from`` names the replica whose pool already holds this
        prompt's prefilled KV blocks (the router prefilled it there, or
        a draining replica adopted a migrating slot's blocks). Pull
        them (ONE KVBLK frame) and adopt them into our pool, so the
        admission that follows is a zero-copy prefix hit and the
        decode batch never pays the prefill.

        EVERY failure — peer unreachable/miss, slow link, provenance
        mismatch, pool-dry receiver — returns a ``fallback`` info dict
        and the request prefills monolithic: disaggregation can only
        help, never surface a client-visible error. Returns None when
        the spec has no ``kv_from``."""
        src = spec.pop("kv_from", None)
        if not isinstance(src, dict):
            return None
        eng = self.engine
        info: dict = {"from": f"{src.get('host')}:{src.get('port')}"}
        # The peer holds blocks for the full resident sequence — for a
        # migrated slot that includes the tokens already streamed.
        tokens = list(spec.get("prompt") or ())
        tokens += list(spec.get("resume_tokens") or ())
        t0 = time.monotonic()
        try:
            payload = await asyncio.wait_for(
                fetch_blocks(str(src.get("host")), int(src.get("port")),
                             tokens, timeout=self.kv_transfer_timeout_s,
                             trace_id=spec.get("trace_id")),
                self.kv_transfer_timeout_s)
            if payload is None:
                info["fallback"] = "peer_miss"
            else:
                event, result = eng.request_kv_import(payload)
                await asyncio.wait_for(event.wait(),
                                       self.kv_transfer_timeout_s)
                err = result.get("error")
                if err is not None:
                    info["fallback"] = str(err)
                elif not result.get("resident_blocks"):
                    info["fallback"] = "pool_dry"
                else:
                    info["bytes"] = result["bytes"]
                    info["matched_tokens"] = result["matched_tokens"]
                    info["adopted_blocks"] = result["adopted_blocks"]
                    info["latency_s"] = round(time.monotonic() - t0, 6)
        except (OSError, ConnectionError, asyncio.TimeoutError,
                KVTransferError, wire.WireError, TypeError,
                ValueError) as e:
            info["fallback"] = f"{type(e).__name__}: {e}"
        if "fallback" in info:
            eng.metrics.record_kv_migration_fallback()
        else:
            eng.metrics.record_kv_migration(
                info["bytes"], info["latency_s"],
                trace_id=spec.get("trace_id"))
        return info

    @staticmethod
    def _note_migration(req: Request, info: dict | None) -> None:
        """Stamp migration info onto the request: the done line carries
        it back to the router (fleet accounting), and the engine's
        timeline gains a ``kv_import`` hop under the request's
        trace_id."""
        if info is None:
            return
        req.kv_migration = info
        if req.trace is not None:
            req.trace.event("kv_import", **info)

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
        if req.fork_completions is not None:
            done["completions"] = req.fork_completions
        if req.logprobs is not None:
            done["logprobs"] = req.logprobs
        if req.embedding is not None:
            done["embedding"] = req.embedding
        if req.weight_version is not None:
            # Provenance: the exact checkpoint (version + content
            # digest) the serving params came from — a bad answer
            # names its weights.
            done["weight_version"] = req.weight_version
        migration = getattr(req, "kv_migration", None)
        if migration is not None:
            # The router's fleet rollup (and the disagg bench) read
            # migration outcomes off done lines — bytes moved, matched
            # tokens, or the fallback reason.
            done["kv_migration"] = migration
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
                    kv_info = None
                    if isinstance(spec, dict) and ("kv_from" in spec
                                                   or "kv_wait" in spec):
                        kv_info = await self._kv_prepare(spec)
                    req = self._submit_spec(spec)
                    self._note_migration(req, kv_info)
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
        telem: dict[int, asyncio.Task] = {}  # telemetry push per sid
        kv_wait: set[int] = set()       # sids whose REQ is pulling KV
        kv_cancelled: set[int] = set()  # cancels that raced a pull
        kv_joiners: dict[int, object] = {}  # per-stream chunk reassembly
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
                        elif sid in kv_wait:
                            # The REQ is mid-KV-pull in a deferred
                            # admission task — remember the cancel for
                            # when it submits.
                            kv_cancelled.add(sid)
                        else:
                            # The REQ may sit in THIS read's batch,
                            # not yet submitted — remember, or a
                            # same-tick cancel is silently lost and the
                            # slot decodes for nobody.
                            precancelled.add(sid)
                    elif ftype == wire.T_CTRL:
                        # As a task: a slow verb (reload waits for the
                        # engine's quiet moment, up to its timeout) must
                        # not stall every multiplexed stream on this
                        # connection.
                        ctrl = asyncio.get_running_loop().create_task(
                            self._ctrl_bin1(sid, payload, sink,
                                            ctrls, telem))
                        ctrls.add(ctrl)
                        ctrl.add_done_callback(ctrls.discard)
                    elif ftype == wire.T_KVBLK:
                        # A pushed KV block chain: adopting it IS the
                        # kv_import verb. Multi-frame chains reassemble
                        # through a per-stream FrameJoiner (a bare KVX1
                        # payload passes straight through); the adopt
                        # runs as a task — it waits for the engine
                        # loop's next iteration.
                        from distkeras_tpu_torch.serving.kv_transfer import (
                            FrameJoiner,
                            KVTransferError,
                        )

                        try:
                            whole = kv_joiners.setdefault(
                                sid, FrameJoiner()).feed(payload)
                        except KVTransferError as e:
                            kv_joiners.pop(sid, None)
                            sink.send_error(sid, {
                                "error": str(e), "code": e.code})
                            continue
                        if whole is None:
                            continue  # more chunk frames owed
                        kv_joiners.pop(sid, None)
                        ctrl = asyncio.get_running_loop().create_task(
                            self._kv_import_frame(sid, whole, sink))
                        ctrls.add(ctrl)
                        ctrl.add_done_callback(ctrls.discard)
                    else:
                        sink.send_error(sid, {
                            "error": f"unexpected frame type {ftype}",
                            "code": "bad_request"})
                if batch:
                    # Disaggregated handoff: specs naming a KV source
                    # pull + adopt their blocks BEFORE admission — in a
                    # DEFERRED task (all of one read batch's pulls run
                    # concurrently there), so a slow or dead peer can
                    # never head-of-line-block this read loop: other
                    # streams' REQ/CANCEL frames keep processing while
                    # the pull waits out its timeout. Plain specs admit
                    # inline through ONE submit_many as before.
                    plain = [(sid, spec) for sid, spec in batch
                             if "kv_from" not in spec
                             and "kv_wait" not in spec]
                    kv_batch = [(sid, spec) for sid, spec in batch
                                if "kv_from" in spec
                                or "kv_wait" in spec]
                    self._admit_bin1(plain, precancelled, {},
                                     live, pumps, sink)
                    if kv_batch:
                        kv_wait.update(sid for sid, _ in kv_batch)
                        task = asyncio.get_running_loop().create_task(
                            self._kv_admit_bin1(kv_batch, kv_wait,
                                                kv_cancelled, live,
                                                pumps, sink))
                        ctrls.add(task)
                        task.add_done_callback(ctrls.discard)
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

    def _admit_bin1(self, batch, cancelled, kv_infos, live, pumps,
                    sink) -> None:
        """Admit one bin1 read batch's decoded specs through ONE
        ``submit_many`` and start their pumps. ``cancelled`` holds sids
        whose CANCEL raced admission; ``kv_infos`` maps batch index ->
        migration info for specs that pulled KV first."""
        if not batch:
            return
        loop = asyncio.get_running_loop()
        results = self.engine.submit_many([spec for _, spec in batch])
        for i, ((sid, spec), res) in enumerate(zip(batch, results)):
            if isinstance(res, Request):
                live[sid] = res
                self._note_migration(res, kv_infos.get(i))
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

    async def _kv_admit_bin1(self, batch, kv_wait, kv_cancelled, live,
                             pumps, sink) -> None:
        """Deferred admission for specs carrying ``kv_from``: pull every
        peer's blocks concurrently, then admit the batch. Off the read
        loop by design — a dead peer costs THESE requests one timeout
        (then monolithic fallback), never the connection's other
        streams."""
        try:
            infos = await asyncio.gather(*(
                self._kv_prepare(spec) for _, spec in batch))
            self._admit_bin1(batch, kv_cancelled,
                             dict(enumerate(infos)), live, pumps, sink)
        finally:
            for sid, _ in batch:
                kv_wait.discard(sid)
                kv_cancelled.discard(sid)

    async def _ctrl_bin1(self, sid: int, payload,
                         sink: "wire.FrameSink",
                         ctrls: set | None = None,
                         telem: dict | None = None) -> None:
        """One control verb off a bin1 connection, as its own task.
        ``kv_export`` is special-cased here because its success reply is
        a BINARY ``KVBLK`` frame (the serialized blocks), not a JSON
        control reply — the reason the verb needs bin1 at all.
        ``telemetry_start``/``telemetry_stop`` manage this connection's
        T_TELEM push task (``telem`` maps sid -> task; the tasks also
        live in ``ctrls`` so connection teardown cancels them)."""
        try:
            spec = wire.decode_json(payload)
        except wire.WireError as e:
            sink.send_json(wire.T_CTRLR, sid,
                           {"error": str(e), "code": "bad_request"})
            return
        if spec.get("cmd") == "telemetry_start" and ctrls is not None:
            try:
                interval = max(0.02, float(spec.get("interval_s", 0.25)))
            except (TypeError, ValueError):
                sink.send_json(wire.T_CTRLR, sid, {
                    "error": f"bad interval_s {spec.get('interval_s')!r}",
                    "code": "bad_request"})
                return
            old = telem.pop(sid, None)
            if old is not None:
                old.cancel()
            task = asyncio.get_running_loop().create_task(
                self._telemetry_push(sid, interval, sink))
            telem[sid] = task
            ctrls.add(task)
            task.add_done_callback(ctrls.discard)
            sink.send_json(wire.T_CTRLR, sid, {
                "telemetry_start": {"interval_s": interval}})
            return
        if spec.get("cmd") == "telemetry_stop" and telem is not None:
            stopped = 0
            for task in list(telem.values()):
                task.cancel()
                stopped += 1
            telem.clear()
            sink.send_json(wire.T_CTRLR, sid,
                           {"telemetry_stop": {"stopped": stopped}})
            return
        if spec.get("cmd") == "kv_export":
            rep = await self._kv_export_verb(spec)
            blob = rep.pop("payload", None)
            if blob:
                from distkeras_tpu_torch.serving.kv_transfer import (
                    KVTransferError,
                    split_frames,
                )

                try:
                    # A chain past one frame ships as sequenced KVXC
                    # chunk frames with a terminal marker; a
                    # single-frame chain stays byte-identical to the
                    # pre-chunking wire.
                    for fp in split_frames(blob):
                        sink.send_raw(wire.T_KVBLK, sid, fp)
                except KVTransferError as e:
                    sink.send_json(wire.T_CTRLR, sid,
                                   {"error": str(e), "code": e.code})
            else:
                sink.send_json(wire.T_CTRLR, sid, rep)
            return
        sink.send_json(wire.T_CTRLR, sid, await self._control(spec))

    async def _telemetry_push(self, sid: int, interval_s: float,
                              sink: "wire.FrameSink") -> None:
        """The replica half of the pushed telemetry plane: every
        ``interval_s``, ship this engine's registry DELTA as one compact
        T_TELEM frame on the subscribing stream. Each subscriber gets
        its own :class:`DeltaEncoder` (delta state is per-consumer), and
        the first push is a full snapshot by construction. Host-side
        dict work only — the engine loop, the device, and the compiled
        executables never see it."""
        from distkeras_tpu_torch.telemetry.timeseries import DeltaEncoder

        enc = DeltaEncoder(self.engine.metrics.registry)
        try:
            while not sink.closed:
                try:
                    # Refresh the passive queue/tenant gauges so pushes
                    # carry live occupancy (same per-scrape refresh
                    # metricsz does, minus the device-memory probe).
                    self.engine.tenant_snapshot()
                except Exception:
                    pass
                payload = json.dumps(enc.delta(),
                                     separators=(",", ":")).encode()
                sink.send_raw(wire.T_TELEM, sid, payload)
                await asyncio.sleep(interval_s)
        except asyncio.CancelledError:
            pass

    async def _kv_export_verb(self, spec: dict) -> dict:
        """Serialize the pool's blocks for a prompt. Success returns
        ``{"payload": bytes, ...}`` (the bin1 handler ships it as a
        KVBLK frame); a miss or typed failure returns a JSON reply."""
        prompt = spec.get("prompt") or []
        try:
            event, result = self.engine.request_kv_export(prompt)
        except (KVTransferError, TypeError, ValueError) as e:
            return {"error": str(e),
                    "code": getattr(e, "code", "bad_request")}
        try:
            await asyncio.wait_for(event.wait(),
                                   self.kv_transfer_timeout_s)
        except asyncio.TimeoutError:
            return {"error": "kv_export timed out waiting for the "
                             "engine loop", "code": "busy"}
        err = result.get("error")
        if err is not None:
            return {"error": str(err),
                    "code": getattr(err, "code", "kv_transfer")}
        if not result.get("payload"):
            return {"kv_export": {"matched_tokens": 0, "blocks": 0}}
        return {"payload": result["payload"],
                "kv_export": {"matched_tokens": result["matched_tokens"],
                              "blocks": result["blocks"],
                              "bytes": result["bytes"]}}

    async def _kv_push(self, spec: dict) -> dict:
        """``{"cmd": "kv_push", "prompt": [...], "to_host": h,
        "to_port": p}``: export this pool's chain for ``prompt``
        (device trie + host tier) and DELIVER it to the named peer as
        KVBLK frame(s) over a pooled connection — the router-scheduled
        P→D transfer that replaces the decode side's adopt-time pull.
        The receiver's ordinary push-import path adopts the frames and
        acks. Failures are typed replies, never raises: the router
        counts them and the decode side falls back to pulling (or
        re-prefilling)."""
        from distkeras_tpu_torch.serving.kv_transfer import push_blocks

        host, port = spec.get("to_host"), spec.get("to_port")
        if not host or not port:
            return {"error": "kv_push needs to_host and to_port",
                    "code": "bad_request"}
        t0 = time.monotonic()
        rep = await self._kv_export_verb(spec)
        payload = rep.pop("payload", None)
        if "error" in rep:
            self.engine.metrics.record_kv_push_fallback()
            return rep
        if not payload:
            # Nothing resident for this prompt: a miss, not a failure
            # (the receiver will prefill; the router counts a fallback).
            return {"kv_push": {"pushed": False, "matched_tokens": 0,
                                "blocks": 0}}
        try:
            imp = await asyncio.wait_for(
                push_blocks(str(host), int(port), payload,
                            timeout=self.kv_transfer_timeout_s),
                self.kv_transfer_timeout_s)
        except (OSError, ConnectionError, asyncio.TimeoutError,
                KVTransferError, wire.WireError) as e:
            self.engine.metrics.record_kv_push_fallback()
            return {"error": f"{type(e).__name__}: {e}",
                    "code": getattr(e, "code", "kv_transfer")}
        latency = time.monotonic() - t0
        self.engine.metrics.record_kv_push(
            len(payload), latency, trace_id=spec.get("trace_id"))
        out = dict(rep.get("kv_export") or {})
        out.update({
            "pushed": True,
            "bytes": len(payload),
            "adopted_blocks": imp.get("adopted_blocks"),
            "resident_blocks": imp.get("resident_blocks"),
            "latency_s": round(latency, 6),
        })
        return {"kv_push": out}

    async def _await_pushed_kv(self, spec: dict) -> dict | None:
        """Decode side of a router-scheduled push: a spec carrying
        ``kv_wait`` was dispatched while its KV blocks were still in
        flight from the prefill replica. Park HERE (on the engine's
        tier-arrival event, not a poll) until the pushed import lands
        in the pool or host tier, then admit — a zero-copy prefix hit
        with no pull on the critical path. On timeout, fall back to an
        adopt-time pull from the named source (counted), and failing
        that, monolithic prefill — never a client-visible error.
        Returns None when the spec has no ``kv_wait``."""
        src = spec.pop("kv_wait", None)
        if not isinstance(src, dict):
            return None
        eng = self.engine
        tokens = list(spec.get("prompt") or ())
        tokens += list(spec.get("resume_tokens") or ())
        t0 = time.monotonic()
        landed = False
        try:
            landed = await eng.wait_for_kv(tokens,
                                           self.kv_transfer_timeout_s)
        except Exception:
            landed = False
        if landed:
            return {"pushed": True,
                    "matched_tokens": eng.kv_pool.probe(tokens),
                    "latency_s": round(time.monotonic() - t0, 6)}
        eng.metrics.record_kv_push_fallback()
        if src.get("host"):
            spec["kv_from"] = {"host": src.get("host"),
                               "port": src.get("port")}
            info = await self._import_from_peer(spec) or {}
            info["push_timeout"] = True
            return info
        return {"fallback": "push_timeout"}

    async def _kv_prepare(self, spec: dict) -> dict | None:
        """Pre-admission KV arrival for one spec: pushed blocks
        (``kv_wait``) first, else an adopt-time pull (``kv_from``)."""
        info = await self._await_pushed_kv(spec)
        if info is not None:
            return info
        return await self._import_from_peer(spec)

    async def _kv_import_frame(self, sid: int, payload,
                               sink: "wire.FrameSink") -> None:
        """Adopt a pushed KVBLK frame (the kv_import verb's frame form);
        reply with the adopt outcome as a control reply."""
        try:
            event, result = self.engine.request_kv_import(bytes(payload))
            await asyncio.wait_for(event.wait(),
                                   self.kv_transfer_timeout_s)
        except (KVTransferError, TypeError, ValueError) as e:
            sink.send_json(wire.T_CTRLR, sid, {
                "error": str(e), "code": getattr(e, "code", "bad_request")})
            return
        except asyncio.TimeoutError:
            sink.send_json(wire.T_CTRLR, sid, {
                "error": "kv_import timed out waiting for the engine "
                         "loop", "code": "busy"})
            return
        err = result.get("error")
        if err is not None:
            sink.send_json(wire.T_CTRLR, sid, {
                "error": str(err),
                "code": getattr(err, "code", "kv_transfer")})
            return
        sink.send_json(wire.T_CTRLR, sid, {"kv_import": {
            k: result[k] for k in ("adopted_blocks", "resident_blocks",
                                   "matched_tokens", "bytes")}})

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
        if cmd == "reload":
            return await self._reload(spec)
        if cmd == "kv_prefill":
            return await self._kv_prefill(spec)
        if cmd == "kv_push":
            return await self._kv_push(spec)
        if cmd == "kv_export":
            # Reachable only over JSONL (the bin1 handler intercepts it
            # to ship a binary KVBLK frame): the blocks cannot ride a
            # JSON line.
            return {"error": "kv_export needs a bin1 connection (the "
                             "reply is a binary KVBLK frame)",
                    "code": "bad_request"}
        if cmd == "telemetryz":
            # JSONL fallback for the telemetry push plane: one delta per
            # poll (full snapshot on the first, or when asked).
            if self._telemetryz_enc is None:
                from distkeras_tpu_torch.telemetry.timeseries import DeltaEncoder

                self._telemetryz_enc = DeltaEncoder(
                    self.engine.metrics.registry)
            try:
                self.engine.tenant_snapshot()
            except Exception:
                pass
            return {"telemetryz": self._telemetryz_enc.delta(
                full=bool(spec.get("full")))}
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
            if engine.kv_pool is not None:
                health["kv_pool"] = engine.kv_pool.stats()
                # Block-migration rollup (the router sums these across
                # the fleet; the "decode fleet starving" runbook reads
                # them here first).
                health["kv_migrations"] = {
                    "migrations": engine.metrics.kv_migrations,
                    "fallbacks": engine.metrics.kv_migration_fallbacks,
                    "bytes": engine.metrics.kv_migration_bytes,
                    "exports": engine.metrics.kv_exports,
                }
                if engine.kv_tier is not None:
                    # Tiered-KV rollup: per-level occupancy + the
                    # spill/readmit/push traffic — the "host tier
                    # thrashing" runbook reads these here first.
                    health["kv_tier"] = {
                        **engine.kv_tier.stats(),
                        "spills": engine.metrics.kv_spills,
                        "spill_bytes": engine.metrics.kv_spill_bytes,
                        "readmits": engine.metrics.kv_readmits,
                        "readmit_bytes": engine.metrics.kv_readmit_bytes,
                        "pushes": engine.metrics.kv_pushes,
                        "push_bytes": engine.metrics.kv_push_bytes,
                        "push_fallbacks":
                            engine.metrics.kv_push_fallbacks,
                    }
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

    async def _kv_prefill(self, spec: dict) -> dict:
        """``{"cmd": "kv_prefill", "prompt": [...]}``: the PREFILL
        replica's half of a disaggregated handoff. Run the prompt
        through admission with ``max_new_tokens=1`` — prefill writes
        its KV blocks into the pool, the slot's teardown ADOPTS every
        complete block into the prefix trie (shareable, exportable),
        and the one sampled token is discarded (the decode replica
        samples its own, token-identically: same weights, same greedy
        rule). A repeated prompt (the cross-replica prefix-share case)
        is a trie hit here and costs only the uncached tail. The reply
        carries what became exportable; failures are typed — the
        router falls back to monolithic dispatch."""
        if self.engine.kv_pool is None:
            return {"error": "kv_prefill requires a paged engine "
                             "(--paged / --kv-pool-mb): only pooled "
                             "blocks are exportable",
                    "code": "kv_transfer"}
        prompt = spec.get("prompt") or []
        try:
            req = self.engine.submit(
                prompt, 1, speculate=False,
                priority=int(spec.get("priority", 0)),
                timeout=spec.get("timeout"),
                trace_id=spec.get("trace_id"),
                tenant=str(spec.get("tenant") or "default"))
        except ServingError as e:
            return self._error(e, spec if isinstance(spec, dict) else {})
        except (KeyError, TypeError, ValueError) as e:
            return self._error(e, spec, code="bad_request")
        try:
            await req.result()
        except ServingError as e:
            return {"error": str(e), "code": e.code,
                    "trace_id": req.trace_id}
        bt = getattr(self.engine, "kv_block_tokens", 0)
        return {"kv_prefill": {
            "ok": True,
            "prompt_tokens": len(req.prompt),
            "blocks": (len(req.prompt) // bt) if bt else 0,
            "trace_id": req.trace_id,
            "weight_version": req.weight_version,
        }}

    async def _reload(self, spec: dict) -> dict:
        """``{"cmd": "reload", "weights": path}``: hot-swap the engine's
        parameters from a serialized-pytree weights file (the replica
        half of the cluster's rolling reload — see
        :meth:`ServingEngine.request_param_swap`).

        The swap runs inside the engine loop once no slot is in flight;
        ``timeout`` (default 60 s) bounds how long this verb waits for
        that quiet moment before answering ``code="busy"`` — a replica
        behind a draining router reaches it almost immediately, a
        standalone server under continuous load may not."""
        path = spec.get("weights")
        if not path:
            return {"error": "reload requires a 'weights' path",
                    "code": "bad_request"}
        try:
            timeout = float(spec.get("timeout", 60.0))
        except (TypeError, ValueError):
            return {"error": f"bad timeout {spec.get('timeout')!r}",
                    "code": "bad_request"}
        loop = asyncio.get_running_loop()
        try:
            from distkeras_tpu_torch.checkpoint import (
                load_weights_file_with_provenance,
            )

            variables, provenance = await loop.run_in_executor(
                None, load_weights_file_with_provenance, path)
            event, result = self.engine.request_param_swap(
                variables, provenance=provenance)
        except RuntimeError as e:
            # Another reload's swap is still pending.
            return {"error": str(e), "code": "busy"}
        except Exception as e:
            # Anything here is bad INPUT (missing path, torn/garbage
            # file, mismatched tree) — a typed reply to this one client,
            # never a dead handler loop.
            return {"error": f"reload failed: {e!r}", "code": "bad_request"}
        try:
            await asyncio.wait_for(event.wait(), timeout)
        except asyncio.TimeoutError:
            if self.engine.cancel_param_swap(event):
                return {"error": f"replica busy: swap did not run within "
                                 f"{timeout}s", "code": "busy"}
            # Withdrawal lost the race: the engine loop already took the
            # swap, so it WILL resolve — report its true outcome rather
            # than a "busy" that leaves the operator believing the old
            # weights are still live. (The engine sets the event even on
            # death mid-swap, so this wait is bounded.)
            await event.wait()
        if "error" in result:
            return {"error": f"reload failed: {result['error']!r}",
                    "code": "error"}
        return {"reload": {"weights": path, "ok": True,
                           "weight_version":
                               result.get("weight_version")}}

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, obj: dict) -> None:
        writer.write((json.dumps(obj) + "\n").encode())
        await writer.drain()
