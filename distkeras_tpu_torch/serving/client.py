"""Client for the serving TCP protocol (see :mod:`.server` for the wire
format). Async-first with a sync convenience wrapper.

Copy of the reference's ``distkeras_tpu/serving/client.py``, which imports no JAX;
only its imports differ.

Speaks both front-door protocols:

- **jsonl** (default): the original newline-delimited JSON — one request
  in flight per connection, maximal compatibility;
- **bin1** (``wire="auto"`` / ``"bin1"``): the negotiated length-
  prefixed binary upgrade (:mod:`.wire`). The hello line is sent at
  connect; a peer that doesn't speak bin1 answers its normal
  unknown-verb ``bad_request`` and ``"auto"`` transparently downgrades
  to jsonl (``"bin1"`` raises instead — the strict mode tests use).
  bin1 connections are **multiplexed**: any number of :meth:`stream`
  calls may run concurrently on one connection, each under its own
  stream id — the client half of the router's 5x front door.
"""

from __future__ import annotations

import asyncio
import itertools
import json
from typing import AsyncIterator, Callable, Sequence

from distkeras_tpu_torch.serving import wire
from distkeras_tpu_torch.serving.scheduler import (
    EngineStopped,
    QueueFullError,
    RequestTimeout,
    ServingError,
    TenantOverQuota,
)
from distkeras_tpu_torch.telemetry.request_trace import (new_trace_id,
                                                   sanitize_trace_id)

__all__ = ["ServingClient", "ServerError"]

_CODE_TO_ERROR = {
    "queue_full": QueueFullError,
    "timeout": RequestTimeout,
    "stopped": EngineStopped,
    "tenant_over_quota": TenantOverQuota,
}


class ServerError(ServingError):
    """Server-side failure that has no more specific typed class."""

    code = "error"


def _raise_for(rec: dict) -> None:
    cls = _CODE_TO_ERROR.get(rec.get("code"), ServerError)
    err = cls(rec.get("error", "server error"))
    # The wire code and trace id ride on the exception: a caller logging
    # a replica_lost failure can hand the id straight to `run.py debugz`
    # / the tracez verb without having kept the request spec around.
    err.code = rec.get("code", cls.code)
    err.trace_id = rec.get("trace_id")
    raise err


class ServingClient:
    """One TCP connection. On jsonl, requests run sequentially per
    connection (open several clients for concurrency — the server
    batches across them); on a negotiated bin1 connection, streams
    multiplex and any number may run concurrently.

    Idempotent control verbs (``metricsz``/``healthz``) transparently
    reconnect with capped exponential backoff when the connection drops —
    same shape as ``parallel/ha.py § RetryingClient`` — so a monitoring
    loop survives a server restart (or a replica bounce behind a router)
    instead of surfacing a raw ``ConnectionResetError``. ``max_retries``
    bounds the attempts, ``base_delay_s``/``max_delay_s`` the backoff;
    ``max_retries=0`` disables retry (health probes that must fail fast).
    Generation streams are NOT retried here: a reconnect would resubmit
    work whose first attempt may still be decoding — the cluster router
    owns that retry, where idempotence is provable.

    ``tenant`` is this client's QoS identity: stamped on every request
    spec (both protocols), it rides client -> router -> replica, keys
    the scheduler's fair queueing and quotas, and comes back on the done
    line. Per-call ``tenant=`` overrides it.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8500, *,
                 max_retries: int = 3, base_delay_s: float = 0.1,
                 max_delay_s: float = 2.0, wire_mode: str = "jsonl",
                 tenant: str | None = None):
        if wire_mode not in ("jsonl", "auto", "bin1"):
            raise ValueError(f"wire_mode must be 'jsonl', 'auto' or "
                             f"'bin1', got {wire_mode!r}")
        self.host = host
        self.port = port
        self.wire_mode = wire_mode
        self.tenant = tenant
        self.max_retries = int(max_retries)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        # Trace id of the most recent stream() (error handlers and
        # monitoring wrappers read it unconditionally — it must exist
        # before the first request too).
        self.last_trace_id: str | None = None
        # The protocol this CONNECTION actually negotiated ("jsonl"
        # until a hello upgrade succeeds).
        self.proto: str = wire.PROTO_JSONL
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._sid = itertools.count(1)
        self._streams: dict[int, asyncio.Queue] = {}
        self._demux_task: asyncio.Task | None = None
        # Set when the bin1 demux loop dies (EOF/reset/corrupt frames):
        # later calls must raise ConnectionError IMMEDIATELY — writing
        # into a dead connection's buffer and awaiting a handler nobody
        # will ever call would hang forever, and the control verbs'
        # reconnect-with-backoff contract keys off the raised OSError.
        self._conn_lost = False

    async def connect(self) -> "ServingClient":
        # Generous line limit: a cluster router's aggregate metricsz
        # (every replica's registry snapshot on ONE line) outgrows
        # StreamReader's 64 KB default well before it stops being a
        # perfectly healthy reply.
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=2**24)
        self.proto = wire.PROTO_JSONL
        self._conn_lost = False
        if self.wire_mode != "jsonl":
            self._writer.write(wire.hello_line())
            await self._writer.drain()
            line = await self._reader.readline()
            if not line:
                raise ConnectionError(
                    "server closed the connection during protocol "
                    "negotiation")
            try:
                rec = json.loads(line)
            except ValueError:
                rec = {}
            # An old server's unknown-verb bad_request lands here too:
            # parse_hello maps anything but an explicit bin1 selection
            # to jsonl — the downgrade IS the compatibility contract.
            self.proto = parse = wire.parse_hello(rec)
            if self.wire_mode == "bin1" and parse != wire.PROTO_BIN1:
                await self.aclose()
                raise ConnectionError(
                    f"peer refused the bin1 upgrade (offered {rec!r}) "
                    f"and wire='bin1' forbids the jsonl downgrade")
            if self.proto == wire.PROTO_BIN1:
                self._demux_task = asyncio.get_running_loop().create_task(
                    self._demux())
        return self

    async def aclose(self) -> None:
        if self._demux_task is not None:
            self._demux_task.cancel()
            try:
                await self._demux_task
            except (asyncio.CancelledError, Exception):
                pass
            self._demux_task = None
        self._fail_streams({"error": "connection closed", "code": "error"})
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
            self._reader = self._writer = None
        self.proto = wire.PROTO_JSONL

    async def __aenter__(self) -> "ServingClient":
        return await self.connect()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # -- bin1 demux ---------------------------------------------------------
    def _fail_streams(self, rec: dict) -> None:
        self._conn_lost = True
        streams, self._streams = self._streams, {}
        for handler in streams.values():
            try:
                # ftype None is the transport-failure event: distinct
                # from a server-sent T_ERR so readers surface
                # ConnectionError, not a typed serving error the server
                # never actually sent.
                handler(None, dict(rec))
            except Exception:
                pass  # one stream's cleanup must not strand the rest

    async def _demux(self) -> None:
        """Read frames off the negotiated bin1 connection and fan them
        out to the per-stream handlers (queue adapters for stream(),
        future resolvers for generate_batch()). A dead connection (EOF,
        reset, corrupt framing) fails every open stream with a typed
        error rather than hanging its reader."""
        decoder = wire.FrameDecoder()
        reader = self._reader
        try:
            while True:
                data = await reader.read(2 ** 18)
                if not data:
                    self._fail_streams({
                        "error": "server closed the connection",
                        "code": "error"})
                    return
                for ftype, sid, payload in decoder.feed(data):
                    handler = self._streams.get(sid)
                    if handler is None:
                        continue  # late frames of a cancelled stream
                    handler(ftype, payload)
        except asyncio.CancelledError:
            raise
        except (OSError, wire.WireError, ValueError) as e:
            self._fail_streams({"error": f"connection failed: {e}",
                                "code": "error"})

    def _spec(self, prompt, max_new_tokens, *, temperature, priority,
              timeout, speculate, tenant, kind="generate", n=1,
              constraint=None) -> dict:
        # Sanitize here too so last_trace_id matches the id the server
        # actually records (Request/router sanitize on their side).
        spec = {
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "priority": int(priority),
            "timeout": timeout,
            "trace_id": self.last_trace_id,
            "speculate": bool(speculate),
        }
        # Kind extras ride the bin1 extras whitelist, which drops falsy
        # values — only stamp them when they carry information, so a
        # plain generate encodes byte-identical to the pre-kinds wire.
        if kind and kind != "generate":
            spec["kind"] = str(kind)
        if n and int(n) > 1:
            spec["n"] = int(n)
        if constraint:
            spec["constraint"] = constraint
        tenant = tenant if tenant is not None else self.tenant
        if tenant:
            spec["tenant"] = str(tenant)
        return spec

    async def stream(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        priority: int = 0,
        timeout: float | None = None,
        trace_id: str | None = None,
        speculate: bool = True,
        tenant: str | None = None,
        kind: str = "generate",
        n: int = 1,
        constraint=None,
    ) -> AsyncIterator[int]:
        """Yield token ids as the server streams them; raises the typed
        :class:`ServingError` subclass matching the server's error code.

        ``trace_id`` is the request's distributed-trace identity: pass
        your own to correlate with caller-side logs, or let the client
        mint one (kept on :attr:`last_trace_id`). The same id tags every
        hop's spans and timeline records, rides back on the ``done`` /
        error line, and keys the ``tracez`` verb's merged trace."""
        if self._writer is None:
            await self.connect()
        self.last_trace_id = sanitize_trace_id(trace_id) or new_trace_id()
        spec = self._spec(prompt, max_new_tokens, temperature=temperature,
                          priority=priority, timeout=timeout,
                          speculate=speculate, tenant=tenant,
                          kind=kind, n=n, constraint=constraint)
        if self.proto == wire.PROTO_BIN1:
            async for tok in self._stream_bin1(spec):
                yield tok
            return
        self._writer.write((json.dumps(spec) + "\n").encode())
        await self._writer.drain()
        while True:
            line = await self._reader.readline()
            if not line:
                raise ConnectionError("server closed the connection")
            rec = json.loads(line)
            if "token" in rec:
                yield rec["token"]
            elif rec.get("done"):
                self.last_done = rec
                return
            else:
                _raise_for(rec)

    async def _stream_bin1(self, spec: dict) -> AsyncIterator[int]:
        """One multiplexed generation stream: REQ frame out, TOK deltas /
        DONE / ERR frames in on this stream's queue. An abandoned
        stream (caller stops iterating) sends a CANCEL frame so the
        server releases the slot — a mux peer can't signal by closing
        the shared connection."""
        if self._conn_lost:
            raise ConnectionError(
                "bin1 connection lost; reconnect before streaming")
        sid = next(self._sid)
        q: asyncio.Queue = asyncio.Queue()

        def handler(ftype, payload):
            if ftype is None:
                q.put_nowait(("lost", payload))
            elif ftype == wire.T_TOK:
                q.put_nowait(("tok", wire.decode_tokens(payload)))
            elif ftype == wire.T_DONE:
                q.put_nowait(("done", wire.decode_json(payload)))
            elif ftype in (wire.T_ERR, wire.T_CTRLR):
                q.put_nowait(("err" if ftype == wire.T_ERR else "ctrl",
                              wire.decode_json(payload)))

        self._streams[sid] = handler
        terminal = False
        try:
            self._writer.write(wire.encode_frame(
                wire.T_REQ, sid, wire.encode_request(spec)))
            await self._writer.drain()
            while True:
                kind, payload = await q.get()
                if kind == "tok":
                    for tok in payload:
                        yield tok
                elif kind == "done":
                    terminal = True
                    self.last_done = payload
                    return
                elif kind == "lost":
                    terminal = True
                    raise ConnectionError(payload.get(
                        "error", "connection failed"))
                else:
                    terminal = True
                    _raise_for(payload)
        finally:
            self._streams.pop(sid, None)
            if not terminal and self._writer is not None \
                    and not self._writer.is_closing():
                try:
                    self._writer.write(wire.encode_frame(
                        wire.T_CANCEL, sid, b""))
                except (ConnectionResetError, BrokenPipeError, OSError):
                    pass

    async def generate(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        on_token: Callable[[int], None] | None = None,
        **kw,
    ) -> dict:
        """Collect a full generation; returns the server's ``done`` record
        (``tokens``, ``ttft_ms``, ``latency_ms``)."""
        async for tok in self.stream(prompt, max_new_tokens, **kw):
            if on_token is not None:
                on_token(tok)
        return self.last_done

    async def sample(self, prompt: Sequence[int], max_new_tokens: int,
                     n: int, **kw) -> dict:
        """Forked sampling: ONE prefill, ``n`` independent completions
        sharing the prompt's KV blocks copy-on-write. The done record's
        ``completions`` holds the ``n`` token lists."""
        return await self.generate(prompt, max_new_tokens,
                                   kind="sample", n=int(n), **kw)

    async def score(self, prompt: Sequence[int], **kw) -> dict:
        """Prefill-only scoring: the done record's ``logprobs`` holds the
        per-token log-probability of ``prompt[i+1]`` given the prefix
        (length ``len(prompt) - 1``); no decode slot is occupied."""
        return await self.generate(prompt, 0, kind="score", **kw)

    async def embed(self, prompt: Sequence[int], **kw) -> dict:
        """Prefill-only embedding: the done record's ``embedding`` holds
        the mean-pooled final hidden state over the prompt."""
        return await self.generate(prompt, 0, kind="embed", **kw)

    async def generate_batch(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        priority: int = 0,
        timeout: float | None = None,
        speculate: bool = True,
        tenant: str | None = None,
        kind: str = "generate",
        n: int = 1,
        constraint=None,
    ) -> list:
        """Submit MANY generations at once and await them all — the
        client half of batched admission. On a negotiated bin1
        connection every request rides one buffered write of REQ frames
        and resolves through a per-stream future (no token streaming, no
        per-request async generator — the cheapest possible path, which
        is what a throughput-bound caller wants); on jsonl it degrades
        to sequential :meth:`generate` calls. Returns a list aligned
        with ``prompts``: the done record per success, the typed
        exception per per-request failure (one rejected request must
        not fail its batchmates)."""
        if self._writer is None:
            await self.connect()
        if self.proto != wire.PROTO_BIN1:
            out: list = []
            for p in prompts:
                try:
                    out.append(await self.generate(
                        p, max_new_tokens, temperature=temperature,
                        priority=priority, timeout=timeout,
                        speculate=speculate, tenant=tenant,
                        kind=kind, n=n, constraint=constraint))
                except ServingError as e:
                    out.append(e)
            return out
        if self._conn_lost:
            raise ConnectionError("bin1 connection lost; reconnect "
                                  "before submitting a batch")
        loop = asyncio.get_running_loop()
        tenant = tenant if tenant is not None else self.tenant
        sids: list[int] = []
        entries: list = []  # a Future, or the per-item typed exception
        buf = bytearray()
        for p in prompts:
            spec = {
                "prompt": p, "max_new_tokens": int(max_new_tokens),
                "temperature": float(temperature),
                "priority": int(priority), "timeout": timeout,
                "speculate": bool(speculate),
            }
            if kind and kind != "generate":
                spec["kind"] = str(kind)
            if n and int(n) > 1:
                spec["n"] = int(n)
            if constraint:
                spec["constraint"] = constraint
            if tenant:
                spec["tenant"] = str(tenant)
            try:
                # Encode BEFORE registering anything: one unencodable
                # prompt must become its own slot in the result list,
                # never fail its batchmates or leak their handlers.
                payload = wire.encode_request(spec)
            except wire.WireError as e:
                entries.append(e)
                continue
            fut = loop.create_future()

            def handler(ftype, payload, fut=fut):
                if fut.done():
                    return
                if ftype == wire.T_DONE:
                    fut.set_result(wire.decode_json(payload))
                elif ftype is None:
                    fut.set_exception(ConnectionError(
                        (payload or {}).get("error",
                                            "connection failed")))
                elif ftype == wire.T_ERR:
                    try:
                        _raise_for(wire.decode_json(payload))
                    except ServingError as e:
                        fut.set_exception(e)
                # T_TOK deltas are skipped: the done record carries the
                # full token list, and this API is for callers that
                # want completions, not streams.

            sid = next(self._sid)
            self._streams[sid] = handler
            sids.append(sid)
            entries.append(fut)
            buf += wire.encode_frame(wire.T_REQ, sid, payload)
        try:
            if buf:
                self._writer.write(bytes(buf))
                await self._writer.drain()
            done = iter(await asyncio.gather(
                *(e for e in entries if isinstance(e, asyncio.Future)),
                return_exceptions=True))
            return [e if not isinstance(e, asyncio.Future) else next(done)
                    for e in entries]
        finally:
            for sid in sids:
                self._streams.pop(sid, None)

    async def _control_once(self, spec: dict) -> dict:
        if self._writer is None:
            await self.connect()
        if self.proto == wire.PROTO_BIN1:
            if self._conn_lost:
                # The demux loop died: raise the transport error NOW so
                # the retry wrapper reconnects, instead of registering a
                # handler nothing will ever call.
                raise ConnectionError("bin1 connection lost")
            sid = next(self._sid)
            fut = asyncio.get_running_loop().create_future()

            def handler(ftype, payload):
                if fut.done():
                    return
                if ftype is None:
                    fut.set_exception(ConnectionError(
                        (payload or {}).get("error", "connection failed")))
                else:
                    fut.set_result(wire.decode_json(payload))

            self._streams[sid] = handler
            try:
                self._writer.write(wire.encode_json_frame(
                    wire.T_CTRL, sid, spec))
                await self._writer.drain()
                rec = await fut
            finally:
                self._streams.pop(sid, None)
        else:
            self._writer.write((json.dumps(spec) + "\n").encode())
            await self._writer.drain()
            line = await self._reader.readline()
            if not line:
                raise ConnectionError("server closed the connection")
            rec = json.loads(line)
        if "error" in rec:
            _raise_for(rec)
        return rec

    async def _control(self, spec: dict, *, retry: bool = False) -> dict:
        """One control round trip. With ``retry`` (idempotent verbs only)
        a dropped/refused connection is retried over a FRESH connection
        with capped exponential backoff; server-side typed errors
        (:class:`ServingError`) always propagate immediately — only the
        transport is retried, never a server that answered."""
        if not retry or self.max_retries <= 0:
            return await self._control_once(spec)
        delay = self.base_delay_s
        last: BaseException | None = None
        for attempt in range(self.max_retries + 1):
            try:
                return await self._control_once(spec)
            except (OSError, ValueError) as e:
                # OSError covers ConnectionResetError/BrokenPipeError/
                # ConnectionRefusedError; ValueError covers the
                # JSONDecodeError of a reply truncated by a mid-write
                # server death. Either way the dead connection is
                # dropped so the next attempt dials fresh.
                last = e
                await self.aclose()
                if attempt < self.max_retries:
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, self.max_delay_s)
        raise ConnectionError(
            f"control verb {spec.get('cmd')!r} failed after "
            f"{self.max_retries + 1} attempts") from last

    async def metricsz(self, format: str | None = None):
        """Scrape the server's live metrics registry: a nested dict by
        default, the Prometheus text page with ``format="prometheus"``.
        Reconnects with backoff on a dropped connection (idempotent)."""
        spec = {"cmd": "metricsz"}
        if format is not None:
            spec["format"] = format
        return (await self._control(spec, retry=True))["metricsz"]

    async def healthz(self) -> dict:
        """Engine liveness snapshot (slots, queue depth, compile count).
        Reconnects with backoff on a dropped connection (idempotent)."""
        return (await self._control({"cmd": "healthz"},
                                    retry=True))["healthz"]

    async def debugz(self) -> dict:
        """Live introspection page: slot table, queue ages, prefix-cache
        trie occupancy (fleet-aggregated when pointed at a router).
        Reconnects with backoff on a dropped connection (idempotent)."""
        return (await self._control({"cmd": "debugz"},
                                    retry=True))["debugz"]

    async def tracez(self, trace_id: str | None = None, n: int = 20):
        """One request's timeline by trace id (a MERGED cross-process
        trace when pointed at a router), or the most recent ``n`` records
        with no id. Reconnects with backoff (idempotent)."""
        spec: dict = {"cmd": "tracez", "n": int(n)}
        if trace_id is not None:
            spec["trace_id"] = str(trace_id)
        return (await self._control(spec, retry=True))["tracez"]

    async def queryz(self, where=None, group_by=None, aggs=None,
                     max_groups: int | None = None) -> dict:
        """Wide-event analytics over the server's columnar per-request
        store (fleet-merged with bucket-exact percentiles when pointed
        at a router). ``where``: term strings like ``"kind=sample"`` /
        ``"ttft_s>0.25"``; ``group_by``: ≤2 column names; ``aggs``:
        specs like ``"count"`` / ``"mean:latency_s"`` / ``"p99:ttft_s"``.
        Reconnects with backoff (idempotent)."""
        spec: dict = {"cmd": "queryz"}
        if where:
            spec["where"] = [str(t) for t in where]
        if group_by:
            spec["group_by"] = [str(c) for c in group_by]
        if aggs:
            spec["aggs"] = [str(a) for a in aggs]
        if max_groups is not None:
            spec["max_groups"] = int(max_groups)
        return (await self._control(spec, retry=True))["queryz"]

    async def pin_traces(self, trace_ids) -> dict:
        """Pin trace ids never-evictable in the target's trace store
        (fans out fleet-wide through a router)."""
        ids = [str(t) for t in ([trace_ids] if isinstance(trace_ids, str)
                                else trace_ids)]
        return (await self._control({"cmd": "tracez", "pin": ids},
                                    retry=True))["tracez"]

    async def deployz(self) -> dict:
        """Continuous-deployment state (current / last-good / candidate
        versions, deploy history ring, quarantine records) from a router
        with an attached DeployController. Reconnects with backoff
        (idempotent)."""
        return (await self._control({"cmd": "deployz"},
                                    retry=True))["deployz"]

    async def reload(self, weights: str, timeout: float = 60.0,
                     migrate: bool = False) -> dict:
        """Hot-swap weights: a rolling reload when pointed at a cluster
        router, a single-engine swap when pointed at one server. NOT
        transport-retried (a retry could double-trigger a long rolling
        drain); callers handle ``ConnectionError`` themselves.

        ``migrate=True`` (router only): drain each replica by MIGRATING
        its live streams to peers (KV blocks pulled, streamed tokens
        folded into a resume) instead of waiting them out — long
        generations no longer hold the roll hostage. Migrated streams
        continue on whatever weights their new replica serves."""
        spec = {"cmd": "reload", "weights": weights, "timeout": timeout}
        if migrate:
            spec["migrate"] = True
        return (await self._control(spec))["reload"]

    def generate_sync(self, prompt: Sequence[int], max_new_tokens: int,
                      **kw) -> dict:
        """Blocking one-shot convenience (opens and closes a connection)."""

        async def go():
            async with ServingClient(self.host, self.port,
                                     wire_mode=self.wire_mode,
                                     tenant=self.tenant) as c:
                return await c.generate(prompt, max_new_tokens, **kw)

        return asyncio.run(go())
