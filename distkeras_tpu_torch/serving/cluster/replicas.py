"""Replica handles and the shared replica table.

Copy of the reference's ``distkeras_tpu/serving/cluster/replicas.py``,
which imports no JAX; only its imports differ, and :class:`ProcessReplica`
spawns the port's ``distkeras_tpu_torch.run``.

The cluster layer treats one serving replica — a full
:class:`~distkeras_tpu_torch.serving.server.ServingServer` over its own
:class:`~distkeras_tpu_torch.serving.engine.ServingEngine` — as an opaque
process-like unit behind :class:`ReplicaHandle`: start it, learn its
``(host, port)``, poll whether it is alive, kill it hard, or terminate it
gracefully. Two implementations:

- :class:`ProcessReplica` — a real child process running ``python -m
  distkeras_tpu_torch.run serve --port 0 ...``; the replica's JSON banner line
  (printed by ``serve_main``) carries the ephemeral port back. This is
  the deployment shape: a SIGKILL'd replica drops its TCP connections
  exactly like a crashed host.
- :class:`LocalReplica` — an in-process replica (engine + server on the
  current event loop). One process, N engines: each still compiles its
  own decode step, so the cluster invariants (compile-count==1 per
  replica, router retry, rolling reload) are exercised without paying a
  torch import per replica — this is what the tests and the CPU bench use.
  ``kill()`` emulates a crash: the engine task is cancelled mid-flight
  and the listener closed, so in-flight streams terminate with engine
  failure and the handle reports dead.

:class:`ReplicaInfo` is one row of the table the supervisor and router
SHARE: the supervisor owns ``status`` transitions and ``host``/``port``
rebinds across restarts; the router owns the ``outstanding`` request
count (incremented at dispatch, decremented at the terminal line) that
both least-outstanding routing and the rolling reload's drain wait read.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import sys
import time

__all__ = [
    "STARTING",
    "READY",
    "DRAINING",
    "DEAD",
    "ReplicaInfo",
    "ReplicaHandle",
    "LocalReplica",
    "ProcessReplica",
    "EchoServer",
    "EchoReplica",
    "probe_healthz",
    "send_control",
]

# Replica lifecycle states (ReplicaInfo.status). STARTING: launched, not
# yet answering healthz. READY: routable. DRAINING: healthy but removed
# from routing (rolling reload); outstanding requests run to completion.
# DEAD: crashed/wedged; a restart task owns it until READY again.
STARTING = "starting"
READY = "ready"
DRAINING = "draining"
DEAD = "dead"


@dataclasses.dataclass
class ReplicaInfo:
    """One replica's row in the shared cluster table."""

    rid: str
    index: int
    handle: "ReplicaHandle"
    host: str = ""
    port: int = 0
    status: str = STARTING
    outstanding: int = 0  # router-maintained in-flight request count
    restarts: int = 0
    consecutive_failures: int = 0
    consecutive_restarts: int = 0  # backoff exponent; reset on stable READY
    ready_since: float | None = None
    last_health: dict = dataclasses.field(default_factory=dict)
    # Incarnation counter, bumped by the supervisor every time the
    # handle (re)starts. The router keys its pooled connections and
    # negotiated-protocol cache by it: a replica restarted onto the
    # SAME port must never be served by a connection (or a protocol
    # capability) negotiated with its previous life.
    generation: int = 0
    # The front-door protocol the router negotiated with THIS
    # generation ("bin1"/"jsonl"); None = not yet probed.
    wire_proto: str | None = None
    # Fleet role (disaggregated serving): "monolithic" replicas do
    # everything (today's default); "prefill" replicas only take
    # kv_prefill work and export blocks; "decode" replicas take
    # generation dispatches and adopt blocks from prefill peers. The
    # supervisor assigns roles at construction; the router routes by
    # them.
    role: str = "monolithic"

    def public(self) -> dict:
        """The JSON-safe view the router's aggregate healthz exposes."""
        return {
            "status": self.status,
            "role": self.role,
            "host": self.host,
            "port": self.port,
            "outstanding": self.outstanding,
            "restarts": self.restarts,
            "consecutive_failures": self.consecutive_failures,
            "generation": self.generation,
            "wire_proto": self.wire_proto,
        }


async def send_control(host: str, port: int, spec: dict,
                       timeout: float = 5.0) -> dict:
    """One control verb over a fresh bounded connection: connect, one
    line out, one line back. Raises ``OSError``/``asyncio.TimeoutError``
    on an unreachable, dead, or wedged peer."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port, limit=2**24), timeout)
    try:
        writer.write((json.dumps(spec) + "\n").encode())
        await writer.drain()
        line = await asyncio.wait_for(reader.readline(), timeout)
        if not line:
            raise ConnectionError("replica closed the connection")
        return json.loads(line)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass


async def probe_healthz(host: str, port: int, timeout: float = 2.0) -> dict:
    """One-shot ``{"cmd": "healthz"}`` over a fresh connection.

    Raises ``OSError``/``asyncio.TimeoutError`` on an unreachable, dead,
    or WEDGED replica — a connect that succeeds but a reply that never
    comes counts as unhealthy (the supervisor restarts on it), which is
    what catches a live process whose event loop has stalled.
    """
    rec = await send_control(host, port, {"cmd": "healthz"}, timeout)
    if "healthz" not in rec:
        raise ConnectionError(f"malformed healthz reply: {rec!r}")
    return rec["healthz"]


class ReplicaHandle:
    """Lifecycle interface the supervisor drives. Subclass contract:
    ``start`` returns the replica's ``(host, port)`` once it is
    *listening* (healthz readiness is the supervisor's job); ``alive``
    must be a cheap sync poll; ``kill`` is abrupt (crash semantics),
    ``terminate`` is graceful (drain in-flight, then exit).

    ``last_words_path`` (optional attribute/property): where this
    replica's flight recorder dumps on crash — the supervisor collects
    the file into its restart log when the replica dies."""

    last_words_path: str | None = None

    async def start(self) -> tuple[str, int]:
        raise NotImplementedError

    @property
    def alive(self) -> bool:
        raise NotImplementedError

    async def kill(self) -> None:
        raise NotImplementedError

    async def terminate(self) -> None:
        raise NotImplementedError


class LocalReplica(ReplicaHandle):
    """In-process replica: ``engine_factory()`` builds a fresh
    :class:`ServingEngine` (a restart must not inherit the crashed
    engine's state), served on an ephemeral port of ``host``."""

    def __init__(self, engine_factory, host: str = "127.0.0.1"):
        self.engine_factory = engine_factory
        self.host = host
        self.engine = None
        self.server = None
        self._killed = False

    async def start(self) -> tuple[str, int]:
        from distkeras_tpu_torch.serving.server import ServingServer

        self.engine = self.engine_factory()
        self.server = ServingServer(self.engine, host=self.host, port=0)
        await self.server.start()
        return self.host, self.server.port

    @property
    def last_words_path(self) -> str | None:
        """The in-process engine's flight-recorder dump path (crash
        semantics here cancel the engine task, whose failure path writes
        the dump before kill() returns — so the supervisor finds it)."""
        recorder = getattr(self.engine, "flight_recorder", None)
        return recorder.dump_path if recorder is not None else None

    @property
    def alive(self) -> bool:
        if self._killed or self.server is None:
            return False
        task = self.server._engine_task
        return task is not None and not task.done()

    async def kill(self) -> None:
        """Crash semantics: cancel the engine task mid-flight (in-flight
        requests error out, exactly as a device failure would) and close
        the listener. Existing handler connections flush their terminal
        error lines — the router treats those the same as a dropped
        connection (retryable iff zero tokens streamed)."""
        self._killed = True
        if self.server is None:
            return
        if self.server._server is not None:
            self.server._server.close()
        task = self.server._engine_task
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    async def terminate(self) -> None:
        if self._killed or self.server is None:
            return
        self._killed = True
        await self.server.stop(drain=True)


class EchoServer:
    """A protocol-complete, engine-free replica: answers every front-door
    verb (JSONL and the negotiated bin1 upgrade) but "decodes" by
    echoing — each generation request gets ``echo_tokens`` token events
    (the prompt's first token id, or 0) and a done line.

    This is what isolates FRONT-DOOR cost from decode cost:
    ``benchmarks/router_bench.py`` measures the router's requests/s
    ceiling against an echo fleet, and the protocol-negotiation tests
    exercise downgrade/mixed-fleet paths without paying a torch import.

    ``wire_mode``: ``"auto"`` accepts the bin1 upgrade, ``"jsonl"``
    refuses it (the old-but-hello-aware peer), ``"legacy"`` emulates a
    pre-bin1 server — the hello verb itself is unknown and answered
    with the standard ``bad_request``, which is exactly what a client's
    auto-downgrade must survive.

    The disaggregation verbs are emulated too, so router-level
    handoff/fallback logic (and ``router_bench``'s roles mode) runs
    torch-free: ``kv_prefill`` succeeds instantly (or fails typed with
    ``kv_fail=True`` — the fallback-path switch), ``kv_export``
    answers a real KVBLK frame carrying a leafless KVX1 payload (the
    token chain without KV bytes — enough for a peer Echo's pull to
    exercise the genuine :func:`~distkeras_tpu_torch.serving.kv_transfer.
    fetch_blocks` client), and a generation spec carrying ``kv_from``
    performs the REAL peer pull before echoing, reporting the
    ``kv_migration`` outcome on its done line exactly like a real
    replica.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 echo_tokens: int = 1, wire_mode: str = "auto",
                 kv_fail: bool = False, kv_block_tokens: int = 16):
        if wire_mode not in ("auto", "jsonl", "legacy"):
            raise ValueError(f"bad wire_mode {wire_mode!r}")
        self.host = host
        self.echo_tokens = int(echo_tokens)
        self.wire_mode = wire_mode
        self.kv_fail = bool(kv_fail)
        self.kv_block_tokens = int(kv_block_tokens)
        # Real (torch-free) observability stores, so router queryz
        # fan-out/merge and fleet-wide trace pinning are testable
        # against an echo fleet: one wide event per echoed request
        # with DETERMINISTIC synthetic latencies (a pure function of
        # prompt length, never a clock read), and a genuine TraceStore
        # answering tracez pins. Deferred imports keep this module's
        # import graph flat for the bench's many-replica startups.
        from distkeras_tpu_torch.telemetry.request_trace import TraceStore
        from distkeras_tpu_torch.telemetry.wide_events import WideEventStore
        self.wide_events = WideEventStore(capacity=1024)
        self.trace_store = TraceStore(capacity=256)
        self.requests = 0
        self.kind_requests: dict[str, int] = {}
        self.kv_prefills = 0
        self.kv_exports = 0
        self.kv_imports = 0
        self.kv_pushes = 0
        self.kv_fallbacks = 0
        self._requested_port = port
        self._server: asyncio.AbstractServer | None = None

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self._requested_port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass

    # -- replies ------------------------------------------------------------
    def _reply(self, spec: dict) -> list[dict]:
        """The event list (token lines then terminal line) for one spec."""
        cmd = spec.get("cmd")
        if cmd is not None:
            if cmd == "healthz":
                return [{"healthz": {
                    "slots": 0, "active_slots": 0, "queue_depth": 0,
                    "decode_compile_count": -1, "stopping": False,
                    "weight_version": None, "echo": True,
                    "requests": self.requests}}]
            if cmd == "metricsz":
                mz = {"echo_requests_total": {"value": self.requests}}
                for k, v in sorted(self.kind_requests.items()):
                    mz[f'serving_requests_total{{kind="{k}"}}'] = {
                        "value": v}
                return [{"metricsz": mz}]
            if cmd == "reload":
                return [{"reload": {"ok": True, "echo": True,
                                    "weights": spec.get("weights")}}]
            if cmd == "kv_prefill":
                if self.kv_fail:
                    return [{"error": "kv_prefill disabled (kv_fail)",
                             "code": "kv_transfer",
                             "trace_id": spec.get("trace_id")}]
                self.kv_prefills += 1
                prompt = spec.get("prompt") or []
                return [{"kv_prefill": {
                    "ok": True, "echo": True,
                    "prompt_tokens": len(prompt),
                    "blocks": len(prompt) // self.kv_block_tokens,
                    "trace_id": spec.get("trace_id")}}]
            if cmd == "queryz":
                try:
                    result = self.wide_events.query(
                        where=spec.get("where"),
                        group_by=spec.get("group_by"),
                        aggs=spec.get("aggs"),
                        max_groups=int(spec.get("max_groups", 64)))
                except (TypeError, ValueError) as e:
                    return [{"error": f"bad queryz spec: {e}",
                             "code": "bad_request"}]
                result["stats"] = self.wide_events.stats()
                return [{"queryz": result}]
            if cmd == "tracez":
                pins = spec.get("pin")
                if pins:
                    if isinstance(pins, str):
                        pins = [pins]
                    pinned = [str(t) for t in pins
                              if self.trace_store.pin(str(t))]
                    return [{"tracez": {
                        "pinned": pinned,
                        "stats": self.trace_store.stats()}}]
                return [{"tracez": {"recent": [],
                                    "stats": self.trace_store.stats()}}]
            return [{"error": f"unknown cmd {cmd!r}",
                     "code": "bad_request"}]
        prompt = spec.get("prompt") or []
        if not isinstance(prompt, (list, tuple)) or not prompt:
            return [{"error": "prompt must be a non-empty token list",
                     "code": "bad_request",
                     "trace_id": spec.get("trace_id")}]
        try:
            tok = int(prompt[0])
        except (TypeError, ValueError):
            return [{"error": "non-integer prompt token",
                     "code": "bad_request",
                     "trace_id": spec.get("trace_id")}]
        err = self._check_kind(spec)
        if err is not None:
            return [err]
        self.requests += 1
        toks, extra = self._kind_result(spec, tok)
        self._emit_wide(spec, toks, extra)
        done = {"done": True, "tokens": toks,
                "trace_id": spec.get("trace_id"),
                "tenant": spec.get("tenant") or "default",
                "ttft_ms": 0.0, "latency_ms": 0.0}
        done.update(extra)
        return [{"token": t} for t in toks] + [done]

    def _emit_wide(self, spec: dict, toks: list, extra: dict) -> None:
        """One wide event per echoed request. Latency columns are a
        PURE FUNCTION of the prompt (1 ms per prompt token, 1 ms ttft)
        so a test can recompute the expected fleet percentiles offline
        from the prompts it sent — clock reads would make the router-
        merge assertions flaky."""
        prompt = spec.get("prompt") or []
        comps = extra.get("completions")
        self.wide_events.append({
            "trace_id": spec.get("trace_id"),
            "t_done": time.time(),
            "tenant": str(spec.get("tenant") or "default"),
            "kind": str(spec.get("kind") or "generate"),
            "replica": "echo",
            "role": "echo",
            "prompt_tokens": len(prompt),
            "output_tokens": (sum(len(c) for c in comps) if comps
                              else len(toks)),
            "max_new_tokens": int(spec.get("max_new_tokens") or 0),
            "forks": len(comps) if comps else 0,
            "n": int(spec.get("n") or 1),
            "queue_wait_s": 0.0,
            "ttft_s": 0.001,
            "latency_s": 0.001 * len(prompt),
            "status": "ok",
            "slo_verdict": "ok",
            "stream": int(bool(toks)),
        })

    def _check_kind(self, spec: dict) -> dict | None:
        """Mirror the engine's admission-time request-kind validation:
        contradictory combos reject TYPED before any work, so router/QoS
        tests exercise the same client-visible contract torch-free."""
        kind = str(spec.get("kind") or "generate")
        trace_id = spec.get("trace_id")
        if kind not in ("generate", "sample", "score", "embed"):
            return {"error": f"unknown request kind {kind!r}",
                    "code": "bad_request", "trace_id": trace_id}
        try:
            max_new = int(spec.get("max_new_tokens") or 0)
            n = int(spec.get("n") or 1)
        except (TypeError, ValueError):
            return {"error": "non-integer max_new_tokens/n",
                    "code": "bad_request", "trace_id": trace_id}
        if kind in ("score", "embed") and max_new > 0:
            return {"error": f"{kind} is prefill-only: max_new_tokens "
                             "must be 0", "code": "bad_request",
                    "trace_id": trace_id}
        if kind == "sample" and n < 2:
            return {"error": "sample requires n >= 2",
                    "code": "bad_request", "trace_id": trace_id}
        if kind != "sample" and n != 1:
            return {"error": f"n={n} is only valid for kind='sample'",
                    "code": "bad_request", "trace_id": trace_id}
        if spec.get("constraint") and kind != "generate":
            return {"error": "constraint requires kind='generate'",
                    "code": "bad_request", "trace_id": trace_id}
        return None

    def _kind_result(self, spec: dict,
                     tok: int) -> tuple[list[int], dict]:
        """(streamed tokens, done-record extras) per request kind —
        shaped exactly like a real engine's done line: sample carries
        ``completions`` (no streamed tokens), score ``logprobs`` of
        length ``len(prompt) - 1``, embed a pooled ``embedding``."""
        kind = str(spec.get("kind") or "generate")
        self.kind_requests[kind] = self.kind_requests.get(kind, 0) + 1
        if kind == "sample":
            n = int(spec.get("n") or 1)
            return [], {"kind": "sample",
                        "completions": [[tok] * self.echo_tokens
                                        for _ in range(n)]}
        if kind == "score":
            prompt = spec.get("prompt") or []
            return [], {"kind": "score",
                        "logprobs": [0.0] * max(0, len(prompt) - 1)}
        if kind == "embed":
            return [], {"kind": "embed", "embedding": [0.0] * 4}
        return [tok] * self.echo_tokens, {}

    async def _pull_kv(self, spec: dict) -> dict:
        """A generation spec naming a KV source: run the REAL
        :func:`~distkeras_tpu_torch.serving.kv_transfer.fetch_blocks` pull
        against the peer (an Echo peer answers a leafless KVX1
        payload), with every failure folding to a ``fallback`` info —
        the same contract as :meth:`ServingServer._import_from_peer`,
        minus the device adopt."""
        from distkeras_tpu_torch.serving import kv_transfer

        src = spec.pop("kv_from", None) or {}
        info = {"from": f"{src.get('host')}:{src.get('port')}",
                "echo": True}
        tokens = list(spec.get("prompt") or ())
        tokens += list(spec.get("resume_tokens") or ())
        try:
            payload = await asyncio.wait_for(
                kv_transfer.fetch_blocks(
                    str(src.get("host")), int(src.get("port")), tokens,
                    timeout=5.0),
                5.0)
            if payload is None:
                info["fallback"] = "peer_miss"
            else:
                header = kv_transfer.peek_header(payload)
                self.kv_imports += 1
                info["bytes"] = len(payload)
                info["matched_tokens"] = len(header.get("tokens", []))
        except (OSError, ConnectionError, asyncio.TimeoutError,
                TypeError, ValueError) as e:
            info["fallback"] = f"{type(e).__name__}: {e}"
        if "fallback" in info:
            self.kv_fallbacks += 1
        return info

    async def _push_kv(self, spec: dict) -> dict:
        """Router-scheduled P→D push, Echo edition: serialize the
        prompt's chain (leafless) and deliver it to the named peer with
        the REAL :func:`~distkeras_tpu_torch.serving.kv_transfer.push_blocks`
        client — so router push scheduling and its fallback accounting
        run torch-free."""
        from distkeras_tpu_torch.serving import kv_transfer

        if self.kv_fail:
            self.kv_fallbacks += 1
            return {"error": "kv_push disabled (kv_fail)",
                    "code": "kv_transfer",
                    "trace_id": spec.get("trace_id")}
        prompt = list(spec.get("prompt") or ())
        blob = self._kv_export_payload(prompt)
        if blob is None:
            return {"kv_push": {"pushed": False, "matched_tokens": 0,
                                "blocks": 0, "echo": True}}
        try:
            rep = await asyncio.wait_for(
                kv_transfer.push_blocks(
                    str(spec.get("to_host")), int(spec.get("to_port")),
                    blob, timeout=5.0),
                5.0)
        except (OSError, ConnectionError, asyncio.TimeoutError,
                TypeError, ValueError,
                kv_transfer.KVTransferError) as e:
            self.kv_fallbacks += 1
            return {"error": f"kv_push failed: {type(e).__name__}: {e}",
                    "code": "kv_transfer",
                    "trace_id": spec.get("trace_id")}
        self.kv_pushes += 1
        n = len(prompt) // self.kv_block_tokens
        return {"kv_push": {
            "pushed": True, "echo": True, "bytes": len(blob),
            "blocks": n, "matched_tokens": n * self.kv_block_tokens,
            "adopted_blocks": rep.get("adopted_blocks"),
            "trace_id": spec.get("trace_id")}}

    def _kv_export_payload(self, prompt) -> bytes | None:
        """A leafless KVX1 payload over the prompt's complete blocks —
        wire-real (magic, header, token chain, provenance stamp), KV
        bytes elided (an Echo has none)."""
        from distkeras_tpu_torch.serving import kv_transfer

        n = len(prompt) // self.kv_block_tokens
        if n == 0:
            return None
        self.kv_exports += 1
        return kv_transfer.serialize_blocks(
            prompt[:n * self.kv_block_tokens], [],
            block_tokens=self.kv_block_tokens,
            provenance={"version": 0, "digest": None})

    async def _handle(self, reader, writer) -> None:
        from distkeras_tpu_torch.serving import wire

        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    spec = json.loads(line)
                except ValueError:
                    writer.write(b'{"error": "bad json", '
                                 b'"code": "bad_request"}\n')
                    await writer.drain()
                    continue
                if (isinstance(spec, dict) and spec.get("cmd") == "hello"
                        and self.wire_mode != "legacy"):
                    proto = (wire.PROTO_JSONL if self.wire_mode == "jsonl"
                             else wire.choose_proto(spec.get("proto")))
                    writer.write((json.dumps(
                        {"hello": {"proto": proto}}) + "\n").encode())
                    await writer.drain()
                    if proto == wire.PROTO_BIN1:
                        await self._handle_bin1(reader, writer)
                        return
                    continue
                kv_info = None
                if (isinstance(spec, dict) and "kv_from" in spec
                        and "cmd" not in spec):
                    kv_info = await self._pull_kv(spec)
                if (isinstance(spec, dict)
                        and spec.get("cmd") == "kv_push"):
                    # Async verb: can't live in the sync _reply table.
                    recs = [await self._push_kv(spec)]
                else:
                    recs = self._reply(spec if isinstance(spec, dict)
                                       else {})
                if kv_info is not None and recs and recs[-1].get("done"):
                    recs[-1]["kv_migration"] = kv_info
                for rec in recs:
                    writer.write((json.dumps(rec) + "\n").encode())
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _handle_bin1(self, reader, writer) -> None:
        from distkeras_tpu_torch.serving import wire

        decoder = wire.FrameDecoder()
        kv_joiners: dict = {}  # sid -> FrameJoiner (chunked pushes)
        while True:
            data = await reader.read(2 ** 18)
            if not data:
                return
            out = bytearray()
            try:
                frames = decoder.feed(data)
            except wire.WireError as e:
                writer.write(wire.encode_json_frame(
                    wire.T_ERR, 0,
                    {"error": str(e), "code": "bad_request"}))
                await writer.drain()
                return
            for ftype, sid, payload in frames:
                if ftype == wire.T_REQ:
                    try:
                        spec = wire.decode_request(payload)
                    except wire.WireError as e:
                        out += wire.encode_json_frame(
                            wire.T_ERR, sid,
                            {"error": str(e), "code": "bad_request"})
                        continue
                    prompt = spec.get("prompt") or []
                    if not prompt:
                        out += wire.encode_json_frame(
                            wire.T_ERR, sid,
                            {"error": "prompt must be a non-empty token "
                                      "list", "code": "bad_request",
                             "trace_id": spec.get("trace_id")})
                        continue
                    err = self._check_kind(spec)
                    if err is not None:
                        out += wire.encode_json_frame(
                            wire.T_ERR, sid, err)
                        continue
                    kv_info = None
                    if "kv_from" in spec:
                        kv_info = await self._pull_kv(spec)
                    self.requests += 1
                    toks, extra = self._kind_result(spec,
                                                    int(prompt[0]))
                    self._emit_wide(spec, toks, extra)
                    if toks:
                        out += wire.encode_token_frame(sid, toks)
                    done = {
                        "done": True, "tokens": toks,
                        "trace_id": spec.get("trace_id"),
                        "tenant": spec.get("tenant") or "default",
                        "ttft_ms": 0.0, "latency_ms": 0.0}
                    done.update(extra)
                    if kv_info is not None:
                        done["kv_migration"] = kv_info
                    out += wire.encode_json_frame(wire.T_DONE, sid, done)
                elif ftype == wire.T_CTRL:
                    ctrl = wire.decode_json(payload)
                    if ctrl.get("cmd") == "kv_export":
                        if self.kv_fail:
                            out += wire.encode_json_frame(
                                wire.T_CTRLR, sid,
                                {"error": "kv_export disabled (kv_fail)",
                                 "code": "kv_transfer"})
                        else:
                            blob = self._kv_export_payload(
                                ctrl.get("prompt") or [])
                            if blob is None:
                                out += wire.encode_json_frame(
                                    wire.T_CTRLR, sid,
                                    {"kv_export": {"matched_tokens": 0,
                                                   "blocks": 0}})
                            else:
                                out += wire.encode_frame(
                                    wire.T_KVBLK, sid, blob)
                    elif ctrl.get("cmd") == "kv_push":
                        out += wire.encode_json_frame(
                            wire.T_CTRLR, sid, await self._push_kv(ctrl))
                    else:
                        out += wire.encode_json_frame(
                            wire.T_CTRLR, sid, self._reply(ctrl)[0])
                elif ftype == wire.T_KVBLK:
                    # A pushed chain: reassemble KVXC chunks (a bare
                    # KVX1 payload passes straight through), then
                    # acknowledge the adopt (kv_import).
                    from distkeras_tpu_torch.serving import kv_transfer

                    try:
                        whole = kv_joiners.setdefault(
                            sid,
                            kv_transfer.FrameJoiner()).feed(payload)
                    except kv_transfer.KVTransferError as e:
                        kv_joiners.pop(sid, None)
                        out += wire.encode_json_frame(
                            wire.T_CTRLR, sid,
                            {"error": str(e), "code": e.code})
                        continue
                    if whole is None:
                        continue  # more chunk frames owed
                    kv_joiners.pop(sid, None)
                    self.kv_imports += 1
                    out += wire.encode_json_frame(wire.T_CTRLR, sid, {
                        "kv_import": {"adopted_blocks": 0,
                                      "resident_blocks": 0,
                                      "matched_tokens": 0,
                                      "bytes": len(whole),
                                      "echo": True}})
                elif ftype == wire.T_CANCEL:
                    pass
                else:
                    out += wire.encode_json_frame(
                        wire.T_ERR, sid,
                        {"error": f"unexpected frame type {ftype}",
                         "code": "bad_request"})
            if out:
                writer.write(bytes(out))
                await writer.drain()


class EchoReplica(ReplicaHandle):
    """ReplicaHandle over an :class:`EchoServer` — slots into the
    supervisor/router exactly like a real replica (healthz readiness,
    kill semantics), for front-door benchmarks and protocol tests."""

    def __init__(self, host: str = "127.0.0.1", *, echo_tokens: int = 1,
                 wire_mode: str = "auto", kv_fail: bool = False,
                 kv_block_tokens: int = 16):
        self.server = EchoServer(host, 0, echo_tokens=echo_tokens,
                                 wire_mode=wire_mode, kv_fail=kv_fail,
                                 kv_block_tokens=kv_block_tokens)
        self._killed = False

    async def start(self) -> tuple[str, int]:
        await self.server.start()
        return self.server.host, self.server.port

    @property
    def alive(self) -> bool:
        return not self._killed and self.server._server is not None

    async def kill(self) -> None:
        self._killed = True
        await self.server.stop()

    async def terminate(self) -> None:
        await self.kill()


class ProcessReplica(ReplicaHandle):
    """Child-process replica: ``python -m distkeras_tpu_torch.run serve --port 0
    <extra_args>``. The serve banner (first stdout line, JSON with the
    bound port) is the readiness handshake; stderr is inherited so
    replica logs land in the supervisor's stream."""

    def __init__(self, extra_args: list[str], host: str = "127.0.0.1",
                 start_timeout_s: float = 120.0,
                 env: dict[str, str] | None = None,
                 last_words_path: str | None = None):
        self.extra_args = list(extra_args)
        self.host = host
        self.start_timeout_s = float(start_timeout_s)
        # Where this child's `serve --flight-dump` writes on crash; the
        # supervisor reads it into the restart log. A SIGKILL'd child
        # cannot write one — the supervisor records that, too.
        self.last_words_path = last_words_path
        # Extra environment merged over the parent's — the device-
        # partitioning hook: N replicas on one accelerator host must not
        # all claim every chip (e.g. CUDA_VISIBLE_DEVICES / TPU chip
        # pinning per replica index; see run.py --replica-env).
        self.env = dict(env) if env else None
        self.proc: asyncio.subprocess.Process | None = None

    async def start(self) -> tuple[str, int]:
        import os

        child_env = None
        if self.env:
            child_env = {**os.environ, **self.env}
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "distkeras_tpu_torch.run", "serve",
            "--host", self.host, "--port", "0", *self.extra_args,
            stdout=asyncio.subprocess.PIPE, env=child_env)
        try:
            line = await asyncio.wait_for(
                self.proc.stdout.readline(), self.start_timeout_s)
            banner = json.loads(line)
            return banner.get("host", self.host), int(banner["port"])
        except Exception:
            # A replica that dies (or prints garbage) before its banner
            # must not leak a half-started child.
            await self.kill()
            raise

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.returncode is None

    async def kill(self) -> None:
        if self.proc is not None and self.proc.returncode is None:
            try:
                self.proc.kill()  # SIGKILL: the chaos-test crash
            except ProcessLookupError:
                pass
            await self.proc.wait()

    async def terminate(self, grace_s: float = 30.0) -> None:
        if self.proc is None or self.proc.returncode is not None:
            return
        try:
            self.proc.terminate()  # SIGTERM: serve_main drains and exits
        except ProcessLookupError:
            return
        try:
            await asyncio.wait_for(self.proc.wait(), grace_s)
        except asyncio.TimeoutError:
            await self.kill()
