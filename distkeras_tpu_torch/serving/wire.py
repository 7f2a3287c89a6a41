"""bin1: the serving front door's length-prefixed binary wire format.

Copy of the reference's ``distkeras_tpu/serving/wire.py``, which imports no JAX;
only its imports differ.

The original protocol is newline-delimited JSON — one ``readline()`` +
``json.loads`` per message at every hop, which is fine at bench scale and
a wall at production QPS (the per-record serialization
ceiling DeepSpark reports on its exchange path). bin1 replaces lines
with frames:

    [u32 len (LE)] [u8 type] [u32 stream_id (LE)] [payload: len-5 bytes]

``len`` covers everything after itself (type + stream + payload), so a
frame's total wire size is ``len + 4``. ``stream_id`` multiplexes many
in-flight requests over ONE connection — the router runs a single mux
connection per replica instead of an exclusive pooled socket per
request, and clients may pipeline.

Frame types:

- ``T_REQ``   — a generation request, binary-encoded (fixed header +
  int32 prompt + tenant/trace strings; see :func:`encode_request`);
- ``T_TOK``   — a token *delta*: one or MORE decoded token ids for one
  stream. The sender coalesces every token produced in a flush interval
  into one frame per stream and one write per connection
  (:class:`FrameSink`) — instead of one JSON line + syscall per token;
- ``T_DONE`` / ``T_ERR`` — terminal records, JSON payload (once per
  request: not hot, and keeping them JSON means the done line's fields
  — provenance, tenant, latency — stay byte-identical to the JSONL
  protocol's);
- ``T_CTRL`` / ``T_CTRLR`` — control verbs and their replies, JSON
  payload (``metricsz``/``healthz``/... ride the same mux);
- ``T_CANCEL`` — client abandons one stream (a mux peer can't signal
  cancellation by closing the shared connection);
- ``T_KVBLK`` — one serialized KV block chain (the ``KVX1`` payload of
  :mod:`distkeras_tpu_torch.serving.kv_transfer`): sent by a replica
  answering the ``kv_export`` verb, and adopted (the ``kv_import``
  operation) by a replica that receives one. This is how paged KV
  blocks ship replica→replica for disaggregated prefill/decode —
  binary end to end, never JSON through the router's event loop. The
  native ``fw_scan_frames`` receive scan is frame-type-agnostic, so
  KVBLK frames ride the same batched read path as every other type;
- ``T_TELEM`` — a pushed telemetry delta (compact JSON payload from
  :class:`~distkeras_tpu_torch.telemetry.timeseries.DeltaEncoder`): a replica
  that received the ``telemetry_start`` control verb ships its metric
  deltas to the router on a cadence over the SAME mux connection,
  replacing poll-time aggregation on the hot signals. Another
  type-agnostic rider on the native scan; the JSONL fallback is the
  ``telemetryz`` verb, which returns one delta per poll.

**Negotiation** is an upgrade from JSONL, so unknown peers keep today's
protocol byte-for-byte: a bin1-capable client's FIRST line is JSON
``{"cmd": "hello", "proto": ["bin1", "jsonl"]}``. A bin1-capable server
replies ``{"hello": {"proto": "bin1"}}`` and both sides switch to frames
on the same connection; an old server replies its usual
``{"error": ..., "code": "bad_request"}`` for the unknown verb, which
the client treats as "peer speaks JSONL" and downgrades. Old clients
never send a hello and are served exactly as before.

The receive hot loop — splitting a batched read into frames — runs in
native code (``native/fastwire.cpp`` ``fw_scan_frames``) behind ctypes
when ``libfastwire.so`` is built, with a pure-Python ``struct``
fallback that is wire-identical (parity-tested in
``tests/test_wire.py``); small buffers take the struct path even when
the .so is loaded (the ctypes hop costs more there — see the crossover
constants). The SEND side coalesces through :class:`FrameSink`, whose
per-stream raw-byte staging made a native pack unnecessary on the hot
path; ``fw_pack_token_frames`` / :func:`pack_token_frames` remain for
callers that assemble wide int-list batches (and as the pack half of
the parity suite). Same stance as ``data/native.py``: the .so is never
committed, a stale one is rebuilt or ignored, and the fallback is the
steady state on toolchain-less hosts.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import subprocess

import numpy as np

__all__ = [
    "PROTO_BIN1",
    "PROTO_JSONL",
    "SUPPORTED_PROTOS",
    "MAX_FRAME",
    "T_REQ",
    "T_TOK",
    "T_DONE",
    "T_ERR",
    "T_CTRL",
    "T_CTRLR",
    "T_CANCEL",
    "T_KVBLK",
    "T_TELEM",
    "WireError",
    "native_available",
    "hello_line",
    "parse_hello",
    "choose_proto",
    "encode_frame",
    "encode_json_frame",
    "decode_json",
    "encode_request",
    "decode_request",
    "request_flags",
    "encode_token_frame",
    "decode_tokens",
    "pack_token_frames",
    "FrameDecoder",
    "FrameSink",
]

PROTO_BIN1 = "bin1"
PROTO_JSONL = "jsonl"
# Preference order when both sides support both.
SUPPORTED_PROTOS = (PROTO_BIN1, PROTO_JSONL)

# Matches the 16 MB line limit the JSONL protocol already enforces
# (client/router open_connection(limit=2**24)): an aggregate metricsz
# reply fits, a desynchronized or hostile peer does not.
MAX_FRAME = 2 ** 24

T_REQ = 1
T_TOK = 2
T_DONE = 3
T_ERR = 4
T_CTRL = 5
T_CTRLR = 6
T_CANCEL = 7
T_KVBLK = 8  # serialized KV block chain (kv_transfer KVX1 payload)
T_TELEM = 9  # pushed telemetry delta (compact JSON; replica -> router)

# Frame header AFTER the u32 length prefix: type byte + stream id.
_HDR = struct.Struct("<IBI")  # len, type, stream — one pack per frame
_LEN = struct.Struct("<I")

# Native-vs-Python crossover points. The ctypes hop costs ~20-50us per
# call in argument marshalling alone — far more than struct.pack on a
# handful of values — so the native core only wins on BIG buffers (a
# saturated connection's read, a wide coalesced flush). Small inputs
# take the struct fallback even when the .so is loaded; the two paths
# are wire-identical (parity-tested), so the split is invisible.
_SMALL_SCAN_BYTES = 8192
_SMALL_PACK_TOKENS = 256
_SMALL_PROMPT_TOKENS = 64

# T_REQ payload: fixed header, then the int32 prompt, then the tenant
# and trace-id strings (utf-8). Scalars first and the prompt at a fixed
# 28-byte offset so np.frombuffer reads it without a copy.
_REQ = struct.Struct("<IfidBBHI")
# fields: max_new_tokens u32, temperature f32, priority i32, timeout f64
# (NaN = none), flags u8 (bit0 = speculate, bit1 = extras present),
# tenant_len u8, trace_len u16, prompt_len u32.
_F_SPECULATE = 1
# Extras (bit1): a trailing [u32 len][JSON] blob after the trace string,
# for the RARE spec fields the fixed header has no slot for — the
# router's disaggregation hints (``kv_from``: which replica holds the
# prompt's prefilled KV blocks; ``kv_wait``: the blocks are being PUSHED
# here — park on arrival, pulling from the named source only on
# timeout) and migration resumes (``resume_tokens``: tokens the client
# already received on a previous replica, folded into the resume
# prefill). Absent on every ordinary request, so the hot-path frame
# stays byte-identical to pre-extras senders; a pre-extras DECODER
# rejects an extras frame typed (length-mismatch WireError) — extras
# are only ever produced inside a roles-enabled fleet, whose replicas
# all speak them.
_F_EXTRAS = 2
# Whitelist of spec keys that ride the extras blob. Keys NOT listed here
# are silently dropped by encode_request — every new
# request field MUST be added here or a bin1 hop loses it. The request-
# kinds fields are truthiness-safe by construction: clients set ``kind``
# only when != "generate", ``n`` only when > 1, ``constraint`` only when
# present, so ordinary generate frames stay byte-identical.
_EXTRA_KEYS = ("kv_from", "kv_wait", "resume_tokens",
               "kind", "n", "constraint")


class WireError(ValueError):
    """Corrupt, oversized, or truncated bin1 input. The receiving side
    maps it to a typed ``bad_request`` — framing cannot be resynchronized
    after corruption, so the connection is then closed (never a hung
    read waiting for bytes that will not parse)."""


# -- native core (ctypes), pure-Python fallback -----------------------------
_LIB = None
_LOAD_TRIED = False


def _native_dir() -> str:
    here = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native")


def _ensure_built(native_dir: str) -> str | None:
    """Build (or rebuild) libfastwire.so when the checkout has sources —
    the ``data/native.py`` contract: a stale .so is never loaded, a
    missing toolchain means the Python fallback, silently."""
    src = os.path.join(native_dir, "fastwire.cpp")
    so = os.path.join(native_dir, "libfastwire.so")
    if not os.path.exists(src):
        return so if os.path.exists(so) else None
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    try:
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    return so if os.path.exists(so) else None


def _load():
    global _LIB, _LOAD_TRIED
    if _LIB is not None or _LOAD_TRIED:
        return _LIB
    _LOAD_TRIED = True
    path = _ensure_built(_native_dir())
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.fw_scan_frames.restype = ctypes.c_int64
    lib.fw_scan_frames.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, u8p, u32p,
        ctypes.c_int64, i64p,
    ]
    lib.fw_pack_token_frames.restype = ctypes.c_int64
    lib.fw_pack_token_frames.argtypes = [
        u32p, i64p, i32p, ctypes.c_int64, ctypes.c_uint8, u8p,
    ]
    _LIB = lib
    return lib


def native_available() -> bool:
    """True when the ctypes core is loaded (libfastwire.so built)."""
    return _load() is not None


# -- negotiation ------------------------------------------------------------
def hello_line(protos=SUPPORTED_PROTOS) -> bytes:
    """The upgrade offer: a plain JSONL control line, so a peer that has
    never heard of bin1 answers its normal unknown-verb bad_request and
    nothing breaks."""
    return (json.dumps({"cmd": "hello", "proto": list(protos)})
            + "\n").encode()


def parse_hello(rec: dict) -> str:
    """The protocol a hello REPLY selected. A typed-error reply (an old
    peer rejecting the unknown verb) — or anything else unexpected —
    means JSONL: downgrade, never fail the connection."""
    if isinstance(rec, dict):
        chosen = (rec.get("hello") or {}).get("proto")
        if chosen in SUPPORTED_PROTOS:
            return chosen
    return PROTO_JSONL


def choose_proto(offered) -> str:
    """Server-side pick from a hello's offer, in OUR preference order
    (bin1 first). An offer with nothing we speak gets JSONL — the
    protocol the peer is already speaking to us."""
    if isinstance(offered, (list, tuple)):
        for p in SUPPORTED_PROTOS:
            if p in offered:
                return p
    return PROTO_JSONL


# -- frame codecs -----------------------------------------------------------
def encode_frame(ftype: int, stream_id: int, payload: bytes) -> bytes:
    return _HDR.pack(5 + len(payload), ftype, stream_id) + payload


def encode_json_frame(ftype: int, stream_id: int, obj: dict) -> bytes:
    return encode_frame(ftype, stream_id, json.dumps(obj).encode())


def decode_json(payload) -> dict:
    try:
        rec = json.loads(bytes(payload))
    except ValueError as e:
        raise WireError(f"bad JSON frame payload: {e}") from None
    if not isinstance(rec, dict):
        raise WireError("JSON frame payload must be an object")
    return rec


def _encode_prompt(prompt) -> tuple[bytes, int]:
    """Prompt ids to little-endian int32 bytes: struct for short
    prompts (the hot path — ctypes/numpy setup costs more than the
    pack), numpy for long ones."""
    if isinstance(prompt, np.ndarray):
        if prompt.ndim != 1:
            raise WireError(
                f"prompt must be 1-D, got shape {prompt.shape}")
        return prompt.astype("<i4", copy=False).tobytes(), prompt.size
    n = len(prompt)
    if n <= _SMALL_PROMPT_TOKENS:
        try:
            return struct.pack(f"<{n}i", *prompt), n
        except struct.error as e:
            raise WireError(f"bad prompt token: {e}") from None
    arr = np.asarray(prompt, dtype="<i4")
    if arr.ndim != 1:
        raise WireError(f"prompt must be 1-D, got shape {arr.shape}")
    return arr.tobytes(), arr.size


def encode_request(spec: dict) -> bytes:
    """T_REQ payload from a request spec (the same dict shape the JSONL
    protocol sends as a line), so the server's submit path is protocol-
    agnostic. ``timeout=None`` rides as NaN; tenant and trace_id as
    short utf-8 strings."""
    try:
        prompt_bytes, prompt_len = _encode_prompt(spec.get("prompt") or [])
    except (TypeError, ValueError) as e:
        raise WireError(f"bad prompt: {e}") from None
    tenant = str(spec.get("tenant") or "").encode()
    trace = str(spec.get("trace_id") or "").encode()
    if len(tenant) > 255:
        raise WireError(f"tenant id too long ({len(tenant)} bytes > 255)")
    if len(trace) > 65535:
        raise WireError("trace_id too long")
    timeout = spec.get("timeout")
    flags = _F_SPECULATE if spec.get("speculate", True) else 0
    extras = {k: spec[k] for k in _EXTRA_KEYS if spec.get(k)}
    extra_bytes = b""
    if extras:
        flags |= _F_EXTRAS
        try:
            blob = json.dumps(extras).encode()
        except (TypeError, ValueError) as e:
            raise WireError(f"bad request extras: {e}") from None
        extra_bytes = _LEN.pack(len(blob)) + blob
    try:
        head = _REQ.pack(
            int(spec.get("max_new_tokens", 0)),
            float(spec.get("temperature", 0.0)),
            int(spec.get("priority", 0)),
            float("nan") if timeout is None else float(timeout),
            flags, len(tenant), len(trace), prompt_len)
    except (struct.error, TypeError, ValueError) as e:
        # A JSONL client's junk scalar relayed onto a bin1 backend must
        # become the same typed bad_request the replica would answer —
        # an untyped struct.error here would kill the router's whole
        # client connection instead of failing one stream.
        raise WireError(f"bad request field: {e}") from None
    return head + prompt_bytes + tenant + trace + extra_bytes


def decode_request(payload) -> dict:
    """Inverse of :func:`encode_request`; returns the spec dict. Length
    fields are validated against the payload size — a truncated or
    corrupt request is a :class:`WireError` (mapped to ``bad_request``),
    never an out-of-bounds numpy read."""
    buf = bytes(payload)
    if len(buf) < _REQ.size:
        raise WireError(f"request frame too short ({len(buf)} bytes)")
    (max_new, temp, prio, timeout, flags, tenant_len, trace_len,
     prompt_len) = _REQ.unpack_from(buf)
    need = _REQ.size + 4 * prompt_len + tenant_len + trace_len
    extras = None
    if flags & _F_EXTRAS:
        if len(buf) < need + 4:
            raise WireError("request frame declares extras but has no "
                            "extras length")
        (elen,) = _LEN.unpack_from(buf, need)
        if len(buf) != need + 4 + elen:
            raise WireError(
                f"request frame length mismatch: payload {len(buf)} "
                f"bytes, header declares {need + 4 + elen}")
        try:
            extras = json.loads(buf[need + 4:need + 4 + elen])
        except ValueError as e:
            raise WireError(f"bad request extras JSON: {e}") from None
        if not isinstance(extras, dict):
            raise WireError("request extras must be a JSON object")
    elif len(buf) != need:
        raise WireError(
            f"request frame length mismatch: payload {len(buf)} bytes, "
            f"header declares {need}")
    if prompt_len <= _SMALL_PROMPT_TOKENS:
        prompt = list(struct.unpack_from(f"<{prompt_len}i", buf,
                                         _REQ.size))
    else:
        prompt = np.frombuffer(buf, dtype="<i4", count=prompt_len,
                               offset=_REQ.size).tolist()
    pos = _REQ.size + 4 * prompt_len
    tenant = buf[pos:pos + tenant_len].decode("utf-8", "replace")
    trace = buf[pos + tenant_len:pos + tenant_len + trace_len].decode(
        "utf-8", "replace")
    spec = {
        "prompt": prompt,
        "max_new_tokens": int(max_new),
        "temperature": float(temp),
        "priority": int(prio),
        "timeout": None if timeout != timeout else float(timeout),
        "speculate": bool(flags & _F_SPECULATE),
    }
    if tenant:
        spec["tenant"] = tenant
    if trace:
        spec["trace_id"] = trace
    if extras:
        for k in _EXTRA_KEYS:
            if extras.get(k):
                spec[k] = extras[k]
    return spec


def affinity_prefix(payload, k: int) -> bytes:
    """The raw bytes of the first ``min(k, prompt_len)`` prompt ids of
    a T_REQ payload, WITHOUT building the full spec — the router's
    prefix-cache affinity hash input on its zero-copy fast path.
    Clamped to the PROMPT: a short prompt must never leak the tenant/
    trace bytes that follow it into the hash (a per-request trace id
    there would scatter every short prompt's family across the fleet).
    Returns ``b""`` on a malformed payload (the forwarding replica will
    reject it typed)."""
    buf = bytes(payload)
    if len(buf) < _REQ.size:
        return b""
    (prompt_len,) = struct.unpack_from("<I", buf, _REQ.size - 4)
    n = min(int(prompt_len), k)
    return buf[_REQ.size:_REQ.size + 4 * n]


def request_flags(payload) -> int:
    """The flags byte of a T_REQ payload without decoding the spec —
    the router's fast path peeks this to detect extras-bearing requests
    (request kinds, disaggregation hints) that need the full kind-aware
    dispatch instead of the zero-copy forward. Returns 0 on a malformed
    payload (the forwarding replica will reject it typed)."""
    buf = bytes(payload)
    if len(buf) < _REQ.size:
        return 0
    # flags u8 sits after max_new u32 + temperature f32 + priority i32
    # + timeout f64 in the packed (unaligned) header.
    return buf[20]


def encode_token_frame(stream_id: int, tokens) -> bytes:
    n = len(tokens)
    if n <= _SMALL_PACK_TOKENS and not isinstance(tokens, np.ndarray):
        return (_HDR.pack(5 + 4 * n, T_TOK, stream_id)
                + struct.pack(f"<{n}i", *tokens))
    return encode_frame(T_TOK, stream_id,
                        np.asarray(tokens, dtype="<i4").tobytes())


def decode_tokens(payload) -> list[int]:
    buf = bytes(payload)
    if len(buf) % 4:
        raise WireError(f"token frame payload not int32-aligned "
                        f"({len(buf)} bytes)")
    n = len(buf) // 4
    if n <= _SMALL_PACK_TOKENS:
        return list(struct.unpack(f"<{n}i", buf))
    return np.frombuffer(buf, dtype="<i4").tolist()


def pack_token_frames(updates) -> bytes:
    """One contiguous buffer of T_TOK frames from ``(stream_id,
    tokens)`` pairs. A WIDE batch packs natively in one FFI call; small
    batches take the struct path, which beats the ctypes marshalling
    cost there. Wire-identical either way. NOTE: the production send
    path (:class:`FrameSink`) stages raw payload bytes per stream and
    frames them directly — this helper serves int-list batch writers
    (EchoServer-style) and the native parity tests."""
    lib = _load()
    if lib is None or not updates or (
            sum(len(t) for _, t in updates) <= _SMALL_PACK_TOKENS):
        return b"".join(encode_token_frame(sid, toks)
                        for sid, toks in updates)
    streams = np.empty(len(updates), np.uint32)
    offs = np.zeros(len(updates) + 1, np.int64)
    chunks = []
    for i, (sid, toks) in enumerate(updates):
        arr = np.asarray(toks, dtype="<i4")
        streams[i] = sid
        offs[i + 1] = offs[i] + arr.size
        chunks.append(arr)
    tokens = (np.concatenate(chunks) if len(chunks) > 1 else chunks[0])
    tokens = np.ascontiguousarray(tokens, dtype="<i4")
    out = np.empty(9 * len(updates) + 4 * int(offs[-1]), np.uint8)
    n = lib.fw_pack_token_frames(
        streams.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(updates), T_TOK,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:n].tobytes()


class FrameDecoder:
    """Incremental frame splitter: ``feed(data)`` returns every COMPLETE
    frame as ``(type, stream_id, payload_bytes)`` and keeps the partial
    tail buffered for the next read — the receive half of batched
    admission (all frames that arrived in one event-loop tick come back
    from one call). Raises :class:`WireError` on a corrupt or oversized
    length prefix; the connection is then unrecoverable by contract."""

    _SCAN_CAP = 256  # frames per native scan call; looped until drained

    def __init__(self, max_frame: int = MAX_FRAME):
        self.max_frame = int(max_frame)
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[tuple[int, int, bytes]]:
        self._buf += data
        lib = _load()
        # Small receive buffers scan faster in pure Python (the ctypes
        # hop costs more than a few struct.unpack_from calls); the
        # native scan takes over once reads are actually batched.
        frames = (self._scan_native(lib)
                  if lib is not None and len(self._buf) > _SMALL_SCAN_BYTES
                  else self._scan_py())
        if not frames and len(self._buf) > self.max_frame + 4:
            # Belt and braces: a partial "frame" larger than any legal
            # one means the length prefix lied (scan already rejects
            # declared-oversize; this catches a peer that never sends
            # the rest).
            raise WireError(
                f"partial frame exceeds max_frame={self.max_frame}")
        return frames

    def _scan_native(self, lib) -> list[tuple[int, int, bytes]]:
        out: list[tuple[int, int, bytes]] = []
        cap = self._SCAN_CAP
        offsets = np.empty(cap, np.int64)
        lengths = np.empty(cap, np.int64)
        types = np.empty(cap, np.uint8)
        streams = np.empty(cap, np.uint32)
        consumed = ctypes.c_int64(0)
        while True:
            buf = (ctypes.c_uint8 * len(self._buf)).from_buffer(self._buf)
            n = lib.fw_scan_frames(
                buf, len(self._buf), self.max_frame,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                types.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                streams.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                cap, ctypes.byref(consumed))
            if n < 0:
                raise WireError("corrupt frame header (declared length "
                                "below minimum or above max_frame)")
            for i in range(n):
                off, ln = int(offsets[i]), int(lengths[i])
                out.append((int(types[i]), int(streams[i]),
                            bytes(self._buf[off:off + ln])))
            # from_buffer holds an exclusive view; drop it before
            # resizing the bytearray.
            del buf
            if consumed.value:
                del self._buf[:consumed.value]
            if n < cap:
                return out

    def _scan_py(self) -> list[tuple[int, int, bytes]]:
        out: list[tuple[int, int, bytes]] = []
        pos = 0
        buf = self._buf
        while pos + 4 <= len(buf):
            (flen,) = _LEN.unpack_from(buf, pos)
            if flen < 5 or flen > self.max_frame:
                raise WireError("corrupt frame header (declared length "
                                "below minimum or above max_frame)")
            if pos + 4 + flen > len(buf):
                break
            ftype = buf[pos + 4]
            (sid,) = _LEN.unpack_from(buf, pos + 5)
            out.append((ftype, sid, bytes(buf[pos + 9:pos + 4 + flen])))
            pos += 4 + flen
        if pos:
            del self._buf[:pos]
        return out


class FrameSink:
    """The coalescing send half, shared by the server and the router.

    Everything a connection emits in one flush interval — token deltas
    for ANY number of streams, terminal records, control replies —
    lands in ONE ``writer.write``. ``flush_s=0`` means "the current
    event-loop tick" (a ``call_soon``-scheduled flush: no added
    latency, but a whole decode tick's output across all of this
    connection's streams is still one write). Token deltas stage as raw
    little-endian payload bytes per stream (so a relaying router
    forwards them without decode or re-encode); a terminal frame moves
    its stream's staged tokens into the output buffer first — ordering
    within a stream holds by construction, and cross-stream order is
    meaningless on a mux.

    Writes go through ``StreamWriter.write`` (buffered, non-blocking);
    a background drain task applies transport backpressure to the
    TRANSPORT, and ``max_buffer`` bounds the sink against a peer that
    stops reading entirely: senders are synchronous (they cannot await
    a slow client), so once the transport's write buffer exceeds the
    cap the connection is declared dead and closed — exactly the
    walked-away-client treatment, instead of the unbounded buffer
    growth the per-send ``await drain()`` of the JSONL path prevented.
    A dead peer surfaces as :attr:`closed` — senders simply stop, and
    the owning handler (which sees EOF on its read side) cancels the
    requests.
    """

    def __init__(self, writer, flush_s: float = 0.0,
                 max_buffer: int = 32 * 2 ** 20):
        import asyncio

        self._writer = writer
        self.flush_s = float(flush_s)
        self.max_buffer = int(max_buffer)
        self._stage: dict[int, bytearray] = {}  # sid -> raw token bytes
        self._out = bytearray()
        self._scheduled = False
        self.closed = False
        self._kick = asyncio.Event()
        self._drainer = asyncio.get_running_loop().create_task(
            self._drain_loop())

    # -- senders (sync: callable from token pumps without awaiting) ---------
    def _staged(self, stream_id: int) -> bytearray:
        buf = self._stage.get(stream_id)
        if buf is None:
            buf = self._stage[stream_id] = bytearray()
        return buf

    def add_tokens(self, stream_id: int, tokens) -> None:
        if self.closed:
            return
        self._staged(stream_id).extend(
            struct.pack(f"<{len(tokens)}i", *tokens))
        self._schedule_flush()

    def add_token(self, stream_id: int, token: int) -> None:
        if self.closed:
            return
        self._staged(stream_id).extend(struct.pack("<i", token))
        self._schedule_flush()

    def forward_tokens(self, stream_id: int, payload: bytes) -> None:
        """Relay a received T_TOK payload verbatim (already wire-format
        int32s) — the router's zero-copy token path."""
        if self.closed:
            return
        self._staged(stream_id).extend(payload)
        self._schedule_flush()

    def send_json(self, ftype: int, stream_id: int, obj: dict) -> None:
        """Terminal/control frame: flushes this stream's staged tokens
        into the output first so the peer never sees DONE before the
        last delta."""
        self.send_raw(ftype, stream_id, None, obj)

    def send_raw(self, ftype: int, stream_id: int,
                 payload: bytes | None, obj: dict | None = None) -> None:
        """Forward an already-encoded JSON payload (a relayed DONE/ERR
        frame: the router re-frames without re-encoding), or encode
        ``obj`` when ``payload`` is None."""
        if self.closed:
            return
        out = self._out
        staged = self._stage.pop(stream_id, None)
        if staged:
            out += _HDR.pack(5 + len(staged), T_TOK, stream_id)
            out += staged
        if payload is None:
            payload = json.dumps(obj or {}).encode()
        out += _HDR.pack(5 + len(payload), ftype, stream_id)
        out += payload
        self._schedule_flush()

    def send_done(self, stream_id: int, rec: dict) -> None:
        self.send_json(T_DONE, stream_id, rec)

    def send_error(self, stream_id: int, rec: dict) -> None:
        self.send_json(T_ERR, stream_id, rec)

    # -- flush machinery ----------------------------------------------------
    def _schedule_flush(self) -> None:
        if self._scheduled or self.closed:
            return
        import asyncio

        self._scheduled = True
        loop = asyncio.get_running_loop()
        if self.flush_s > 0:
            loop.call_later(self.flush_s, self._flush)
        else:
            loop.call_soon(self._flush)

    def _flush(self) -> None:
        self._scheduled = False
        if self.closed:
            return
        out = self._out
        if self._stage:
            for sid, staged in self._stage.items():
                if staged:
                    out += _HDR.pack(5 + len(staged), T_TOK, sid)
                    out += staged
            self._stage.clear()
        if not out:
            return
        data = bytes(out)
        out.clear()
        try:
            transport = self._writer.transport
            if transport is not None and (
                    transport.get_write_buffer_size() + len(data)
                    > self.max_buffer):
                # The peer stopped reading: closing is the bounded
                # failure (its handler cancels the requests) — growing
                # the buffer toward OOM is not.
                self.closed = True
                self._writer.close()
                return
            self._writer.write(data)
        except (ConnectionResetError, BrokenPipeError, OSError,
                RuntimeError):
            self.closed = True
            return
        self._kick.set()

    async def _drain_loop(self) -> None:
        """Transport backpressure: await drain() after writes, off the
        token pumps' critical path (they stay synchronous)."""
        import asyncio

        try:
            while not self.closed:
                await self._kick.wait()
                self._kick.clear()
                await self._writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError,
                asyncio.CancelledError, RuntimeError):
            self.closed = True

    async def aclose(self) -> None:
        """Final flush + stop the drain task (the owning handler closes
        the writer itself)."""
        import asyncio

        self._flush()
        if not self.closed:
            try:
                await self._writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass
        self.closed = True
        self._kick.set()
        self._drainer.cancel()
        try:
            await self._drainer
        except (asyncio.CancelledError, Exception):
            pass
