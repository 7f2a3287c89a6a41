"""KV block migration: move a prompt's paged KV blocks between replicas.

The paged engine's :class:`~distkeras_tpu_torch.serving.prefix_cache.
KVBlockPool` keeps exact per-block bookkeeping — which pool rows hold
which token blocks' K/V — which makes a slot's (or a cached prefix's)
KV **serializable**: gather the rows, stamp them with the block
geometry, the exact token chain they cover, and the weight provenance
they were computed under, and any other replica holding the SAME
weights can adopt them into its own pool and skip the prefill compute
entirely. That one primitive is what disaggregated prefill/decode
serving, cross-replica prefix-cache sharing, and live slot migration
off a draining replica are all built from (docs/serving.md
"Disaggregated serving").

Wire format (``KVX1``), designed for bitwise round trips:

    [4s magic "KVX1"] [u32 header_len] [header JSON] [leaf 0 bytes]
    [leaf 1 bytes] ...

The header carries ``block_tokens``, the exact token list the blocks
cover (``n_blocks * block_tokens`` tokens — adoption is keyed by token
content, so a corrupt or mismatched chain can never alias a different
prompt), the sender's weight provenance stamp (version + digest; KV is
a pure function of (weights, tokens), so the receiver REJECTS a stamp
that differs from its own — typed, before any device work), and each
KV leaf's per-block shape + dtype (the compatibility check between
pools). Leaf bytes are raw C-order ``[n_blocks, block_tokens, H, D]``
arrays in the reference's ``jax.tree.leaves`` order (the pools' dict
keys sorted as strings: ``layer_0, layer_1, layer_10, ..., layer_2``)
— the same prompt serialized twice
from the same pool is byte-identical, and a same-geometry receiver
re-uploads them bit-for-bit. A tensor-parallel receiver re-shards the
heads dimension through the engine's existing ``kv_pytree_shardings``
placement seam: the payload always carries FULL heads (the exporter
gathers across its mesh), so any mesh whose tp divides the head count
adopts compatibly; geometry that differs in shape/dtype/block size is
a typed :class:`KVTransferError` reject.

Blocks ship replica→replica as ONE bin1 ``KVBLK`` frame
(:data:`~distkeras_tpu_torch.serving.wire.T_KVBLK`) — binary end to end,
never JSON through the router's event loop. :func:`fetch_blocks` is
the pull client: connect to the peer, negotiate bin1, send the
``kv_export`` verb, read back the KVBLK frame (or the typed miss /
error reply). It imports no torch at module level: the router-level
handoff and fallback logic is exercised against :class:`~distkeras_tpu_torch.serving.
cluster.replicas.EchoServer` fleets, which only read headers.

Copy of the reference's ``distkeras_tpu/serving/kv_transfer.py``. The
reference reads and writes leaves as numpy arrays and resolves
``bfloat16`` through ``ml_dtypes``, which the port does not use: here a leaf
is a torch tensor (or a numpy array of a numpy dtype), a ``bfloat16`` leaf's
bytes are its 16-bit patterns, and :func:`deserialize_blocks` returns CPU
tensors. The header keeps the reference's dtype names, so a payload written
by either package reads in the other, byte for byte.
"""

from __future__ import annotations

import asyncio
import json
import struct

import numpy as np

__all__ = [
    "KVTransferError",
    "MAX_TRANSFER_BYTES",
    "MAX_TOTAL_TRANSFER_BYTES",
    "serialize_blocks",
    "deserialize_blocks",
    "peek_header",
    "fetch_blocks",
    "push_blocks",
    "split_frames",
    "is_chunk_frame",
    "FrameJoiner",
    "PeerConnectionPool",
    "peer_pool",
]

_MAGIC = b"KVX1"
_LEN = struct.Struct("<I")

# One KVBLK frame payload must fit one bin1 frame (wire.MAX_FRAME,
# minus header slack). A serialized chain larger than this is SPLIT
# across sequenced KVBLK frames (see split_frames / FrameJoiner) — the
# typed refusal applies only past the TOTAL cap below, where a
# transfer stops being cheaper than just re-prefilling.
MAX_TRANSFER_BYTES = 2 ** 24 - 64

# Hard ceiling on one reassembled chain. Past this the export is a
# typed reject and the receiver falls back to monolithic prefill — the
# bounded outcome, and a guard against a lying peer streaming
# unbounded chunk frames at a receiver.
MAX_TOTAL_TRANSFER_BYTES = 2 ** 28

# Chunk envelope for multi-frame chains: each KVBLK frame carries
# either a bare KVX1 payload (single-frame export — byte-identical to
# the pre-chunking wire, so old receivers keep working) or one
# [4s "KVXC"][u32 seq][u32 total][u8 last] envelope followed by that
# chunk's bytes. ``last`` is the terminal marker; ``total`` lets the
# receiver reject a disagreeing sequence before buffering it all.
_CHUNK_MAGIC = b"KVXC"
_CHUNK_HDR = struct.Struct("<IIB")


class KVTransferError(ValueError):
    """A KV block transfer that cannot (or must not) be applied:
    corrupt payload, incompatible pool geometry, weight-provenance
    mismatch, or an export too large for one frame. Always mapped to a
    typed reply and a MONOLITHIC fallback — never a client-visible
    failure."""

    code = "kv_transfer"


def _torch_dtype(name: str):
    """The torch dtype of a KVX1 dtype name (``float32``, ``bfloat16``,
    ...); an unknown name is a typed reject."""
    import torch

    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise KVTransferError(f"unknown KVX1 leaf dtype {name!r}")
    return dt


def _leaf_bytes(a) -> tuple[list, str, bytes]:
    """``(shape, dtype name, raw C-order bytes)`` of one leaf: a torch
    tensor (any device; a ``bfloat16`` tensor's bytes are its 16-bit
    patterns) or a numpy array."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        return list(a.shape), a.dtype.name, a.tobytes()
    import torch

    t = a.detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return list(t.shape), name, t.numpy().tobytes()


def serialize_blocks(tokens, leaves, *, block_tokens: int,
                     provenance: dict | None = None) -> bytes:
    """Pack ``leaves`` — one ``[n_blocks, block_tokens, ...]`` tensor
    (or numpy array) per KV leaf, in the reference's leaf order — covering
    ``tokens`` (exactly ``n_blocks * block_tokens`` of them) into one KVX1
    payload. ``provenance`` is the sender's weight stamp
    (``{"version", "digest"}``)."""
    tokens = [int(t) for t in tokens]
    arrays = [_leaf_bytes(a) for a in leaves]
    n_blocks = arrays[0][0][0] if arrays else len(tokens) // block_tokens
    if len(tokens) != n_blocks * int(block_tokens):
        raise KVTransferError(
            f"token count {len(tokens)} does not cover {n_blocks} "
            f"blocks of {block_tokens} tokens")
    for shape, _, _ in arrays:
        if len(shape) < 2 or shape[0] != n_blocks \
                or shape[1] != int(block_tokens):
            raise KVTransferError(
                f"leaf shape {tuple(shape)} is not [{n_blocks}, "
                f"{block_tokens}, ...]")
    header = {
        "block_tokens": int(block_tokens),
        "n_blocks": int(n_blocks),
        "tokens": tokens,
        "provenance": {
            "version": int((provenance or {}).get("version") or 0),
            "digest": (provenance or {}).get("digest"),
        },
        "leaves": [{"shape": shape, "dtype": name}
                   for shape, name, _ in arrays],
    }
    hdr = json.dumps(header, separators=(",", ":")).encode()
    out = bytearray(_MAGIC)
    out += _LEN.pack(len(hdr))
    out += hdr
    for _, _, data in arrays:
        out += data
    return bytes(out)


def peek_header(payload) -> dict:
    """The KVX1 header alone (stdlib only — no array decode): what a
    receiver validates BEFORE touching bytes, and what the torch-free
    Echo emulation answers from."""
    buf = bytes(payload)
    if len(buf) < 8 or buf[:4] != _MAGIC:
        raise KVTransferError("not a KVX1 payload (bad magic)")
    (hlen,) = _LEN.unpack_from(buf, 4)
    if len(buf) < 8 + hlen:
        raise KVTransferError("truncated KVX1 header")
    try:
        header = json.loads(buf[8:8 + hlen])
    except ValueError as e:
        raise KVTransferError(f"bad KVX1 header JSON: {e}") from None
    if not isinstance(header, dict) or "block_tokens" not in header:
        raise KVTransferError("malformed KVX1 header")
    return header


def deserialize_blocks(payload) -> tuple[dict, list]:
    """Inverse of :func:`serialize_blocks`: ``(header, leaves)``, the
    leaves as CPU tensors over one writable copy of the payload. Every
    length is validated against the header before a single
    ``torch.frombuffer`` — a truncated or lying payload is a typed
    :class:`KVTransferError`, never an out-of-bounds read."""
    import torch

    buf = bytearray(payload)
    header = peek_header(buf)
    (hlen,) = _LEN.unpack_from(buf, 4)
    pos = 8 + hlen
    leaves: list = []
    for meta in header.get("leaves", []):
        shape = tuple(int(s) for s in meta["shape"])
        dt = _torch_dtype(str(meta["dtype"]))
        count = int(np.prod(shape))
        nbytes = count * torch.empty((), dtype=dt).element_size()
        if pos + nbytes > len(buf):
            raise KVTransferError(
                f"truncated KVX1 leaf: header declares {nbytes} bytes, "
                f"{len(buf) - pos} remain")
        if count:
            leaf = torch.frombuffer(buf, dtype=dt, count=count, offset=pos)
        else:
            leaf = torch.empty((0,), dtype=dt)
        leaves.append(leaf.reshape(shape))
        pos += nbytes
    if pos != len(buf):
        raise KVTransferError(
            f"KVX1 payload has {len(buf) - pos} trailing bytes")
    return header, leaves


def split_frames(payload, *,
                 max_frame_bytes: int | None = None) -> list[bytes]:
    """One KVX1 payload into 1+ KVBLK frame payloads. A payload that
    fits one frame is returned UNWRAPPED — byte-identical to the
    pre-chunking wire, so a receiver that predates chunking keeps
    working on every export that used to succeed. A larger payload is
    split into sequenced ``KVXC`` chunks with a terminal marker; one
    past :data:`MAX_TOTAL_TRANSFER_BYTES` is a typed refusal."""
    payload = bytes(payload)
    if max_frame_bytes is None:
        # Resolved at call time so tests (and operators) can lower the
        # module-level bound and see every layer re-chunk accordingly.
        max_frame_bytes = MAX_TRANSFER_BYTES
    if len(payload) > MAX_TOTAL_TRANSFER_BYTES:
        raise KVTransferError(
            f"serialized blocks ({len(payload)} bytes) exceed the "
            f"transfer cap ({MAX_TOTAL_TRANSFER_BYTES})")
    if len(payload) <= max_frame_bytes:
        return [payload]
    room = max_frame_bytes - len(_CHUNK_MAGIC) - _CHUNK_HDR.size
    if room < 1:
        raise KVTransferError(
            f"max_frame_bytes={max_frame_bytes} leaves no room for a "
            f"chunk envelope")
    chunks = [payload[i:i + room] for i in range(0, len(payload), room)]
    total = len(chunks)
    return [
        _CHUNK_MAGIC
        + _CHUNK_HDR.pack(seq, total, 1 if seq == total - 1 else 0)
        + c
        for seq, c in enumerate(chunks)
    ]


def is_chunk_frame(payload) -> bool:
    """True when a KVBLK frame payload is one KVXC chunk of a
    multi-frame chain (vs a complete bare KVX1 payload)."""
    return bytes(payload[:4]) == _CHUNK_MAGIC


class FrameJoiner:
    """Reassemble sequenced ``KVXC`` chunk frames into the original
    KVX1 payload. :meth:`feed` returns the complete payload when the
    terminal chunk lands, ``None`` while more are owed; out-of-order,
    duplicated, disagreeing-total, or over-cap sequences are typed
    :class:`KVTransferError` rejects (the receiver falls back to
    monolithic prefill — never an unbounded buffer)."""

    def __init__(self, max_total_bytes: int = MAX_TOTAL_TRANSFER_BYTES):
        self._max_total = int(max_total_bytes)
        self._parts: list[bytes] = []
        self._total: int | None = None
        self._size = 0

    @property
    def pending(self) -> int:
        """Chunks buffered so far (0 = idle)."""
        return len(self._parts)

    def feed(self, payload) -> bytes | None:
        buf = bytes(payload)
        if not is_chunk_frame(buf):
            if self._parts:
                raise KVTransferError(
                    "bare KVX1 payload arrived mid chunk sequence")
            return buf
        if len(buf) < len(_CHUNK_MAGIC) + _CHUNK_HDR.size:
            raise KVTransferError("truncated KVXC chunk envelope")
        seq, total, last = _CHUNK_HDR.unpack_from(buf, len(_CHUNK_MAGIC))
        data = buf[len(_CHUNK_MAGIC) + _CHUNK_HDR.size:]
        if total < 1 or seq >= total:
            raise KVTransferError(
                f"bad KVXC sequence: chunk {seq} of {total}")
        if self._total is None:
            self._total = total
        elif total != self._total:
            raise KVTransferError(
                f"KVXC chunk total changed mid sequence "
                f"({self._total} -> {total})")
        if seq != len(self._parts):
            raise KVTransferError(
                f"KVXC chunk out of order: got seq {seq}, expected "
                f"{len(self._parts)}")
        if bool(last) != (seq == total - 1):
            raise KVTransferError(
                f"KVXC terminal marker disagrees with sequence "
                f"(seq {seq}/{total}, last={bool(last)})")
        self._size += len(data)
        if self._size > self._max_total:
            raise KVTransferError(
                f"reassembled KVBLK chain exceeds the transfer cap "
                f"({self._max_total} bytes)")
        self._parts.append(data)
        if seq == total - 1:
            out = b"".join(self._parts)
            self._parts = []
            self._total = None
            self._size = 0
            return out
        return None


class PeerConnectionPool:
    """Idle bin1 connections to peer replicas, keyed ``(host, port)``
    — the decode-side twin of the router's generation-keyed backend
    pools: a hot prefill peer serves many handoffs, and re-dialing +
    re-negotiating the hello per migration pays an avoidable RTT every
    time. No replica generation is visible at this layer, so staleness
    is handled the way the router's checkout re-verification does it:
    a pooled socket is probed at checkout (a restarted peer on the same
    port presents a closed/EOF socket) and :func:`fetch_blocks` retries
    exactly once on a fresh dial when a REUSED connection fails before
    any reply bytes arrived. Scoped per event loop (see
    :func:`peer_pool`): asyncio streams bind to the loop they were
    created on."""

    def __init__(self, max_idle_per_peer: int = 4):
        self._max_idle = int(max_idle_per_peer)
        self._idle: dict[tuple[str, int], list[tuple]] = {}
        self.dials = 0
        self.reuses = 0

    async def acquire(self, host: str, port: int, *,
                      timeout: float = 10.0):
        """``(reader, writer, fresh)`` — a pooled bin1 connection when
        a live one exists (``fresh=False``), else a new dial + hello
        negotiation. Raises :class:`KVTransferError` when the peer does
        not speak bin1."""
        from distkeras_tpu_torch.serving import wire

        key = (str(host), int(port))
        while self._idle.get(key):
            reader, writer = self._idle[key].pop()
            if reader.at_eof() or writer.is_closing():
                writer.close()  # dead incarnation — try the next one
                continue
            self.reuses += 1
            return reader, writer, False
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port, limit=2 ** 24), timeout)
        self.dials += 1
        try:
            writer.write(wire.hello_line())
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(), timeout)
            try:
                rec = json.loads(line) if line else {}
            except ValueError:
                rec = {}
            if wire.parse_hello(rec) != wire.PROTO_BIN1:
                raise KVTransferError(
                    f"peer {host}:{port} does not speak bin1 (KVBLK "
                    f"frames need the binary protocol)")
        except BaseException:
            writer.close()
            raise
        return reader, writer, True

    def release(self, host: str, port: int, reader, writer) -> None:
        """Return a healthy connection for reuse (closed when the
        per-peer idle bound is full)."""
        if reader.at_eof() or writer.is_closing():
            writer.close()
            return
        idle = self._idle.setdefault((str(host), int(port)), [])
        if len(idle) >= self._max_idle:
            writer.close()
            return
        idle.append((reader, writer))

    def discard(self, writer) -> None:
        writer.close()

    def stats(self) -> dict:
        return {"dials": self.dials, "reuses": self.reuses,
                "idle": sum(len(v) for v in self._idle.values())}

    def close_all(self) -> None:
        for conns in self._idle.values():
            for _, writer in conns:
                writer.close()
        self._idle.clear()


def peer_pool() -> PeerConnectionPool:
    """The running event loop's peer pool (created on first use, dies
    with the loop — streams must never cross loops)."""
    loop = asyncio.get_running_loop()
    pool = getattr(loop, "_distkeras_kv_peer_pool", None)
    if pool is None:
        pool = PeerConnectionPool()
        loop._distkeras_kv_peer_pool = pool
    return pool


async def _fetch_on(reader, writer, tokens, *, timeout: float,
                    trace_id: str | None):
    """One kv_export round trip on an established bin1 connection.
    Returns ``(payload | None, replied)`` — ``replied`` is False until
    the first reply frame arrived (the caller's stale-connection retry
    window)."""
    from distkeras_tpu_torch.serving import wire

    spec = {"cmd": "kv_export", "prompt": [int(t) for t in tokens]}
    if trace_id:
        spec["trace_id"] = str(trace_id)
    writer.write(wire.encode_json_frame(wire.T_CTRL, 1, spec))
    await writer.drain()
    decoder = wire.FrameDecoder()
    joiner = FrameJoiner()
    replied = False
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        try:
            data = await asyncio.wait_for(
                reader.read(2 ** 18),
                max(0.001, deadline - asyncio.get_running_loop().time()))
        except asyncio.TimeoutError:
            # A hung (but connected) peer is NOT a stale pooled
            # connection: re-dialing would wait the full budget again,
            # doubling the worst-case stall of the admission this pull
            # was supposed to accelerate. Propagate the documented
            # transport-failure signal; the caller discards the socket
            # (its reply is still owed) and falls back.
            raise
        except (OSError, ConnectionError):
            if replied:
                raise ConnectionError(
                    "peer connection failed mid kv_export reply")
            raise _StaleConn()
        if not data:
            if replied:
                raise ConnectionError("peer closed during kv_export")
            raise _StaleConn()
        for ftype, _sid, payload in decoder.feed(data):
            replied = True
            if ftype == wire.T_KVBLK:
                try:
                    whole = joiner.feed(payload)
                except KVTransferError as e:
                    # A broken chunk sequence leaves the REST of the
                    # peer's frames unread on this socket — pooling it
                    # would feed them to the next request as its reply.
                    e.conn_dirty = True
                    raise
                if whole is not None:
                    return whole
                continue  # more chunk frames owed
            if ftype == wire.T_CTRLR:
                rep = wire.decode_json(payload)
                if "error" in rep:
                    raise KVTransferError(str(rep["error"]))
                return None  # typed miss: peer has no blocks


class _StaleConn(ConnectionError):
    """A pooled connection died before any reply bytes — retry once on
    a fresh dial (a restarted peer on the same port presents exactly
    this)."""


async def fetch_blocks(host: str, port: int, tokens, *,
                       timeout: float = 10.0,
                       trace_id: str | None = None,
                       pool: PeerConnectionPool | None = None
                       ) -> bytes | None:
    """Pull the peer's cached KV blocks for ``tokens``' longest resident
    prefix: send the ``kv_export`` verb on a POOLED bin1 connection (the
    hello negotiation is paid once per peer, not once per migration) and
    read back the ``KVBLK`` frame(s) — multi-frame chains reassemble
    through :class:`FrameJoiner`. Returns the raw KVX1 payload, or
    ``None`` when the peer holds no blocks for this prompt (a miss, not
    a failure). Raises :class:`KVTransferError` on a typed peer-side
    reject and ``OSError``/``asyncio.TimeoutError`` on transport failure
    — callers treat every raise as "fall back to monolithic prefill". A
    pooled connection that proves stale at first use (restarted peer)
    costs one transparent re-dial, never a fallback."""
    pool = pool if pool is not None else peer_pool()
    for attempt in (0, 1):
        reader, writer, fresh = await pool.acquire(host, port,
                                                   timeout=timeout)
        try:
            result = await _fetch_on(reader, writer, tokens,
                                     timeout=timeout, trace_id=trace_id)
        except _StaleConn:
            pool.discard(writer)
            if fresh or attempt:
                raise ConnectionError(
                    f"peer {host}:{port} closed during kv_export")
            continue  # stale pooled conn: one retry on a fresh dial
        except KVTransferError as e:
            if getattr(e, "conn_dirty", False):
                # Mid-chunk-sequence reject: unread frames may still be
                # in flight on this socket — never pool it.
                pool.discard(writer)
            else:
                # Typed peer-side T_CTRLR reply: the connection itself
                # is healthy and fully drained.
                pool.release(host, port, reader, writer)
            raise
        except BaseException:
            pool.discard(writer)
            raise
        pool.release(host, port, reader, writer)
        return result


async def _push_on(reader, writer, payload: bytes, *, timeout: float):
    """One kv_push delivery on an established bin1 connection: stream
    the KVX1 payload as KVBLK frame(s) and wait for the receiver's
    adopt reply. Returns the receiver's ``kv_import`` result dict."""
    from distkeras_tpu_torch.serving import wire

    wrote = False
    try:
        for fp in split_frames(payload):
            writer.write(wire.encode_frame(wire.T_KVBLK, 1, fp))
            await writer.drain()
            wrote = True
    except (OSError, ConnectionError):
        if wrote:
            raise ConnectionError("peer connection failed mid kv_push")
        raise _StaleConn()
    decoder = wire.FrameDecoder()
    replied = False
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        try:
            data = await asyncio.wait_for(
                reader.read(2 ** 18),
                max(0.001, deadline - asyncio.get_running_loop().time()))
        except asyncio.TimeoutError:
            # A hung-but-connected receiver still owes the adopt ack:
            # propagate the transport-failure signal (the caller
            # discards the socket and falls back to pull/re-prefill).
            raise
        except (OSError, ConnectionError):
            if replied or wrote:
                raise ConnectionError(
                    "peer connection failed awaiting kv_push ack")
            raise _StaleConn()
        if not data:
            if replied or wrote:
                raise ConnectionError("peer closed during kv_push")
            raise _StaleConn()
        for ftype, _sid, fp in decoder.feed(data):
            replied = True
            if ftype == wire.T_CTRLR:
                rep = wire.decode_json(fp)
                if "error" in rep:
                    raise KVTransferError(str(rep["error"]))
                return rep.get("kv_import", rep)


async def push_blocks(host: str, port: int, payload: bytes, *,
                      timeout: float = 10.0,
                      pool: PeerConnectionPool | None = None) -> dict:
    """PUSH a serialized KVX1 chain to a peer: deliver KVBLK frame(s)
    on a pooled bin1 connection and wait for the receiver's adopt ack
    (its ``_kv_import_frame`` reply). The router schedules this P→D
    after a disaggregated prefill so the blocks are already resident
    when the decode replica admits the request — replacing the
    adopt-time pull (:func:`fetch_blocks`) and overlapping the transfer
    with the receiver's decode of earlier work. Returns the receiver's
    ``kv_import`` result (adopted/resident block counts, bytes). Raises
    :class:`KVTransferError` on a typed receiver-side reject and
    ``OSError``/``asyncio.TimeoutError`` on transport failure — callers
    treat every raise as "the receiver will pull (or re-prefill)
    instead". Unlike the pull path there is no miss case: the payload
    travels with the request.

    A connection that dies before the first frame is fully written
    retries once on a fresh dial (restarted-peer case); once payload
    bytes are in flight a failure propagates — the receiver's joiner
    state is unknown, so the socket is discarded, never pooled.
    """
    if len(payload) > MAX_TOTAL_TRANSFER_BYTES:
        raise KVTransferError(
            f"kv_push payload {len(payload)}B exceeds the transfer cap "
            f"{MAX_TOTAL_TRANSFER_BYTES}B")
    pool = pool if pool is not None else peer_pool()
    for attempt in (0, 1):
        reader, writer, fresh = await pool.acquire(host, port,
                                                   timeout=timeout)
        try:
            result = await _push_on(reader, writer, payload,
                                    timeout=timeout)
        except _StaleConn:
            pool.discard(writer)
            if fresh or attempt:
                raise ConnectionError(
                    f"peer {host}:{port} closed during kv_push")
            continue  # stale pooled conn: one retry on a fresh dial
        except KVTransferError:
            # Typed receiver-side T_CTRLR reply: the connection is
            # healthy and drained (one reply per pushed chain).
            pool.release(host, port, reader, writer)
            raise
        except BaseException:
            pool.discard(writer)
            raise
        pool.release(host, port, reader, writer)
        return result
