"""The port's ``ServingServer`` and ``ServingClient`` against the
reference's, on bridged ``gpt_tiny(seq_len=32, vocab_size=64)`` in float32.

- A reference ``ServingClient`` streams from a port ``ServingServer`` over
  JSONL and over the negotiated bin1 frames, and the port's client does
  the same: the streamed tokens equal the done record's and the reference
  ``generate()``'s.
- The bad-request and overflow codes equal the reference server's for the
  same lines.
- ``metricsz`` (JSON and Prometheus), ``healthz``, ``debugz``, ``queryz``,
  ``tracez`` and ``inject_latency`` answer; the verbs and frames of later
  slices answer with the typed error record naming their ROADMAP item.
- ``stop(drain=True)`` completes a mid-stream request and rejects new ones.

Servers bind port 0; every test runs under ``time_limited``.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.serving import ServingClient as RefClient
from distkeras_tpu.serving import ServingEngine as RefEngine
from distkeras_tpu.serving import ServingServer as RefServer
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.serving import (
    EngineStopped,
    ServingClient,
    ServingEngine,
    ServingServer,
)
from distkeras_tpu_torch.serving import wire as port_wire
from distkeras_tpu_torch.utils.bridge import params_from_jax
from tests.torch_time_limit import time_limited

VOCAB = 64


@pytest.fixture(scope="module")
def lm():
    ref = ref_bert.gpt_tiny(seq_len=32, vocab_size=VOCAB)
    ref = ref_bert._make(dataclasses.replace(ref.config, dtype=jnp.float32), 32, "gpt_tiny")
    port = port_bert.gpt_tiny(seq_len=32, vocab_size=VOCAB)
    port = port_bert._make(dataclasses.replace(port.config, dtype=torch.float32), 32,
                           "gpt_tiny")
    variables = ref.init(0)
    return ref, variables, port, params_from_jax(jax.tree.map(np.asarray, variables),
                                                 device="cpu")


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=(n,)).tolist() for n in lengths]


def _want(lm, prompt, n):
    ref, variables = lm[0], lm[1]
    return np.asarray(ref_generate(ref, variables, np.asarray([prompt], np.int32), n,
                                   greedy=True))[0].tolist()


def _port_server(lm, **kw):
    _, _, port, params = lm
    return ServingServer(ServingEngine(port, params, device="cpu", **kw), port=0)


async def _stream_two(client_cls, server, prompts, wire_mode):
    async def one(p):
        streamed = []
        async with client_cls("127.0.0.1", server.port, wire_mode=wire_mode) as c:
            done = await c.generate(p, 5, on_token=streamed.append)
            proto = c.proto
        return streamed, done, proto

    return await asyncio.gather(*(one(p) for p in prompts))


@pytest.mark.parametrize("client", ["reference", "port"])
@pytest.mark.parametrize("wire_mode", ["jsonl", "bin1"])
@time_limited
def test_client_streams_from_port_server(lm, client, wire_mode):
    prompts = _prompts(20, (6, 4))
    client_cls = RefClient if client == "reference" else ServingClient

    async def go():
        server = _port_server(lm, slots=2)
        await server.start()
        try:
            return await _stream_two(client_cls, server, prompts, wire_mode)
        finally:
            await server.stop(drain=True)

    for p, (streamed, done, proto) in zip(prompts, asyncio.run(go())):
        assert proto == wire_mode
        assert streamed == done["tokens"] == _want(lm, p, 5)
        assert done["ttft_ms"] > 0 and done["latency_ms"] >= done["ttft_ms"]
        assert done["weight_version"] == {"version": 0, "digest": None}


BAD_LINES = (
    b'{"prompt": [1], "max_new_tokens": 99}\n',  # context overflow
    b'{"max_new_tokens": 2}\n',  # malformed
    b'{"prompt": [1], "max_new_tokens": 2, "timeout": "zzz"}\n',  # uncastable
    b'{"prompt": [], "max_new_tokens": 2}\n',  # empty prompt
    b'{"cmd": "nope"}\n',  # unknown verb
)


async def _codes(server):
    await server.start()
    codes = []
    try:
        async with RefClient("127.0.0.1", server.port) as c:
            for line in BAD_LINES:
                c._writer.write(line)
                await c._writer.drain()
                codes.append(json.loads(await c._reader.readline()).get("code"))
            # The engine survived: a well-formed request still completes.
            toks = [t async for t in c.stream([1, 2], 2)]
        # bin1: a corrupt frame is a typed bad_request, then the close.
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        writer.write(port_wire.hello_line())
        await writer.drain()
        hello = json.loads(await reader.readline())
        writer.write(b"\x00\x00\x00\x00xxxxxxxx")
        await writer.drain()
        frames = port_wire.FrameDecoder().feed(await reader.read(4096))
        codes.append(port_wire.decode_json(frames[0][2])["code"])
        writer.close()
        assert hello["hello"]["proto"] == "bin1"
    finally:
        await server.stop()
    return codes, toks


@time_limited
def test_bad_request_and_overflow_codes_equal_reference(lm):
    ref, variables, _, _ = lm
    port_codes, port_toks = asyncio.run(_codes(_port_server(lm, slots=1, max_queue=1)))
    ref_codes, _ = asyncio.run(_codes(
        RefServer(RefEngine(ref, variables, slots=1, max_queue=1), port=0)))
    assert port_codes == ref_codes
    assert port_codes == ["bad_request"] * 6
    assert port_toks == _want(lm, [1, 2], 2)


@time_limited
def test_control_verbs_answer_and_deferred_verbs_name_their_item(lm):
    async def go():
        server = _port_server(lm, slots=2)
        await server.start()
        out = {}
        try:
            async with ServingClient("127.0.0.1", server.port) as c:
                await c.generate(_prompts(21, (4,))[0], 3)
                out["snap"] = await c.metricsz()
                out["prom"] = await c.metricsz(format="prometheus")
                out["health"] = await c.healthz()
                out["debugz"] = await c.debugz()
                out["queryz"] = await c.queryz(group_by=["tenant"], aggs=["count"])
                out["inject"] = await c._control({"cmd": "inject_latency",
                                                  "decode_delay_s": 0.0})
                for cmd in ("reload", "kv_prefill", "kv_push", "kv_export",
                            "telemetryz", "telemetry_start", "tracez"):
                    c._writer.write((json.dumps({"cmd": cmd}) + "\n").encode())
                    await c._writer.drain()
                    out[cmd] = json.loads(await c._reader.readline())
                c._writer.write(b'{"prompt": [1, 2], "max_new_tokens": 2, '
                                b'"kv_from": {"host": "h", "port": 1}}\n')
                await c._writer.drain()
                out["kv_from"] = json.loads(await c._reader.readline())
            # bin1: a KVBLK frame answers with the typed error on its stream.
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            writer.write(port_wire.hello_line())
            await writer.drain()
            await reader.readline()
            writer.write(port_wire.encode_frame(port_wire.T_KVBLK, 5, b"KVX1"))
            await writer.drain()
            frames = port_wire.FrameDecoder().feed(await reader.read(4096))
            out["kvblk"] = (frames[0][1], port_wire.decode_json(frames[0][2]))
            writer.close()
        finally:
            await server.stop(drain=True)
        return out

    out = asyncio.run(go())
    snap, health = out["snap"], out["health"]
    assert snap["serving_requests_completed_total"]["value"] == 1
    assert snap["serving_ttft_seconds"]["count"] == 1
    assert "# TYPE serving_ttft_seconds histogram" in out["prom"]
    assert "serving_requests_completed_total 1" in out["prom"]
    assert health["slots"] == 2 and health["active_slots"] == 0
    assert health["decode_compile_count"] == 1
    assert health["device_memory"][0]["available"] is False  # CPU: no data, not 0
    assert out["debugz"]["decode_compile_count"] == 1
    assert out["queryz"]["groups"][0]["count"] == 1
    assert out["inject"] == {"inject_latency": {"decode_delay_s": 0.0}}
    items = {"reload": "A7b", "kv_prefill": "A8", "kv_push": "A8", "kv_export": "A8",
             "telemetryz": "A8", "telemetry_start": "A8", "kv_from": "A8"}
    for cmd, item in items.items():
        assert out[cmd]["code"] == "bad_request", cmd
        assert f"item {item}" in out[cmd]["error"], cmd
    assert out["tracez"]["code"] == "bad_request"  # no trace store, as the reference
    sid, rec = out["kvblk"]
    assert sid == 5 and rec["code"] == "bad_request" and "item A8" in rec["error"]


@time_limited
def test_server_stop_drain_completes_inflight_rejects_new(lm):
    p = _prompts(22, (4,))[0]
    other = _prompts(23, (3,))[0]

    async def go():
        server = _port_server(lm, slots=1)
        await server.start()
        streamer = ServingClient("127.0.0.1", server.port)
        late = ServingClient("127.0.0.1", server.port)
        await streamer.connect()
        await late.connect()  # connected BEFORE the listener closes
        stream = streamer.stream(p, 12)
        first = await stream.__anext__()  # admitted, mid-stream
        stop_task = asyncio.create_task(server.stop(drain=True))
        await asyncio.sleep(0)  # let stop() close admission
        with pytest.raises(EngineStopped):
            await late.generate(other, 2)
        toks = [first] + [t async for t in stream]
        await streamer.aclose()
        await late.aclose()
        await stop_task
        return toks

    assert asyncio.run(go()) == _want(lm, p, 12)
