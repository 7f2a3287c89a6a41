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
- ``reload`` swaps in a weight file the port's ``checkpoint.py`` wrote:
  ``weight_version`` changes and later tokens are the new weights'
  ``generate()``'s, on a dense and a paged engine; a bad path or a
  mismatched file answers with the reference server's codes.
- The request kinds over JSONL and bin1 on a paged engine: ``score``,
  ``embed`` and ``sample`` done records equal the reference server's.

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


async def _fleet_verbs(server, kvblk_payload=b"KVX1") -> dict:
    """The fleet's verbs on a dense engine's server, one reply each: the
    KV verbs over JSONL, a request with a ``kv_from`` hint at a dead peer,
    the telemetry pull, and a KVBLK frame over bin1."""
    out = {}
    reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
    for cmd in ("kv_prefill", "kv_push", "kv_export", "telemetryz", "telemetry_start",
                "tracez"):
        writer.write((json.dumps({"cmd": cmd}) + "\n").encode())
        await writer.drain()
        out[cmd] = json.loads(await reader.readline())
    writer.write(b'{"prompt": [1, 2], "max_new_tokens": 2, '
                 b'"kv_from": {"host": "127.0.0.1", "port": 1}}\n')
    await writer.drain()
    while True:
        rec = json.loads(await reader.readline())
        if "token" not in rec:
            out["kv_from"] = rec
            break
    writer.close()
    # bin1: a KVBLK frame answers on its stream.
    reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
    writer.write(port_wire.hello_line())
    await writer.drain()
    await reader.readline()
    writer.write(port_wire.encode_frame(port_wire.T_KVBLK, 5, kvblk_payload))
    await writer.drain()
    frames = port_wire.FrameDecoder().feed(await reader.read(4096))
    out["kvblk"] = (frames[0][1], port_wire.decode_json(frames[0][2]))
    writer.close()
    return out


@time_limited
def test_control_verbs_answer_and_deferred_verbs_name_their_item(lm):
    """The control verbs answer; the fleet's verbs, which the port now
    serves, answer a dense engine's server as the reference server does:
    the same error codes, the same keys of the telemetry delta, and a
    ``kv_from`` hint at a dead peer served with a recorded fallback."""
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
            out.update(await _fleet_verbs(server))
        finally:
            await server.stop(drain=True)
        return out

    async def go_ref():
        ref, variables = lm[0], lm[1]
        server = RefServer(RefEngine(ref, variables, slots=2), port=0)
        await server.start()
        try:
            return await _fleet_verbs(server)
        finally:
            await server.stop(drain=True)

    out = asyncio.run(go())
    theirs = asyncio.run(go_ref())
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
    for cmd in ("kv_prefill", "kv_push", "kv_export", "telemetry_start", "tracez"):
        assert "item A8" not in str(out[cmd]), cmd
        assert out[cmd].get("code") == theirs[cmd].get("code"), (cmd, out[cmd], theirs[cmd])
    assert sorted(out["telemetryz"]) == sorted(theirs["telemetryz"]) == ["telemetryz"]
    assert out["tracez"]["code"] == "bad_request"  # no trace store, as the reference
    # A dense engine cannot adopt blocks: the hint is a counted fallback and
    # the request is served, on both servers.
    assert out["kv_from"]["done"] and theirs["kv_from"]["done"]
    assert out["kv_from"]["tokens"] == _want(lm, [1, 2], 2)
    assert "fallback" in out["kv_from"]["kv_migration"]
    assert "fallback" in theirs["kv_from"]["kv_migration"]
    sid, rec = out["kvblk"]
    assert sid == theirs["kvblk"][0] == 5
    assert rec.get("code") == theirs["kvblk"][1].get("code") and "item A8" not in str(rec)


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


# -- reload and the request kinds ---------------------------------------------------

def _weight_file(lm, tmp_path, seed, name="w.npz"):
    """A weight file of seed ``seed``'s weights, written by the port's
    checkpoint module; returns its path and the reference variables."""
    from distkeras_tpu_torch.checkpoint import save_weights_file
    from distkeras_tpu_torch.utils.bridge import params_to_jax

    ref, _, port, _ = lm
    variables = ref.init(seed)
    params = params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    path = str(tmp_path / name)
    save_weights_file(path, params_to_jax(params, port.module), version=seed + 10)
    return path, variables


@pytest.mark.parametrize("layout", [{}, {"kv_pool_blocks": 64, "kv_block_tokens": 4}],
                         ids=["dense", "paged"])
@time_limited
def test_reload_swaps_weights_and_weight_version(lm, tmp_path, layout):
    path, new_vars = _weight_file(lm, tmp_path, 1)
    p = _prompts(51, (5,))[0]

    async def go():
        server = _port_server(lm, slots=2, **layout)
        await server.start()
        try:
            async with ServingClient("127.0.0.1", server.port) as c:
                before = await c.generate(p, 5)
                swapped = await c.reload(path)
                after = await c.generate(p, 5)
                health = await c.healthz()
        finally:
            await server.stop(drain=True)
        return before, swapped, after, health

    before, swapped, after, health = asyncio.run(go())
    assert before["tokens"] == _want(lm, p, 5)
    assert before["weight_version"]["version"] == 0
    assert swapped["ok"] and swapped["weight_version"]["version"] == 11
    assert swapped["weight_version"]["digest"]
    assert after["weight_version"] == swapped["weight_version"]
    want = np.asarray(ref_generate(lm[0], new_vars, np.asarray([p], np.int32), 5,
                                   greedy=True))[0].tolist()
    assert after["tokens"] == want != before["tokens"]
    assert health["weight_version"] == swapped["weight_version"]
    assert health["decode_compile_count"] == 1


@time_limited
def test_reload_errors_equal_reference_codes(lm, tmp_path):
    small = port_bert.gpt_tiny(seq_len=32, vocab_size=32)
    from distkeras_tpu_torch.checkpoint import save_weights_file
    from distkeras_tpu_torch.utils.bridge import params_to_jax

    wrong = str(tmp_path / "wrong.npz")
    save_weights_file(wrong, params_to_jax(small.init(0, device="cpu"), small.module))
    lines = [{"cmd": "reload"}, {"cmd": "reload", "weights": str(tmp_path / "missing")},
             {"cmd": "reload", "weights": wrong}, {"cmd": "reload", "weights": wrong,
                                                   "timeout": "soon"}]

    async def codes(server):
        await server.start()
        out = []
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            for line in lines:
                writer.write((json.dumps(line) + "\n").encode())
                await writer.drain()
                out.append(json.loads(await reader.readline()).get("code"))
            writer.close()
        finally:
            await server.stop(drain=True)
        return out

    ref, variables = lm[0], lm[1]
    port_codes = asyncio.run(codes(_port_server(lm, slots=1)))
    ref_codes = asyncio.run(codes(RefServer(RefEngine(ref, variables, slots=1), port=0)))
    assert port_codes == ref_codes == ["bad_request"] * 4


@pytest.mark.parametrize("wire_mode", ["jsonl", "bin1"])
@time_limited
def test_request_kinds_over_tcp_equal_reference_server(lm, wire_mode):
    paged = {"slots": 4, "kv_pool_blocks": 64, "kv_block_tokens": 4}
    p = _prompts(52, (9,))[0]

    async def go(server, client_cls):
        await server.start()
        try:
            async with client_cls("127.0.0.1", server.port, wire_mode=wire_mode) as c:
                score = await c.score(p)
                embed = await c.embed(p)
                sample = await c.sample(p, 4, n=2, speculate=False)
                proto = c.proto
        finally:
            await server.stop(drain=True)
        return score, embed, sample, proto

    ref, variables = lm[0], lm[1]
    got = asyncio.run(go(_port_server(lm, **paged), ServingClient))
    theirs = asyncio.run(go(RefServer(RefEngine(ref, variables, **paged), port=0), RefClient))
    assert got[3] == theirs[3] == wire_mode
    np.testing.assert_allclose(got[0]["logprobs"], theirs[0]["logprobs"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[1]["embedding"], theirs[1]["embedding"], rtol=1e-5,
                               atol=1e-6)
    assert got[2]["completions"] == theirs[2]["completions"] == [_want(lm, p, 4)] * 2
    assert got[0]["kind"] == "score" and got[2]["kind"] == "sample"
