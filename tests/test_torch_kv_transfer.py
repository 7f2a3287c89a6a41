"""KV block transfer (``serving/kv_transfer.py``) on the port, against the
reference.

- The KVX1 codec: round trips and typed rejects parametrised over both
  packages; the port's ``serialize_blocks`` byte-equal to the reference's
  for the same float32 and bfloat16 leaves, and each package reading the
  other's payload.
- A cross-package engine round trip at **12 layers** (hidden 32, 2 heads,
  float32), where the reference's leaf order (``layer_0, layer_1,
  layer_10, layer_11, layer_2, ...``) differs from the numeric one: a
  reference paged engine exports a prompt's chain, the port's paged engine
  imports it and continues to the reference ``generate()``'s greedy
  tokens, served from the imported blocks; and the reverse.
- Within the port: export -> import -> re-export is bitwise, and the
  continuation equals ``generate()``; provenance and block geometry give
  typed rejects before any pool row is touched; a dry pool adopts nothing
  and reports it; ``KVBlockPool.adopt_foreign`` over both packages.
- Chunked frames: ``split_frames``/``FrameJoiner`` round trips bitwise and
  typed rejects over both packages, across them, and over the wire from
  a port server with the frame bound lowered below one block.

Engine tests run under ``time_limited``.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.serving import kv_transfer as ref_kvt
from distkeras_tpu.serving import prefix_cache as ref_prefix
from distkeras_tpu.serving.engine import ServingEngine as RefEngine
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.serving import ServingEngine, ServingServer
from distkeras_tpu_torch.serving import kv_transfer as port_kvt
from distkeras_tpu_torch.serving import prefix_cache as port_prefix
from distkeras_tpu_torch.utils.bridge import params_from_jax
from tests.test_torch_serving_engine import _pair, _port, _prompts, _want
from tests.torch_time_limit import time_limited

CODECS = pytest.mark.parametrize("kvt", [ref_kvt, port_kvt], ids=["reference", "port"])
VOCAB = 64


def _raw(leaf) -> bytes:
    """A leaf's bytes, numpy array or tensor (bf16 as its 16-bit patterns)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


# -- the codec -------------------------------------------------------------------

@CODECS
def test_kvx1_codec_bitwise_and_typed_rejects(kvt):
    tokens = list(range(8))
    leaves = [np.arange(2 * 4 * 3 * 2, dtype=np.float32).reshape(2, 4, 3, 2),
              np.arange(2 * 4 * 5, dtype=np.int32).reshape(2, 4, 5)]
    payload = kvt.serialize_blocks(tokens, leaves, block_tokens=4,
                                   provenance={"version": 3, "digest": "ab"})
    header, out = kvt.deserialize_blocks(payload)
    assert header["tokens"] == tokens
    assert header["provenance"] == {"version": 3, "digest": "ab"}
    for a, b in zip(leaves, out):
        assert _raw(a) == _raw(b)
    assert kvt.serialize_blocks(header["tokens"], out, block_tokens=header["block_tokens"],
                                provenance=header["provenance"]) == payload
    with pytest.raises(kvt.KVTransferError):
        kvt.peek_header(b"NOPE" + payload[4:])
    with pytest.raises(kvt.KVTransferError):
        kvt.deserialize_blocks(payload[:-3])
    with pytest.raises(kvt.KVTransferError):
        kvt.deserialize_blocks(payload + b"x")
    with pytest.raises(kvt.KVTransferError):
        kvt.serialize_blocks(tokens[:-1], leaves, block_tokens=4)
    assert kvt.KVTransferError.code == "kv_transfer"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serialize_blocks_byte_equal_across_packages(dtype):
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((3, 4, 2, 8)).astype(np.float32) for _ in range(4)]
    tokens = list(range(12))
    prov = {"version": 2, "digest": "0123456789abcdef"}
    if dtype == "bfloat16":
        ref_leaves = [a.astype(ml_dtypes.bfloat16) for a in arrays]
        port_leaves = [torch.from_numpy(a).bfloat16() for a in arrays]
    else:
        ref_leaves, port_leaves = arrays, [torch.from_numpy(a) for a in arrays]
    theirs = ref_kvt.serialize_blocks(tokens, ref_leaves, block_tokens=4, provenance=prov)
    mine = port_kvt.serialize_blocks(tokens, port_leaves, block_tokens=4, provenance=prov)
    assert mine == theirs
    # Each package reads the other's payload to the same leaves.
    header, got = port_kvt.deserialize_blocks(theirs)
    assert header["leaves"][0]["dtype"] == dtype
    for a, b in zip(port_leaves, got):
        assert b.dtype == a.dtype and torch.equal(a, b)
    _, back = ref_kvt.deserialize_blocks(mine)
    for a, b in zip(ref_leaves, back):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_port_codec_leaf_dtype_name_unknown_is_typed():
    payload = bytearray(port_kvt.serialize_blocks([1, 2], [np.zeros((1, 2, 1), np.float32)],
                                                  block_tokens=2))
    bad = bytes(payload).replace(b'"float32"', b'"floatXX"')
    with pytest.raises(port_kvt.KVTransferError, match="dtype"):
        port_kvt.deserialize_blocks(bad)


# -- chunk frames ----------------------------------------------------------------

@pytest.mark.parametrize("split,join", [(ref_kvt, ref_kvt), (port_kvt, port_kvt),
                                        (port_kvt, ref_kvt), (ref_kvt, port_kvt)],
                         ids=["reference", "port", "port-to-reference", "reference-to-port"])
def test_split_frames_join_bitwise_roundtrip(split, join):
    small = b"KVX1" + bytes(range(256)) * 10
    assert split.split_frames(small) == [small]
    assert not join.is_chunk_frame(small)
    rng = np.random.default_rng(3)
    big = bytes(rng.integers(0, 256, size=5000, dtype=np.uint8))
    frames = split.split_frames(big, max_frame_bytes=1024)
    assert frames == ref_kvt.split_frames(big, max_frame_bytes=1024)
    assert len(frames) > 1 and all(join.is_chunk_frame(f) and len(f) <= 1024 for f in frames)
    joiner = join.FrameJoiner()
    outs = [joiner.feed(f) for f in frames]
    assert outs[:-1] == [None] * (len(frames) - 1) and outs[-1] == big


@CODECS
def test_frame_joiner_typed_rejects(kvt):
    frames = kvt.split_frames(bytes(range(256)) * 20, max_frame_bytes=512)
    assert len(frames) >= 3
    j = kvt.FrameJoiner()
    j.feed(frames[0])
    with pytest.raises(kvt.KVTransferError, match="out of order"):
        j.feed(frames[2])
    j = kvt.FrameJoiner()
    j.feed(frames[0])
    with pytest.raises(kvt.KVTransferError, match="mid chunk"):
        j.feed(b"KVX1whatever")
    j = kvt.FrameJoiner(max_total_bytes=600)
    with pytest.raises(kvt.KVTransferError, match="cap"):
        for f in frames:
            j.feed(f)
    with pytest.raises(kvt.KVTransferError, match="cap"):
        kvt.split_frames(b"x" * (kvt.MAX_TOTAL_TRANSFER_BYTES + 1))


@pytest.mark.parametrize("mod", [ref_prefix, port_prefix], ids=["reference", "port"])
def test_adopt_foreign_pool_dry_and_partial(mod):
    pool = mod.KVBlockPool(4, 4)
    tokens = list(range(16))
    uploads, resident = pool.adopt_foreign(tokens, 4)
    assert len(uploads) == 4 and resident == 4
    assert pool.adopt_foreign(tokens, 4) == ([], 4)
    dry = mod.KVBlockPool(2, 4)
    assert dry.alloc(2) is not None and dry.blocks_free == 0
    assert dry.adopt_foreign(tokens, 4) == ([], 0)
    part = mod.KVBlockPool(2, 4)
    uploads, resident = part.adopt_foreign(tokens, 4)
    assert len(uploads) == 2 and resident == 2


# -- engines ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    return _pair(seq_len=64)


@pytest.fixture(scope="module")
def lm12():
    """12 layers, hidden 32, 2 heads, float32: past ten layers, the
    reference's sorted leaf order differs from the numeric one."""
    shape = dict(num_layers=12, hidden_size=32, num_heads=2, mlp_dim=64)
    ref = ref_bert.gpt_tiny(seq_len=32, vocab_size=VOCAB)
    ref = ref_bert._make(dataclasses.replace(ref.config, dtype=jnp.float32, **shape), 32,
                         "gpt_tiny")
    port = port_bert.gpt_tiny(seq_len=32, vocab_size=VOCAB)
    port = port_bert._make(dataclasses.replace(port.config, dtype=torch.float32, **shape), 32,
                           "gpt_tiny")
    variables = ref.init(0)
    return ref, variables, port, params_from_jax(jax.tree.map(np.asarray, variables),
                                                 device="cpu")


PAGED = dict(slots=2, kv_pool_blocks=32, kv_block_tokens=4)


async def _run(engine, coro):
    task = asyncio.create_task(engine.run())
    try:
        return await coro
    finally:
        engine.shutdown(drain=True)
        await task


async def _kv_op(fn, arg):
    event, result = fn(arg)
    await asyncio.wait_for(event.wait(), 30)
    return result


def _export(engine, prompt):
    async def go():
        await engine.submit(prompt, 1).result()
        return await _kv_op(engine.request_kv_export, prompt)

    return asyncio.run(_run(engine, go()))


def _import_and_continue(engine, payload, prompt, n):
    async def go():
        imp = await _kv_op(engine.request_kv_import, payload)
        req = engine.submit(prompt, n)
        return imp, await req.result(), req.prefix_hit_tokens

    return asyncio.run(_run(engine, go()))


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference"])
@time_limited(timeout=180)
def test_cross_package_engine_round_trip_at_12_layers(lm12, direction):
    ref, variables, port, params = lm12
    prompt = _prompts(80, (13,))[0]
    want = np.asarray(ref_generate(ref, variables, np.asarray([prompt], np.int32), 6,
                                   greedy=True))[0].tolist()
    ref_engine = RefEngine(ref, variables, **PAGED)
    port_engine = ServingEngine(port, params, device="cpu", **PAGED)
    src, dst = ((ref_engine, port_engine) if direction == "reference-to-port"
                else (port_engine, ref_engine))
    res = _export(src, prompt)
    assert "error" not in res and res["blocks"] == 3, res
    header = port_kvt.peek_header(res["payload"])
    assert len(header["leaves"]) == 24  # K and V of 12 layers
    imp, got, hit = _import_and_continue(dst, res["payload"], prompt, 6)
    assert "error" not in imp, imp
    assert imp["adopted_blocks"] == 3 and imp["matched_tokens"] == 12
    assert hit == 12  # the continuation read the imported blocks
    assert got == want


@time_limited
def test_export_import_reexport_bitwise_and_identical_continuation(lm):
    prompt = _prompts(81, (13,))[0]
    e1, e2 = _port(lm, **PAGED), _port(lm, **PAGED)
    res = _export(e1, prompt)
    assert res["matched_tokens"] == 12 and res["bytes"] == len(res["payload"])
    imp, got, hit = _import_and_continue(e2, res["payload"], prompt, 6)
    assert imp["adopted_blocks"] == 3 and hit == 12
    assert got == _want(lm, prompt, 6)
    again = asyncio.run(_run(e2, _kv_op(e2.request_kv_export, prompt)))
    assert again["payload"] == res["payload"]  # bitwise, header and leaves
    assert e1.metrics.kv_exports == 1


@time_limited
def test_provenance_and_geometry_are_typed_rejects(lm):
    prompt = _prompts(82, (12,))[0]
    res = _export(_port(lm, **PAGED), prompt)
    other = _port(lm, weight_version={"version": 7, "digest": "beef"}, **PAGED)
    imp = asyncio.run(_run(other, _kv_op(other.request_kv_import, res["payload"])))
    assert isinstance(imp.get("error"), port_kvt.KVTransferError)
    assert "provenance" in str(imp["error"]) and imp["error"].code == "kv_transfer"
    assert other.kv_pool.blocks_used == 0
    bad = _port(lm, slots=2, kv_pool_blocks=32, kv_block_tokens=8)
    imp = asyncio.run(_run(bad, _kv_op(bad.request_kv_import, res["payload"])))
    assert isinstance(imp.get("error"), port_kvt.KVTransferError)
    assert "geometry" in str(imp["error"]) and bad.kv_pool.blocks_used == 0


@time_limited
def test_pool_dry_import_adopts_nothing_and_reports(lm):
    prompt = _prompts(83, (12,))[0]
    res = _export(_port(lm, **PAGED), prompt)
    dry = _port(lm, slots=2, kv_pool_blocks=4, kv_block_tokens=4)
    assert dry.kv_pool.alloc(4) is not None
    imp = dry._kv_import_sync(res["payload"])
    assert imp["adopted_blocks"] == 0 and imp["resident_blocks"] == 0


@time_limited
def test_chunked_export_reassembles_over_the_wire(lm):
    """A port server's export split into KVXC frames (the per-frame bound
    lowered below one block) reassembles bitwise through ``fetch_blocks``,
    and the reference's pull client reads it the same."""
    prompt = _prompts(84, (16,))[0]

    async def main():
        engine = _port(lm, **PAGED)
        server = ServingServer(engine, port=0)
        await server.start()
        try:
            await engine.submit(prompt, 1).result()
            want = await _kv_op(engine.request_kv_export, prompt)
            orig = port_kvt.MAX_TRANSFER_BYTES
            port_kvt.MAX_TRANSFER_BYTES = 1024
            pulled = {}
            try:
                for name, mod in (("port", port_kvt), ("reference", ref_kvt)):
                    pool = mod.PeerConnectionPool()
                    try:
                        pulled[name] = await mod.fetch_blocks("127.0.0.1", server.port, prompt,
                                                              timeout=10, pool=pool)
                    finally:
                        pool.close_all()
            finally:
                port_kvt.MAX_TRANSFER_BYTES = orig
            return want["payload"], pulled
        finally:
            await server.stop()

    want, pulled = asyncio.run(main())
    assert len(want) > 4 * 1024
    assert pulled == {"port": want, "reference": want}
