"""The port's copies of the serving host modules against the reference's.

``serving/wire.py``, ``serving/scheduler.py``, ``telemetry/recompile.py``
and the prefix cache's trie are jax-free copies (the recompile auditor and
the cache's device pool are ported). The reference's unit cases run here
against both packages, parametrized over the module, and the bin1 frames
the port encodes (request, token and JSON frames, and the hello line) are
byte-equal to the reference's.
"""

import asyncio
from collections import Counter

import numpy as np
import pytest
import torch

from distkeras_tpu.serving import prefix_cache as ref_prefix
from distkeras_tpu.serving import scheduler as ref_sched
from distkeras_tpu.serving import wire as ref_wire
from distkeras_tpu.telemetry import recompile as ref_recompile
from distkeras_tpu_torch.serving import prefix_cache as port_prefix
from distkeras_tpu_torch.serving import scheduler as port_sched
from distkeras_tpu_torch.serving import wire as port_wire
from distkeras_tpu_torch.telemetry import recompile as port_recompile

WIRES = pytest.mark.parametrize("wire", [ref_wire, port_wire], ids=["reference", "port"])
SCHEDS = pytest.mark.parametrize("sched", [ref_sched, port_sched], ids=["reference", "port"])


def _spec(**over):
    spec = {"prompt": [1, 2, 3, 500], "max_new_tokens": 8,
            "temperature": 0.5, "priority": -1, "timeout": None,
            "speculate": False, "tenant": "acme", "trace_id": "abc-123"}
    spec.update(over)
    return spec


# -- wire ------------------------------------------------------------------------

@WIRES
def test_request_roundtrip_all_fields(wire):
    spec = _spec()
    assert wire.decode_request(wire.encode_request(spec)) == spec
    spec2 = {"prompt": list(range(300)), "max_new_tokens": 2,
             "temperature": 0.0, "priority": 0, "timeout": 12.5,
             "speculate": True}
    assert wire.decode_request(wire.encode_request(spec2)) == spec2


@WIRES
def test_request_length_fields_validated(wire):
    payload = bytearray(wire.encode_request(_spec()))
    with pytest.raises(wire.WireError):
        wire.decode_request(payload[:-1])  # truncated
    with pytest.raises(wire.WireError):
        wire.decode_request(b"\x00" * 4)  # shorter than the header


@WIRES
def test_frame_decoder_incremental_byte_at_a_time(wire):
    spec = _spec()
    frames = (wire.encode_frame(wire.T_REQ, 7, wire.encode_request(spec))
              + wire.encode_token_frame(9, [5, 6, 7])
              + wire.encode_json_frame(wire.T_DONE, 9, {"done": True}))
    dec = wire.FrameDecoder()
    got = []
    for i in range(len(frames)):
        got.extend(dec.feed(frames[i:i + 1]))
    assert [t for t, _, _ in got] == [wire.T_REQ, wire.T_TOK, wire.T_DONE]
    assert wire.decode_request(got[0][2]) == spec
    assert got[1][1] == 9 and wire.decode_tokens(got[1][2]) == [5, 6, 7]
    assert wire.decode_json(got[2][2]) == {"done": True}


@WIRES
def test_corrupt_and_oversized_frames_raise_typed(wire):
    with pytest.raises(wire.WireError):
        wire.FrameDecoder().feed(b"\x00\x00\x00\x00xxxxxxxx")
    with pytest.raises(wire.WireError):
        wire.FrameDecoder().feed((2 ** 25).to_bytes(4, "little"))


@WIRES
def test_native_python_parity(wire):
    if not wire.native_available():
        pytest.skip("libfastwire.so not built (no C++ toolchain): only the "
                    "struct path exists")
    updates = [(i + 1, list(range(i, i + 40))) for i in range(12)]
    native_pack = wire.pack_token_frames(updates)
    stream = native_pack * 8  # past the small-buffer crossover
    native_scan = wire.FrameDecoder().feed(stream)
    lib = wire._LIB
    try:
        wire._LIB = None
        assert wire.pack_token_frames(updates) == native_pack
        assert wire.FrameDecoder().feed(stream) == native_scan
    finally:
        wire._LIB = lib


@pytest.mark.parametrize("spec", [
    _spec(),
    _spec(prompt=list(range(300)), timeout=12.5, speculate=True, tenant="", trace_id=""),
    _spec(prompt=[7], temperature=0.0, priority=3),
    _spec(resume_tokens=[4, 5], kind="generate"),
])
def test_frames_encode_byte_equal_to_reference(spec):
    assert port_wire.encode_request(spec) == ref_wire.encode_request(spec)
    assert (port_wire.encode_frame(port_wire.T_REQ, 3, port_wire.encode_request(spec))
            == ref_wire.encode_frame(ref_wire.T_REQ, 3, ref_wire.encode_request(spec)))
    toks = list(range(0, 50257, 997))
    assert port_wire.encode_token_frame(11, toks) == ref_wire.encode_token_frame(11, toks)
    done = {"done": True, "tokens": toks[:5], "ttft_ms": 1.5, "trace_id": "t"}
    for t in (port_wire.T_DONE, port_wire.T_ERR, port_wire.T_CTRL, port_wire.T_CTRLR):
        assert (port_wire.encode_json_frame(t, 2, done)
                == ref_wire.encode_json_frame(t, 2, done))
    assert port_wire.hello_line() == ref_wire.hello_line()
    updates = [(1, [1, 2]), (5, [3])]
    assert port_wire.pack_token_frames(updates) == ref_wire.pack_token_frames(updates)


# -- scheduler -------------------------------------------------------------------

@SCHEDS
def test_scheduler_priority_fifo_and_backpressure(sched):
    async def go():
        s = sched.Scheduler(max_depth=3)
        a = sched.Request([1], 1, priority=1)
        b = sched.Request([2], 1, priority=0)
        c = sched.Request([3], 1, priority=1)
        for r in (a, b, c):
            s.submit(r)
        with pytest.raises(sched.QueueFullError):
            s.submit(sched.Request([4], 1))
        assert s.pop() is b and s.pop() is a and s.pop() is c
        assert s.pop() is None

    asyncio.run(go())


@SCHEDS
def test_scheduler_peek_is_nondestructive_head(sched):
    async def go():
        s = sched.Scheduler(max_depth=4)
        assert s.peek() is None
        a = sched.Request([1], 1, priority=1)
        s.submit(a)
        assert s.peek() is a and s.peek() is a
        b = sched.Request([2], 1, priority=0)
        s.submit(b)
        assert s.peek() is b
        assert s.pop() is b and s.peek() is a

    asyncio.run(go())


@SCHEDS
def test_scheduler_expires_queued_deadlines(sched):
    async def go():
        s = sched.Scheduler(max_depth=4)
        fast = sched.Request([1], 1, timeout=0.0)
        slow = sched.Request([2], 1)
        s.submit(fast, now=100.0)
        s.submit(slow, now=100.0)
        assert s.expire(now=101.0) == [fast]
        assert s.pop(now=101.0) is slow

    asyncio.run(go())


@SCHEDS
def test_scheduler_cache_aware_pop_prefers_hits_within_class(sched):
    async def go():
        scores = {(7, 7): 8, (1, 1): 0, (2, 2): 4}
        s = sched.Scheduler(max_depth=8, cache_probe=lambda p: scores.get(tuple(p), 0))
        cold = sched.Request([1, 1], 1)
        warm = sched.Request([7, 7], 1)
        lukewarm = sched.Request([2, 2], 1)
        urgent = sched.Request([1, 1], 1, priority=-1)
        for r in (cold, warm, lukewarm):
            s.submit(r)
        assert s.pop() is warm
        s.submit(urgent)
        assert s.pop() is urgent
        assert s.pop() is lukewarm and s.pop() is cold
        s3 = sched.Scheduler(max_depth=16, cache_probe=lambda p: p[0])
        cold3 = sched.Request([0], 1)
        s3.submit(cold3)
        for _ in range(s3.max_overtake):
            s3.submit(sched.Request([9], 1))
            assert s3.pop() is not cold3
        s3.submit(sched.Request([9], 1))
        assert s3.pop() is cold3

    asyncio.run(go())


@SCHEDS
def test_drr_fair_service_and_weights(sched):
    async def go():
        s = sched.Scheduler(max_depth=64, drr_quantum=4)
        for _ in range(6):
            s.submit(sched.Request([1], 4, tenant="a"), now=0.0)
        for _ in range(6):
            s.submit(sched.Request([2], 4, tenant="b"), now=0.0)
        order = [s.pop(now=1.0).tenant for _ in range(12)]
        for i in range(2, 13, 2):
            c = Counter(order[:i])
            assert abs(c["a"] - c["b"]) <= 1, order
        w = sched.Scheduler(max_depth=64, drr_quantum=4, tenant_weights={"a": 2.0})
        for _ in range(12):
            w.submit(sched.Request([1], 4, tenant="a"), now=0.0)
        for _ in range(12):
            w.submit(sched.Request([2], 4, tenant="b"), now=0.0)
        first = Counter(w.pop(now=1.0).tenant for _ in range(12))
        assert first["a"] >= 7, first

    asyncio.run(go())


def test_drr_order_equals_reference():
    """The same submissions pop in the same tenant order from both."""
    def order(sched):
        async def go():
            s = sched.Scheduler(max_depth=64, drr_quantum=3, tenant_weights={"b": 1.5})
            for i in range(9):
                s.submit(sched.Request([i], 2 + i % 4, tenant="abc"[i % 3],
                                       priority=i % 2), now=0.0)
            return [(r.tenant, r.prompt[0]) for r in (s.pop(now=1.0) for _ in range(9))]

        return asyncio.run(go())

    assert order(port_sched) == order(ref_sched)


@SCHEDS
def test_quota_typed_reject_refund_and_submit_many(sched):
    async def go():
        s = sched.Scheduler(max_depth=64, tenant_quotas={"a": 10.0}, quota_burst_s=1.0)
        r1 = sched.Request([1], 8, tenant="a")
        s.submit(r1, now=100.0)
        with pytest.raises(sched.TenantOverQuota):
            s.submit(sched.Request([1], 8, tenant="a"), now=100.0)
        s.submit(sched.Request([1], 8, tenant="b"), now=100.0)
        r1.out_tokens = [1, 2]
        s.release_quota(r1)
        s.submit(sched.Request([1], 6, tenant="a"), now=100.0)
        s.release_quota(r1)
        stats = s.tenant_stats()
        assert stats["a"]["over_quota_rejects"] == 1
        m = sched.Scheduler(max_depth=2, tenant_quotas={"q": 1.0}, quota_burst_s=1.0)
        out = m.submit_many([sched.Request([1], 1, tenant="q"),
                             sched.Request([1], 9, tenant="q"),
                             sched.Request([1], 1), sched.Request([1], 1)], now=0.0)
        assert out[0] is None and out[2] is None
        assert isinstance(out[1], sched.TenantOverQuota)
        assert type(out[3]).__name__ == "QueueFullError"

    asyncio.run(go())


@pytest.mark.parametrize("name", ["ServingError", "QueueFullError", "PoolExhausted",
                                  "RequestTimeout", "EngineStopped", "RequestCancelled",
                                  "TenantOverQuota"])
def test_error_codes_equal_reference(name):
    port_err, ref_err = getattr(port_sched, name)("x"), getattr(ref_sched, name)("x")
    assert port_err.code == ref_err.code
    assert [c.__name__ for c in type(port_err).__mro__[:-3]] == \
        [c.__name__ for c in type(ref_err).__mro__[:-3]]
    assert port_sched.REQUEST_KINDS == ref_sched.REQUEST_KINDS
    assert port_sched.SCORELIKE_KINDS == ref_sched.SCORELIKE_KINDS


# -- recompile auditor -----------------------------------------------------------

def test_abstract_signature_matches_reference_form():
    args = ({"b": np.zeros((2, 3), np.float32), "a": np.zeros((4,), np.int32)}, [1, 2.5])
    want = ref_recompile.abstract_signature(args, {})
    got = port_recompile.abstract_signature(
        ({"b": torch.zeros(2, 3), "a": torch.zeros(4, dtype=torch.int32)}, [1, 2.5]), {})
    # The same leaves in the same order; the tree is spelled by key paths.
    assert got.split(" tree=")[0] == want.split(" tree=")[0]


def test_auditor_counts_signatures_and_arms():
    auditor = port_recompile.RecompileAuditor()
    f = auditor.wrap(lambda x, y=None: x, "f")
    f(torch.zeros(2, 3))
    f(torch.ones(2, 3))
    f(torch.zeros(2, 3), y=1)
    assert auditor.compiles("f") == 2 and auditor.report()["f"]["calls"] == 3
    auditor.arm("f")
    f(torch.ones(2, 3))  # a seen signature runs
    with pytest.raises(port_recompile.RecompileError, match="'f' recompiled"):
        f(torch.zeros(3))
    with pytest.raises(ValueError, match="already wraps"):
        auditor.wrap(lambda: None, "f")
    g = auditor.wrap(lambda state, batch: batch, "g", signature=lambda a, kw: a[1])
    g(object(), torch.zeros(2))
    g(object(), torch.zeros(2))
    assert auditor.compiles("g") == 1


# -- the prefix cache's trie -----------------------------------------------------

def _template(L=16, H=2, D=4):
    return {"pos_index": torch.zeros(1, dtype=torch.int32),
            "layer_0.attention.cached_key": torch.zeros(1, L, H, D),
            "layer_0.attention.cached_value": torch.zeros(1, L, H, D),
            "layer_0.attention.cache_index": torch.zeros(1, dtype=torch.int32)}


def test_prefix_cache_trie_matches_reference_and_places_blocks():
    """The same insert/match/evict sequence gives the same matches and
    statistics in both; a hit's materialized row holds the stored K/V."""
    import jax
    import jax.numpy as jnp

    tmpl = _template()
    ref_tmpl = {"pos_index": jnp.zeros((1,), jnp.int32),
                "layer_0": {"attention": {"cached_key": jnp.zeros((1, 16, 2, 4)),
                                          "cached_value": jnp.zeros((1, 16, 2, 4)),
                                          "cache_index": jnp.zeros((1,), jnp.int32)}}}
    budget = 3 * 4 * 2 * 4 * 4 * 2  # three 4-token blocks of K and V, f32
    port = port_prefix.PrefixCache(tmpl, block_tokens=4, budget_bytes=budget, device="cpu")
    ref = ref_prefix.PrefixCache(ref_tmpl, block_tokens=4, budget_bytes=budget)
    assert port.capacity == ref.capacity == 3
    rng = np.random.default_rng(0)
    row = {k: (torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
               if v.ndim > 1 else v) for k, v in tmpl.items()}
    ref_row = {"pos_index": ref_tmpl["pos_index"], "layer_0": {"attention": {
        "cached_key": jnp.asarray(row["layer_0.attention.cached_key"].numpy()),
        "cached_value": jnp.asarray(row["layer_0.attention.cached_value"].numpy()),
        "cache_index": ref_tmpl["layer_0"]["attention"]["cache_index"]}}}
    a = list(range(13))
    b = [9] * 9
    for tokens in (a, b, a):
        assert port.insert(tokens, row) == ref.insert(tokens, ref_row)
        pm, rm = port.match(tokens), ref.match(tokens)
        assert pm.matched_tokens == rm.matched_tokens
        np.testing.assert_array_equal(pm.ids, rm.ids)
        if pm.matched_tokens:
            got = port.materialize(pm.ids)
            want = ref.materialize(rm.ids)
            n = pm.matched_tokens
            k = got["layer_0.attention.cached_key"]
            np.testing.assert_array_equal(
                k[:, :n].numpy(), np.asarray(want["layer_0"]["attention"]["cached_key"])[:, :n])
            assert (k[:, n:] == 0).all()
            # splice writes the same blocks into a given row, in place.
            dst = {k2: torch.full_like(v, 7.0) if v.ndim > 1 else v for k2, v in tmpl.items()}
            out = port.splice(dst, pm.ids)
            assert out["layer_0.attention.cached_value"] is dst["layer_0.attention.cached_value"]
            ref_dst = jax.tree.map(lambda a: jnp.full_like(a, 7.0) if a.ndim > 1 else a + 0,
                                   ref_tmpl)
            ref_out = ref.splice(ref_dst, rm.ids)
            np.testing.assert_array_equal(
                out["layer_0.attention.cached_value"][:, :n].numpy(),
                np.asarray(ref_out["layer_0"]["attention"]["cached_value"])[:, :n])
            assert (out["layer_0.attention.cached_value"][:, n:] == 7.0).all()
        port.release(pm)
        ref.release(rm)
    assert port.stats() == ref.stats()
    assert port.debugz() == ref.debugz()
