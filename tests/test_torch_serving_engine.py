"""The port's dense ``ServingEngine`` against the reference's.

``gpt_tiny(seq_len=32, vocab_size=64)`` in float32 on both sides: the
reference's weights cross to the port through ``utils/bridge.py``, and the
same prompts go through the reference's ``ServingEngine`` and
``generate()`` and the port's engine, with the submission schedules of the
reference's ``tests/test_serving.py``. In float32 there are no bf16 ties,
so greedy tokens are compared exactly.

- Greedy tokens equal the reference engine's and the reference
  ``generate()``'s under staggered admission through 2 slots, chunked
  prefill, ``pipeline_depth`` 0 and 1, prefix-cache hits (also after an
  evict round trip, with the cache's statistics equal to the reference's),
  and a prompt whose bucket reaches the cache's end.
- Sampled rows: the same seed gives the same tokens, every token is in its
  step's top k, and the greedy rows of a mixed batch are unchanged.
- The reference's typed errors (backpressure, deadlines queued and
  mid-decode, cancel, shutdown drain), its ``_bucket``/``_pow2_fit``, one
  decode signature (an armed auditor raises on a new shape), the keys of
  ``ServingMetrics.summary()`` and of the ``metricsz`` snapshot, and every
  deferred option raising with its ROADMAP item.

Every test runs under ``time_limited``: a stuck engine loop fails its test
instead of hanging the run.
"""

import asyncio
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.serving import engine as ref_engine_mod
from distkeras_tpu.serving import scheduler as ref_sched
from distkeras_tpu.serving.prefix_cache import PrefixCache as RefPrefixCache
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.serving import (
    EngineStopped,
    PrefixCache,
    QueueFullError,
    RequestCancelled,
    RequestTimeout,
    ServingEngine,
)
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor, RecompileError
from distkeras_tpu_torch.utils.bridge import params_from_jax
from tests.torch_time_limit import time_limited

VOCAB = 64
RefEngine = ref_engine_mod.ServingEngine


def _pair(seq_len=32):
    ref = ref_bert.gpt_tiny(seq_len=seq_len, vocab_size=VOCAB)
    ref = ref_bert._make(dataclasses.replace(ref.config, dtype=jnp.float32), seq_len, "gpt_tiny")
    port = port_bert.gpt_tiny(seq_len=seq_len, vocab_size=VOCAB)
    port = port_bert._make(dataclasses.replace(port.config, dtype=torch.float32), seq_len,
                           "gpt_tiny")
    variables = ref.init(0)
    return ref, variables, port, params_from_jax(jax.tree.map(np.asarray, variables),
                                                 device="cpu")


@pytest.fixture(scope="module")
def lm():
    return _pair()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=(n,)).tolist() for n in lengths]


_WANT: dict = {}


def _want(lm, prompt, n):
    """The reference ``generate()``'s greedy tokens (each computed once)."""
    ref, variables = lm[0], lm[1]
    key = (ref.input_shape[0], tuple(prompt), n)
    if key not in _WANT:
        _WANT[key] = np.asarray(ref_generate(ref, variables, np.asarray([prompt], np.int32),
                                             n, greedy=True))[0].tolist()
    return _WANT[key]


def _port(lm, **kw):
    _, _, port, params = lm
    return ServingEngine(port, params, device="cpu", **kw)


def _ref(lm, **kw):
    ref, variables, _, _ = lm
    return RefEngine(ref, variables, **kw)


async def _run_engine(engine, coro):
    """Drive ``engine.run()`` alongside ``coro``; shuts down on exit."""
    task = asyncio.create_task(engine.run())
    try:
        return await coro
    finally:
        engine.shutdown(drain=True)
        await task


def _staggered(engine, prompts, n, stagger=0.01, **submit_kw):
    async def work():
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(engine.submit(p, n, **submit_kw))
            await asyncio.sleep(stagger * i)  # arrive mid-decode
        return [await r.result() for r in reqs]

    return asyncio.run(_run_engine(engine, work()))


def _sequential(engine, prompts, n):
    async def work():
        return [await engine.submit(p, n).result() for p in prompts]

    return asyncio.run(_run_engine(engine, work()))


# -- greedy parity under each schedule -----------------------------------------

SCHEDULE_PROMPTS = (13, 5, 9, 3, 11)


@pytest.mark.parametrize("schedule", [
    {},  # staggered admission through 2 slots, pipeline_depth 1 (default)
    {"pipeline_depth": 0},
    {"prefill_chunk": 4},
])
@time_limited
def test_greedy_tokens_match_reference_engine_and_generate(lm, schedule):
    prompts = _prompts(1, SCHEDULE_PROMPTS)
    port = _port(lm, slots=2, max_queue=8, **schedule)
    got = _staggered(port, prompts, 5)
    ref = _staggered(_ref(lm, slots=2, max_queue=8, **schedule), prompts, 5)
    want = [_want(lm, p, 5) for p in prompts]
    assert ref == want
    assert got == want
    assert port.decode_compile_count() == 1
    assert port.active_slots == 0 and all(s is None for s in port._slot_state)
    if "prefill_chunk" in schedule:
        # 13-token prompt through 4-token chunks = 4 chunks.
        assert port.metrics.summary()["prefill_chunks_max"] == 4.0


@time_limited
def test_prefix_cache_hits_are_exact_vs_monolithic_and_generate(lm):
    """Chunked + prefix-cached admission equals monolithic prefill, the
    reference engine and ``generate()``, and repeat prompts hit; the
    cache's statistics equal the reference's."""
    shared = _prompts(2, (12,))[0]
    prompts = [shared + p for p in _prompts(3, (3, 4, 5, 3))]
    kw = dict(slots=1, max_queue=16, prefill_chunk=4, prefix_cache_mb=1.0,
              prefix_block_tokens=4)
    cached = _port(lm, **kw)
    got = _sequential(cached, prompts, 5)
    plain = _sequential(_port(lm, slots=1, max_queue=16), prompts, 5)
    ref = _ref(lm, **kw)
    ref_got = _sequential(ref, prompts, 5)
    want = [_want(lm, p, 5) for p in prompts]
    assert got == plain == ref_got == want
    stats = cached.prefix_cache.stats()
    assert stats["hit_requests"] >= 3 and stats["hit_tokens"] >= 3 * 12
    ref_stats = ref.prefix_cache.stats()
    for key in ("hit_requests", "hit_tokens", "miss_tokens", "inserted_blocks",
                "blocks_used", "capacity_blocks", "bytes_per_block", "lookups"):
        assert stats[key] == ref_stats[key], key
    assert cached.decode_compile_count() == 1
    assert cached.metrics.summary()["prefix_hit_rate"] > 0.4


@time_limited
def test_prefix_cache_hit_after_evict_round_trip(lm):
    """A cached -> A evicted by B (a 2-block budget) -> A re-prefilled and
    re-cached -> A hits again: the tokens and the cache's statistics equal
    the reference's throughout."""
    a, b = _prompts(4, (11, 11))
    outs, stats = [], []
    for side in ("port", "ref"):
        if side == "port":
            probe = _port(lm, slots=1)
            one = PrefixCache(probe._row_shapes, block_tokens=4, budget_bytes=1 << 20,
                              device="cpu")
            pc = PrefixCache(probe._row_shapes, block_tokens=4,
                             budget_bytes=2 * one.bytes_per_block, device="cpu")
            engine = _port(lm, slots=1, max_queue=16, prefix_cache=pc)
        else:
            probe = _ref(lm, slots=1)
            one = RefPrefixCache(probe._row_shapes, block_tokens=4, budget_bytes=1 << 20)
            pc = RefPrefixCache(probe._row_shapes, block_tokens=4,
                                budget_bytes=2 * one.bytes_per_block)
            engine = _ref(lm, slots=1, max_queue=16, prefix_cache=pc)
        outs.append(_sequential(engine, (a, a, b, a, a), 4))
        stats.append(pc.stats())
    wa, wb = _want(lm, a, 4), _want(lm, b, 4)
    assert outs[0] == outs[1] == [wa, wa, wb, wa, wa]
    assert stats[0]["evicted_blocks"] > 0 and stats[0]["hit_requests"] >= 2
    assert stats[0]["blocks_used"] <= 2
    assert stats[0] == stats[1]


@time_limited
def test_prefill_bucket_never_overshoots_headroom_free_cache():
    """A hit's tail bucket is capped at the remaining cache room, in
    monolithic and chunked admission (reference ``tests/test_serving.py``
    ``test_prefill_bucket_never_overshoots_headroom_free_cache``)."""
    big = _pair(64)
    pre = _prompts(5, (8,))[0]
    first, tail = _prompts(6, (2, 41))
    long_tail = pre + tail  # matched 8 + tail 41 -> bucket 64
    want = _want(big, long_tail, 4)
    for kwargs in ({}, {"prefill_chunk": 48}):
        engine = _port(big, slots=1, max_queue=8, prefix_cache_mb=1.0,
                       prefix_block_tokens=8, **kwargs)
        outs = _sequential(engine, (pre + first, long_tail), 4)
        assert engine.prefix_cache.stats()["hit_tokens"] >= 8
        assert outs[1] == want, f"corrupted hit output with {kwargs}"


# -- sampling --------------------------------------------------------------------

def _nocache_logits(lm, tokens):
    _, _, port, params = lm
    with torch.inference_mode():
        return port.apply(params, torch.tensor([tokens], dtype=torch.int32))[0][0, -1]


@time_limited
def test_sampled_rows_seeded_within_top_k_and_greedy_rows_unchanged(lm):
    p = _prompts(7, (5,))[0]

    def run(seed):
        engine = _port(lm, slots=2, seed=seed, top_k=10)

        async def work():
            greedy = engine.submit(p, 6)
            hot = engine.submit(p, 6, temperature=5.0)
            return await greedy.result(), await hot.result()

        out = asyncio.run(_run_engine(engine, work()))
        assert engine.decode_compile_count() == 1
        return out

    g1, h1 = run(3)
    g2, h2 = run(3)
    _, h3 = run(4)
    assert g1 == g2 == _want(lm, p, 6)  # the greedy row of a mixed batch
    assert h1 == h2  # same seed, same tokens
    assert h1 != h3  # another seed draws differently
    seq = list(p)
    for tok in h1:
        logits = _nocache_logits(lm, seq)
        kth = torch.topk(logits, 10).values[-1]
        assert logits[tok] >= kth
        seq.append(tok)


# -- typed errors ------------------------------------------------------------------

def _same_error(err, ref_cls):
    """``err`` is the port's counterpart of the reference's ``ref_cls``:
    the same class name and the same wire code."""
    assert type(err).__name__ == ref_cls.__name__
    assert err.code == ref_cls("x").code


@time_limited
def test_backpressure_rejects_with_typed_error(lm):
    engine = _port(lm, slots=1, max_queue=2)
    rng = _prompts(8, (3, 3, 3))
    engine.submit(rng[0], 2)
    engine.submit(rng[1], 2)
    with pytest.raises(QueueFullError) as info:
        engine.submit(rng[2], 2)
    _same_error(info.value, ref_sched.QueueFullError)
    assert engine.metrics.rejected == 1


@time_limited
def test_deadlines_queued_and_mid_decode(lm):
    p1, p2, p3 = _prompts(9, (4, 4, 4))
    engine = _port(lm, slots=1, max_queue=4)

    async def queued():
        long_req = engine.submit(p1, 10)
        doomed = engine.submit(p2, 2, timeout=0.0)
        out = await long_req.result()
        with pytest.raises(RequestTimeout) as info:
            await doomed.result()
        _same_error(info.value, ref_sched.RequestTimeout)
        return out

    assert asyncio.run(_run_engine(engine, queued())) == _want(lm, p1, 10)
    assert engine.metrics.expired == 1

    engine = _port(lm, slots=1)

    async def mid_decode():
        req = engine.submit(p3, 28)
        kind, _ = await req.events.get()
        assert kind == "token"
        req.timeout = -1.0  # the deadline is now in the past
        with pytest.raises(RequestTimeout) as info:
            await req.result()
        _same_error(info.value, ref_sched.RequestTimeout)
        return req

    req = asyncio.run(_run_engine(engine, mid_decode()))
    assert 1 <= len(req.out_tokens) < 28
    assert engine.active_slots == 0


@time_limited
def test_cancel_frees_slot_mid_decode_and_in_queue(lm):
    holder_p, waiting_p, doomed_p = _prompts(10, (4, 5, 3))
    engine = _port(lm, slots=1, max_queue=4)

    async def work():
        holder = engine.submit(holder_p, 28)
        kind, _ = await holder.events.get()
        assert kind == "token"  # holder owns the slot
        waiting = engine.submit(waiting_p, 3)
        doomed = engine.submit(doomed_p, 3)
        holder.cancel()
        doomed.cancel()
        out = await waiting.result()  # takes over the freed slot
        for req in (holder, doomed):
            with pytest.raises(RequestCancelled) as info:
                await req.result()
            _same_error(info.value, ref_sched.RequestCancelled)
        return out

    assert asyncio.run(_run_engine(engine, work())) == _want(lm, waiting_p, 3)
    assert engine.active_slots == 0


@time_limited
def test_graceful_shutdown_drains_active_rejects_queued(lm):
    p1, p2, p3 = _prompts(11, (4, 4, 3))
    engine = _port(lm, slots=1, max_queue=4)

    async def go():
        task = asyncio.create_task(engine.run())
        active = engine.submit(p1, 8)
        kind, _ = await active.events.get()
        assert kind == "token"
        queued = engine.submit(p2, 4)
        engine.shutdown(drain=True)
        with pytest.raises(EngineStopped) as info:
            engine.submit(p3, 2)  # late arrival: typed reject
        _same_error(info.value, ref_sched.EngineStopped)
        out = await active.result()  # drained to completion
        with pytest.raises(EngineStopped):
            await queued.result()  # queued work is shed
        await task
        return out

    assert asyncio.run(go()) == _want(lm, p1, 8)
    assert engine.active_slots == 0


# -- bucketing, signatures, metrics -----------------------------------------------

def test_bucket_and_pow2_fit_match_reference():
    for room in range(1, 70):
        for P in (1, 2, 3, 8, 16, 31, 32, 48, 64, 128):
            assert ServingEngine._pow2_fit(P, room) == RefEngine._pow2_fit(P, room)
    for mb in (1, 4, 8):
        for limit in (7, 32, 64):
            me = types.SimpleNamespace(_min_bucket=mb, limit=limit)
            for n in range(1, 70):
                for cap in (None, 4, 48):
                    assert (ServingEngine._bucket(me, n, cap)
                            == RefEngine._bucket(me, n, cap)), (mb, limit, n, cap)


@time_limited
def test_armed_auditor_holds_one_decode_signature(lm):
    prompts = _prompts(12, (5, 9, 3, 7, 4))
    auditor = RecompileAuditor()
    engine = _port(lm, slots=2, max_queue=8, auditor=auditor,
                   arm_auditor_after_warmup=True)
    outs = _staggered(engine, prompts, 6)
    assert outs == [_want(lm, p, 6) for p in prompts]
    report = auditor.report()
    assert auditor.compiles("serving_decode") == 1 == engine.decode_compile_count()
    assert report["serving_decode"]["armed"]
    assert auditor.compiles("serving_admit") == 1
    assert report["serving_admit"]["calls"] == len(prompts)
    # A new shape into the armed decode step raises before it runs.
    with pytest.raises(RecompileError, match="serving_decode"):
        engine._decode_step(engine._params, engine._cache,
                            torch.zeros(3, dtype=torch.int32), engine._temps)


def _workload(engine, prompts):
    async def work():
        reqs = [engine.submit(p, 4) for p in prompts]
        return [await r.result() for r in reqs]

    asyncio.run(_run_engine(engine, work()))
    # What the metricsz verb does before it scrapes.
    engine.refresh_memory_metrics()
    engine.tenant_snapshot()
    return engine.metrics


@time_limited
def test_metrics_summary_and_metricsz_keys_match_reference(lm):
    prompts = _prompts(13, (3, 5, 4))
    port = _workload(_port(lm, slots=2), prompts)
    ref = _workload(_ref(lm, slots=2), prompts)
    s, rs = port.emit_summary(), ref.emit_summary()
    assert set(s) == set(rs)
    assert s["requests_completed"] == rs["requests_completed"] == 3
    assert s["tokens_out"] == rs["tokens_out"] == 12
    for key in ("ttft_p50_s", "ttft_p99_s", "inter_token_p50_s", "tokens_per_sec",
                "slot_occupancy_mean", "host_gap_mean_s", "device_idle_ratio"):
        assert key in s, key
    snap, ref_snap = port.registry.snapshot(), ref.registry.snapshot()
    # The same series by name (the reference's test process sees 8 virtual
    # CPU devices, so its device-labelled memory series number 8).
    assert {k.split("{")[0] for k in snap} == {k.split("{")[0] for k in ref_snap}
    for key in ("serving_requests_completed_total", "serving_tokens_out_total",
                "scheduler_submitted_total"):
        assert snap[key]["value"] == ref_snap[key]["value"], key
    assert snap["serving_ttft_seconds"]["count"] == 3


# -- options of later slices ------------------------------------------------------

@pytest.mark.parametrize("kw,exc,item", [
    ({"mesh": object()}, TypeError, "serving_mesh"),
    ({"pipeline_depth": 2}, ValueError, "needs a pp>=2"),
])
def test_deferred_options_raise_naming_item(lm, kw, exc, item):
    """A serving mesh and ``pipeline_depth > 1`` are ported
    (``tests/test_torch_sharded_serving.py``, ``tests/test_torch_pp_serving.py``);
    what is not a mesh, and depth 2 on one device, stay typed errors, the
    latter with the reference's message."""
    with pytest.raises(exc, match=item) as port_info:
        _port(lm, **kw)
    if "pipeline_depth" in kw:
        with pytest.raises(ValueError) as ref_info:
            _ref(lm, **kw)
        assert str(port_info.value) == str(ref_info.value)


@pytest.mark.parametrize("call", [
    lambda e: e.request_kv_export([1, 2]),
    lambda e: e.request_kv_import(b""),
], ids=["export", "import"])
def test_deferred_engine_methods_raise_naming_item(lm, call):
    """KV export and import are ported; a dense engine, which keeps no
    blocks, refuses them with the reference's typed ``KVTransferError``
    naming the paged engine it needs."""
    from distkeras_tpu.serving.kv_transfer import KVTransferError as RefKVTransferError
    from distkeras_tpu_torch.serving.kv_transfer import KVTransferError

    with pytest.raises(KVTransferError, match="paged engine") as port_info:
        call(_port(lm, slots=1))
    with pytest.raises(RefKVTransferError) as ref_info:
        call(_ref(lm, slots=1))
    assert str(port_info.value) == str(ref_info.value)
    assert port_info.value.code == ref_info.value.code == "kv_transfer"


@pytest.mark.parametrize("kw", [{"kind": "score"}, {"kind": "embed"},
                                {"kind": "sample", "n": 2}])
def test_request_kinds_raise_the_reference_error(lm, kw):
    """The reference's own refusal on a dense engine (``engine.py:2587``)."""
    with pytest.raises(ValueError) as port_info:
        _port(lm, slots=2).submit([1, 2, 3], 0 if kw["kind"] != "sample" else 2, **kw)
    assert "requires a paged single-stage engine" in str(port_info.value)
