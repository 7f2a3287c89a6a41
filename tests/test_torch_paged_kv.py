"""Paged KV on the port against the reference.

- ``ops/attention.py`` ``paged_kv_update`` and ``paged_attention`` against
  the reference's on seeded numpy pools and tables, with unallocated
  (sentinel) ids and writes past a row's table, which both drop (1e-6).
- ``KVBlockPool``: the reference's unit cases run against both packages,
  and one op sequence (alloc, match, adopt, free, fork, flush, eviction)
  leaves the two pools in equal states.
- The paged decode mode of ``models/bert.py`` on bridged weights: logits
  and pools after a chunked prefill and one-token steps equal the
  reference's ``Bert(decode=True, paged_blocks=...)`` (float32).
- The paged ``ServingEngine``: greedy tokens equal the reference paged
  engine's, the port's dense engine's and ``generate()``'s under the
  schedules of ``tests/test_torch_serving_engine.py`` (staggered
  admission, ``pipeline_depth`` 0, chunked prefill), zero-copy prefix
  hits, an evict round trip, preempt-and-requeue, a parked oversubscribed
  queue and context past a dense engine's padded maximum, with an armed
  auditor seeing one decode signature; the pool's statistics equal the
  reference's; ``kv_oom`` is typed; the gauges and ``debugz`` publish.

``gpt_tiny(seq_len=32, vocab_size=64)`` in float32 on both sides, as the
dense engine's tests. In float32 there are no bf16 ties, so greedy tokens
are compared exactly. The paged pool is zero-copy where the dense prefix
cache copies with zeros past a match, so pool bytes are compared only
where a row wrote them.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.inference.generate import _decode_module as ref_decode_module
from distkeras_tpu.ops import attention as ref_attn
from distkeras_tpu.serving import prefix_cache as ref_prefix
from distkeras_tpu_torch.inference.generate import _decode_module as port_decode_module
from distkeras_tpu_torch.models.bert import decode_cache
from distkeras_tpu_torch.ops import attention as port_attn
from distkeras_tpu_torch.serving import PoolExhausted, ServingMetrics
from distkeras_tpu_torch.serving import prefix_cache as port_prefix
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from distkeras_tpu_torch.telemetry.request_trace import TraceStore
from distkeras_tpu_torch.utils.bridge import cache_from_jax
from tests.test_torch_serving_engine import (
    _pair,
    _port,
    _prompts,
    _ref,
    _run_engine,
    _sequential,
    _staggered,
    _want,
)
from tests.torch_time_limit import time_limited

POOLS = pytest.mark.parametrize("mod", [ref_prefix, port_prefix], ids=["reference", "port"])


@pytest.fixture(scope="module")
def lm():
    return _pair()


# -- the paged ops ---------------------------------------------------------------

OP_CASES = [
    # (C, bt, B, S, T, tables, positions)
    (6, 4, 3, 5, 3, [[0, 2, 6], [1, 6, 6], [6, 6, 6]], [2, 3, 0]),  # sentinels
    (8, 4, 2, 1, 2, [[3, 5], [7, 8]], [5, 6]),                      # one-token decode
    (5, 2, 2, 4, 3, [[0, 1, 2], [3, 4, 9]], [3, 2]),                # past the table, id > C
    (4, 4, 1, 8, 2, [[2, 0]], [0]),                                 # a prefill window
    (3, 4, 2, 3, 1, [[3, 3], [3, 3]], [1, 2]),                      # nothing lands
]


@pytest.mark.parametrize("case", range(len(OP_CASES)))
def test_paged_ops_match_reference(case):
    C, bt, B, S, T, tables, positions = OP_CASES[case]
    tables = np.asarray(tables, np.int32)[:, :T]
    positions = np.asarray(positions, np.int32)
    rng = np.random.default_rng(case)
    H, D = 2, 8
    pool = rng.standard_normal((C, bt, H, D)).astype(np.float32)
    new = rng.standard_normal((B, S, H, D)).astype(np.float32)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    want = np.asarray(ref_attn.paged_kv_update(jnp.asarray(pool), jnp.asarray(new),
                                               jnp.asarray(tables), jnp.asarray(positions), bt))
    got = port_attn.paged_kv_update(torch.tensor(pool), torch.tensor(new),
                                    torch.tensor(tables), torch.tensor(positions), bt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want_o = np.asarray(ref_attn.paged_attention(jnp.asarray(q), jnp.asarray(want),
                                                 jnp.asarray(want), jnp.asarray(tables),
                                                 jnp.asarray(positions)))
    got_o = port_attn.paged_attention(torch.tensor(q), got, got, torch.tensor(tables),
                                      torch.tensor(positions))
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=0, atol=1e-6)


def test_paged_kv_update_writes_in_place_and_drops_out_of_range():
    pool = torch.zeros(2, 2, 1, 1)
    new = torch.ones(1, 4, 1, 1)
    out = port_attn.paged_kv_update(pool, new, torch.tensor([[1, 2]]), torch.tensor([1]), 2)
    assert out is pool
    # Position 1 (block 0 -> row 1, offset 1) lands; positions 2 and 3 go
    # through id 2 (unallocated) and 4 is past the table: all three drop.
    assert pool[1, 1].item() == 1.0 and pool.sum().item() == 1.0


# -- KVBlockPool -------------------------------------------------------------------

@POOLS
def test_block_pool_alloc_is_all_or_nothing(mod):
    pool = mod.KVBlockPool(4, 2)
    a = pool.alloc(3)
    assert len(a) == 3 and pool.blocks_free == 1
    assert pool.alloc(2) is None and pool.blocks_free == 1  # nothing taken
    pool.free(a)
    assert pool.blocks_free == 4


@POOLS
def test_block_pool_adopt_then_match_zero_copy(mod):
    pool = mod.KVBlockPool(8, 2)
    ids = pool.alloc(3)
    tokens = [1, 2, 3, 4, 5, 6, 7]
    assert pool.adopt(tokens, ids, 0) == 3
    m = pool.match(tokens + [9])
    assert list(m.ids) == ids and m.matched_tokens == 6  # the same rows, no copy
    pool.release(m)
    dup = pool.alloc(1)
    assert pool.adopt([1, 2], dup, 0) == 0 and pool.blocks_free == 5  # duplicate freed


@POOLS
def test_block_pool_version_moves_on_free_and_adopt(mod):
    pool = mod.KVBlockPool(4, 2)
    v0 = pool.version
    ids = pool.alloc(2)
    assert pool.version == v0  # alloc takes, never frees
    pool.free(ids[:1])
    v1 = pool.version
    assert v1 > v0
    pool.adopt([1, 2], ids[1:], 0)
    assert pool.version > v1


@POOLS
def test_block_pool_spill_many_batches_the_eviction_burst(mod):
    pool = mod.KVBlockPool(4, 2)
    pool.adopt([1, 2, 3, 4, 5, 6, 7, 8], pool.alloc(4), 0)
    bursts = []
    pool.spill_many_hook = bursts.append
    assert len(pool.alloc(3)) == 3
    assert len(bursts) == 1 and len(bursts[0]) == 3  # one call for the burst
    chains = sorted(len(chain) for chain, _ in bursts[0])
    assert chains == [4, 6, 8]  # leaves first: each victim's full chain


@POOLS
def test_block_pool_spill_burst_flushes_even_on_shortfall(mod):
    pool = mod.KVBlockPool(3, 2)
    pool.adopt([1, 2, 3, 4], pool.alloc(2), 0)
    bursts = []
    pool.spill_many_hook = bursts.append
    assert pool.alloc(4) is None
    assert len(bursts) == 1 and len(bursts[0]) == 2


def _pool_state(pool) -> dict:
    stats = pool.stats()
    nodes = sorted((slot, tuple(pool._chain_tokens(n)), n.refs)
                   for slot, n in pool._by_slot.items())
    return {"stats": stats, "free": sorted(pool._free), "nodes": nodes,
            "fork_refs": dict(pool._fork_refs), "version": pool.version,
            "used": pool.blocks_used}


def test_block_pool_op_sequence_leaves_equal_states():
    """One op sequence (alloc, adopt, match/release, free, fork with a CoW
    copy, eviction under pressure, flush) on both packages' pools."""
    states = []
    for mod in (ref_prefix, port_prefix):
        pool = mod.KVBlockPool(10, 4, bytes_per_block=64)
        a = pool.alloc(3)
        pool.adopt(list(range(12)), a, 0)
        m = pool.match(list(range(12)) + [50])
        b = pool.alloc(2)
        pool.adopt(list(range(8)) + [90, 91, 92, 93, 94, 95, 96, 97], m.ids[:2].tolist() + b, 2)
        pool.release(m)
        c = pool.alloc(4)
        pool.fork(c[:2], 3)
        pool.note_cow_copy(2)
        pool.free(c[:2])
        pool.free(c)
        d = pool.alloc(7)  # evicts LRU trie leaves
        e = pool.alloc(5)  # short: all or nothing
        snap = _pool_state(pool)
        snap["d"], snap["e"] = sorted(d), e
        pool.free(d)
        pool.flush()
        snap["after_flush"] = _pool_state(pool)
        states.append(snap)
    assert states[0] == states[1]


def test_block_pool_gauges_publish():
    metrics = ServingMetrics()
    pool = port_prefix.KVBlockPool(8, 4, bytes_per_block=32, registry=metrics.registry)
    pool.alloc(3)
    snap = metrics.registry.snapshot()
    assert snap["kv_pool_blocks_total"]["value"] == 8
    assert snap["kv_pool_blocks_used"]["value"] == 3
    assert snap["kv_pool_blocks_free"]["value"] == 5


# -- the paged decode module -------------------------------------------------------

@pytest.mark.parametrize("page_tokens", [4, 5])
def test_paged_decode_module_matches_reference(lm, page_tokens):
    ref, variables, port, params = lm
    C, T = 16, -(-32 // page_tokens)
    geometry = dict(paged_blocks=C, page_tokens=page_tokens, page_table_blocks=T)
    ref_mod, _ = ref_decode_module(ref, slots=True, **geometry)
    port_mod, cfg = port_decode_module(port, slots=True, **geometry)
    rng = np.random.default_rng(11)
    tables = np.full((2, T), C, np.int32)
    tables[0, :4] = [3, 0, 7, 9]
    tables[1, :3] = [1, 2, 12]
    ref_cache = jax.tree.map(jnp.zeros_like, ref_mod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1), jnp.int32), train=False)["cache"])
    port_cache = decode_cache(cfg, 2, "cpu")
    positions = np.zeros((2,), np.int32)
    for S in (6, 3, 1, 1, 1):  # a prefill, a chunk, one-token steps
        tokens = rng.integers(0, 64, size=(2, S)).astype(np.int32)
        want, mut = ref_mod.apply({"params": variables["params"], "cache": ref_cache},
                                  jnp.asarray(tokens), train=False, mutable=["cache"],
                                  positions=jnp.asarray(positions),
                                  block_tables=jnp.asarray(tables))
        ref_cache = mut["cache"]
        got, port_cache = port_mod.apply(
            {**params, **port_cache}, torch.from_numpy(tokens),
            positions=torch.from_numpy(positions), block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        positions = positions + S
    theirs = cache_from_jax({"cache": ref_cache}, device="cpu")
    assert set(theirs) == set(port_cache)
    # Compare the rows the two sequences wrote (positions [0, 11)).
    for name, leaf in port_cache.items():
        for b in range(2):
            for p in range(int(positions[b])):
                row, off = tables[b, p // page_tokens], p % page_tokens
                np.testing.assert_allclose(leaf[row, off].numpy(),
                                           theirs[name][row, off].numpy(), atol=1e-5)


def test_paged_decode_needs_positions_and_tables(lm):
    _, _, port, params = lm
    dec, cfg = port_decode_module(port, slots=True, paged_blocks=4, page_tokens=4,
                                  page_table_blocks=8)
    with pytest.raises(ValueError, match="positions"):
        dec.apply({**params, **decode_cache(cfg, 1, "cpu")}, torch.zeros(1, 2, dtype=torch.int32))


# -- the paged engine -------------------------------------------------------------

SCHEDULE_PROMPTS = (13, 5, 9, 3, 11)


@pytest.mark.parametrize("schedule", [
    {},  # staggered admission through 2 slots, pipeline_depth 1 (default)
    {"pipeline_depth": 0},
    {"prefill_chunk": 4},
])
@time_limited
def test_paged_greedy_matches_reference_dense_and_generate(lm, schedule):
    prompts = _prompts(1, SCHEDULE_PROMPTS)
    auditor = RecompileAuditor()
    kw = dict(slots=2, max_queue=8, kv_pool_blocks=64, kv_block_tokens=4, **schedule)
    paged = _port(lm, auditor=auditor, arm_auditor_after_warmup=True, **kw)
    got = _staggered(paged, prompts, 5)
    ref = _staggered(_ref(lm, **kw), prompts, 5)
    dense = _staggered(_port(lm, slots=2, max_queue=8, **schedule), prompts, 5)
    want = [_want(lm, p, 5) for p in prompts]
    assert ref == want
    assert dense == want
    assert got == want
    assert auditor.compiles("serving_decode") == 1
    assert auditor.report()["serving_decode"]["armed"]
    assert paged.decode_compile_count() == 1
    assert paged.active_slots == 0
    assert all((t == paged._sentinel).all() for t in paged._tables)


@time_limited
def test_paged_prefix_hits_are_zero_copy_and_stats_equal_reference(lm):
    shared = _prompts(2, (12,))[0]
    prompts = [shared + p for p in _prompts(3, (3, 4, 5, 3))]
    kw = dict(slots=1, max_queue=16, kv_pool_blocks=32, kv_block_tokens=4, prefill_chunk=4)
    port = _port(lm, **kw)
    got = _sequential(port, prompts, 5)
    ref = _ref(lm, **kw)
    ref_got = _sequential(ref, prompts, 5)
    assert got == ref_got == [_want(lm, p, 5) for p in prompts]
    stats, ref_stats = port.kv_pool.stats(), ref.kv_pool.stats()
    assert stats["hit_requests"] >= 3 and stats["hit_tokens"] >= 3 * 12
    assert stats["inserted_blocks"] > 0  # entered by adoption: no store copy
    assert stats == ref_stats
    assert port.decode_compile_count() == 1


@time_limited
def test_paged_hit_after_evict_round_trip(lm):
    a, b = _prompts(4, (11, 11))
    kw = dict(slots=1, max_queue=16, kv_pool_blocks=5, kv_block_tokens=4)
    port, ref = _port(lm, **kw), _ref(lm, **kw)
    outs = _sequential(port, (a, a, b, a, a), 4)
    ref_outs = _sequential(ref, (a, a, b, a, a), 4)
    wa, wb = _want(lm, a, 4), _want(lm, b, 4)
    assert outs == ref_outs == [wa, wa, wb, wa, wa]
    s = port.kv_pool.stats()
    assert s["evicted_blocks"] > 0 and s["hit_requests"] >= 2
    assert s == ref.kv_pool.stats()


def _concurrent(engine, prompts, n):
    async def work():
        reqs = [engine.submit(p, n) for p in prompts]
        return [await r.result() for r in reqs]

    return asyncio.run(_run_engine(engine, work()))


@time_limited
def test_preempt_and_requeue_completes_token_identical(lm):
    """4 slots x (12-token prompt + 10 new) in 13 blocks of 4 tokens:
    growth must preempt; every request still equals the roomy engine's,
    the reference's and generate()'s, and the preempted request's
    timeline shows the preemption between two admissions."""
    prompts = _prompts(12, (12, 12, 12, 12))
    auditor = RecompileAuditor()
    store = TraceStore()
    tight = _port(lm, slots=4, max_queue=16, kv_pool_blocks=13, kv_block_tokens=4,
                  trace_store=store, auditor=auditor, arm_auditor_after_warmup=True)
    got = _concurrent(tight, prompts, 10)
    ref = _ref(lm, slots=4, max_queue=16, kv_pool_blocks=13, kv_block_tokens=4)
    ref_got = _concurrent(ref, prompts, 10)
    roomy = _concurrent(_port(lm, slots=4, max_queue=16, kv_pool_blocks=64,
                              kv_block_tokens=4), prompts, 10)
    want = [_want(lm, p, 10) for p in prompts]
    assert got == ref_got == roomy == want
    assert tight.metrics.preemptions > 0
    assert tight.metrics.preemptions == ref.metrics.preemptions
    assert auditor.compiles("serving_decode") == 1
    preempted = [rec for rec in store.recent(10)
                 if any(e[0] == "preempt" for e in rec["events"])]
    assert preempted
    for rec in preempted:
        names = [e[0] for e in rec["events"]]
        assert names.count("admit") >= 2, names
        assert names.index("admit") < names.index("preempt")


@time_limited
def test_oversubscribed_sequential_load_never_wedges(lm):
    prompts = _prompts(13, (9,) * 6)
    engine = _port(lm, slots=2, max_queue=32, kv_pool_blocks=7, kv_block_tokens=4)
    assert _concurrent(engine, prompts, 6) == [_want(lm, p, 6) for p in prompts]
    assert engine.kv_pool.blocks_used <= 7


@time_limited
def test_paged_serves_context_beyond_dense_padded_max(lm):
    long_prompt = _prompts(14, (20,))[0]
    dense = _port(lm, slots=2, max_context=16)
    with pytest.raises(ValueError, match="context cap"):
        dense.submit(long_prompt, 6)
    paged = _port(lm, slots=2, kv_pool_blocks=8, kv_block_tokens=4)
    assert _sequential(paged, [long_prompt], 6) == [_want(lm, long_prompt, 6)]


@time_limited
def test_paged_prefill_bucket_never_overshoots_trained_context():
    """A block size that does not divide the context (12 into 64): a hit
    near the limit must not let the tail chunk's pad width pass the
    positional table."""
    big = _pair(64)
    prompt = _prompts(15, (61,))[0]
    engine = _port(big, slots=1, max_queue=8, kv_pool_blocks=16, kv_block_tokens=12)
    want = _want(big, prompt, 3)
    assert _sequential(engine, [prompt, prompt], 3) == [want, want]
    assert engine.kv_pool.stats()["hit_tokens"] >= 60


def test_pool_exhausted_is_typed_and_counted(lm):
    engine = _port(lm, slots=1, kv_pool_blocks=3, kv_block_tokens=4)
    with pytest.raises(PoolExhausted) as info:
        engine.submit(_prompts(16, (10,))[0], 8)  # 17 resident > 12 poolable
    assert info.value.code == "kv_oom"
    assert engine.metrics.oom_rejections == 1


@time_limited
def test_pool_gauges_counters_and_debugz_block_depth(lm):
    metrics = ServingMetrics()
    engine = _port(lm, slots=2, max_queue=8, kv_pool_blocks=16, kv_block_tokens=4,
                   metrics=metrics)
    seen = {}

    async def drive():
        req = engine.submit(_prompts(17, (9,))[0], 8)
        async for _ in req.tokens():
            seen.setdefault("dz", engine.debugz())
        return req

    asyncio.run(_run_engine(engine, drive()))
    snap = metrics.registry.snapshot()
    assert snap["kv_pool_blocks_total"]["value"] == 16
    assert snap["kv_pool_blocks_used"]["value"] + snap["kv_pool_blocks_free"]["value"] == 16
    assert snap["kv_preemptions_total"]["kind"] == "counter"
    assert snap["kv_oom_rejections_total"]["kind"] == "counter"
    busy = [s for s in seen["dz"]["slots"] if s["state"] != "free"]
    assert busy and busy[0]["blocks"] >= 3 and "shared_blocks" in busy[0]
    kp = seen["dz"]["kv_pool"]
    assert kp["capacity_blocks"] == 16 and kp["blocks_free"] < 16
