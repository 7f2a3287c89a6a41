"""The host and disk KV tiers (``serving/kv_tier.py``) on the port.

- ``HostKVTier`` units parametrised over both packages: the byte budget,
  the watermark's eviction burst, the inclusive ``get``, ``probe``, disk
  demotion and promotion bitwise, ``flush``.
- The paged engine with a host tier over the bridged ``gpt_tiny`` of
  ``tests/test_torch_serving_engine.py`` (float32, 5 blocks of 4 tokens):
  pool pressure spills a chain into the tier (one batched gather a burst),
  the next request on that prefix readmits it, the readmitted pool rows
  are bitwise the spilled bytes, and the tokens equal the reference's
  ``generate()`` and those of the same engine without a tier, with one
  decode signature under an armed auditor and no preemption; a weight swap
  flushes the tier; the debugz and healthz rows.

Every engine test runs under ``time_limited``.
"""

import asyncio

import numpy as np
import pytest

from distkeras_tpu.serving import kv_tier as ref_tier
from distkeras_tpu_torch.serving import kv_tier as port_tier
from distkeras_tpu_torch.serving.kv_transfer import deserialize_blocks
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from tests.test_torch_serving_engine import _pair, _port, _prompts, _want
from tests.torch_time_limit import time_limited

TIERS = pytest.mark.parametrize("mod", [ref_tier, port_tier], ids=["reference", "port"])


@pytest.fixture(scope="module")
def lm():
    return _pair()


def _pay(n, fill):
    return bytes([fill]) * n


@TIERS
def test_tier_budget_watermark_and_inclusive_get(mod):
    tier = mod.HostKVTier(1000, 4, watermark=0.5)
    keys = [[i, i, i, i] for i in range(5)]
    for i, k in enumerate(keys):
        assert tier.put(k, _pay(200, i))
    assert tier.stats()["host_entries"] == 5
    assert tier.get(keys[0]) == _pay(200, 0)
    assert tier.put([9, 9, 9, 9], _pay(200, 9))
    s = tier.stats()
    assert s["host_bytes"] <= 500
    assert tier.contains([9, 9, 9, 9]) and tier.contains(keys[0])
    assert not tier.contains(keys[1])
    assert s["evictions"] >= 3
    assert tier.get(keys[0]) == _pay(200, 0) and tier.contains(keys[0])
    assert not tier.put([8, 8, 8, 8], _pay(2000, 1))
    t2 = mod.HostKVTier(1000, 2)
    t2.put([1, 2], b"a")
    t2.put([1, 2, 3, 4], b"b")
    assert t2.probe([1, 2, 3, 4, 5, 6]) == 2
    assert t2.probe([7, 8, 3, 4]) == 0


@TIERS
def test_tier_disk_demotion_promotion_bitwise_and_flush(mod, tmp_path):
    tier = mod.HostKVTier(400, 4, disk_dir=str(tmp_path), disk_budget_bytes=1000,
                          watermark=0.5)
    blobs = {i: bytes(np.random.default_rng(i).integers(0, 256, 150, dtype=np.uint8))
             for i in range(4)}
    for i in range(4):
        tier.put([i] * 4, blobs[i])
    s = tier.stats()
    assert s["demotions"] >= 1 and s["disk_entries"] >= 1
    assert list(tmp_path.glob("kvx-*.bin"))
    demoted = [i for i in range(4) if not tier._host.get(tuple([i] * 4))]
    i = demoted[0]
    assert tier.get([i] * 4) == blobs[i]
    assert tier.stats()["promotions"] == 1
    before = tier.stats()
    assert tier.flush() == before["host_entries"] + before["disk_entries"]
    s = tier.stats()
    assert s["host_entries"] == s["disk_entries"] == 0
    assert not list(tmp_path.glob("kvx-*.bin"))
    assert s["demotions"] == before["demotions"] and s["flushes"] == 1


def _tiered(lm, **kw):
    kw.setdefault("slots", 1)
    kw.setdefault("max_queue", 16)
    kw.setdefault("kv_pool_blocks", 5)
    kw.setdefault("kv_block_tokens", 4)
    return _port(lm, **kw)


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


@pytest.mark.parametrize("disk", [False, True], ids=["host", "host+disk"])
@time_limited
def test_spill_readmit_bitwise_token_identical_armed_auditor(lm, disk, tmp_path):
    """Pool pressure evicts a's chain into the tier; the next request on a
    readmits it, its rows bitwise the spilled bytes; the tokens equal the
    reference's ``generate()`` and an engine without a tier, with one
    decode signature and no preemption. With a disk level under a host
    budget of about one block, the spill bursts demote to the disk."""
    a, b = _prompts(70, (11, 11))
    tier_kw = ({"kv_host_tier_mb": 0.0125, "kv_disk_tier_dir": str(tmp_path),
                "kv_disk_tier_mb": 4.0} if disk else {"kv_host_tier_mb": 4.0})
    auditor = RecompileAuditor()
    engine = _tiered(lm, auditor=auditor, arm_auditor_after_warmup=True, **tier_kw)
    plain = _tiered(lm)

    async def drive():
        outs = [await engine.submit(a, 4).result(), await engine.submit(b, 4).result()]
        assert engine.metrics.kv_spills >= 2
        tier = engine.kv_tier
        spilled = {k: tier.get(a[:(k + 1) * 4]) for k in range(2)
                   if tier.contains(a[:(k + 1) * 4])}
        assert spilled, "nothing of a's chain reached the tier"
        outs.append(await engine.submit(a, 4).result())
        assert engine.metrics.kv_readmits >= 1 and engine.kv_pool.hit_tokens >= 4
        assert engine.metrics.preemptions == 0
        res = await _kv_op(engine.request_kv_export, a)
        _, ex_leaves = deserialize_blocks(res["payload"])
        for k, payload in spilled.items():
            _, sp_leaves = deserialize_blocks(payload)
            for sp, ex in zip(sp_leaves, ex_leaves):
                assert sp[0].numpy().tobytes() == ex[k].numpy().tobytes()
        return outs, engine.debugz(), tier.stats()

    async def drive_plain():
        return [await plain.submit(p, 4).result() for p in (a, b, a)]

    outs, dz, stats = asyncio.run(_run(engine, drive()))
    assert outs == [_want(lm, a, 4), _want(lm, b, 4), _want(lm, a, 4)]
    assert outs == asyncio.run(_run(plain, drive_plain()))
    assert auditor.compiles("serving_decode") == 1
    assert auditor.report()["serving_decode"]["armed"]
    assert dz["kv_tier"]["spills"] >= 2 and dz["kv_tier"]["readmits"] >= 1
    if disk:
        assert stats["demotions"] >= 1 and stats["disk_entries"] >= 1


@time_limited
def test_spill_burst_gathers_once(lm):
    """A multi-block admission that evicts several victims spills them
    through ONE batched gather (``spill_many_hook``), not one a block."""
    a, b = _prompts(71, (15, 15))
    engine = _tiered(lm, kv_host_tier_mb=4.0)
    gathers = []
    gather = engine._kv_gather
    engine._kv_gather = lambda rows: gathers.append(len(rows)) or gather(rows)

    async def drive():
        await engine.submit(a, 4).result()
        gathers.clear()
        await engine.submit(b, 4).result()

    asyncio.run(_run(engine, drive()))
    assert engine.metrics.kv_spills >= 2
    assert gathers and max(gathers) >= 2, gathers


@time_limited
def test_tier_flushes_on_weight_swap_and_reports(lm):
    prompt, other = _prompts(72, (11, 11))
    engine = _tiered(lm, kv_host_tier_mb=4.0)
    _, _, _, params = lm

    async def drive():
        await engine.submit(prompt, 4).result()
        await engine.submit(other, 4).result()
        assert engine.kv_tier.stats()["host_entries"] > 0
        event, result = engine.request_param_swap({k: v.clone() for k, v in params.items()})
        await asyncio.wait_for(event.wait(), 30)
        assert "error" not in result
        assert engine.kv_tier.stats()["host_entries"] == 0
        assert engine.kv_tier.stats()["flushes"] == 1
        return await engine.submit(prompt, 4).result()

    assert asyncio.run(_run(engine, drive())) == _want(lm, prompt, 4)
    snap = engine.metrics.registry.snapshot()
    assert any(k.startswith("kv_tier_") for k in snap), sorted(snap)[:20]
