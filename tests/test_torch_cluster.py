"""The port's serving fleet (``serving/cluster``) against the reference.

In-process replicas (``LocalReplica``: one port engine and server each, on
ephemeral ports, all on one event loop) over the bridged
``gpt_tiny(seq_len=32, vocab_size=64)`` of ``tests/test_torch_serving_engine.py``
in float32, so greedy tokens are compared exactly with the reference's
``generate()``:

- two replicas behind the ``Router``: tokens equal ``generate()``'s, and
  healthz/metricsz aggregate the fleet; affinity pins a prompt family;
- a replica killed mid-wave: every zero-streamed request is retried on the
  survivor, only mid-stream losses end typed, and the supervisor restarts
  the replica, which rejoins;
- a rolling reload under load (a weight file of seed-1 weights): no client
  error, completions land during the roll, tokens after it equal
  ``generate()`` on the new weights, one decode signature per replica
  under an armed auditor;
- the disaggregated fleet (``roles`` prefill=1, decode=1) under armed
  auditors: tokens equal ``generate()``'s and every request migrated;
  an unreachable pull target falls back with zero client errors;
- the echo-fleet handoff and fallback, parametrised over both packages;
- a ``ProcessReplica`` child (``-m distkeras_tpu_torch.run serve --device
  cpu``) serves one stream.

Every test runs under ``time_limited``.
"""

import asyncio
import json
import time

import jax
import numpy as np
import pytest

from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu.serving.cluster import replicas as ref_replicas
from distkeras_tpu_torch.checkpoint import save_weights_file, weights_provenance
from distkeras_tpu_torch.serving import (
    LocalReplica,
    ServingClient,
    ServingCluster,
    ServingEngine,
    ServingServer,
)
from distkeras_tpu_torch.serving import wire as port_wire
from distkeras_tpu_torch.serving.client import ServerError
from distkeras_tpu_torch.serving.cluster import replicas as port_replicas
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from distkeras_tpu_torch.telemetry.registry import MetricsRegistry
from tests.test_torch_serving_engine import VOCAB, _pair, _prompts, _want
from tests.torch_time_limit import time_limited

# Fast-failure supervisor settings: probe often, restart fast.
SUP = dict(health_interval_s=0.05, health_timeout_s=2.0, fail_after=2,
           base_delay_s=0.05, max_delay_s=1.0, stable_after_s=0.5)


@pytest.fixture(scope="module")
def lm():
    return _pair()


def _factory(lm, engines=None, audit=False, auditors=None, **engine_kw):
    """Replica factory over the bridged port weights; ``engines`` collects
    the live engines by replica index; ``audit`` gives each engine its own
    auditor armed after warm-up."""
    _, _, port, params = lm

    def make(i):
        def build():
            kw = dict(engine_kw)
            if audit:
                aud = RecompileAuditor()
                if auditors is not None:
                    auditors[i] = aud
                kw.update(auditor=aud, arm_auditor_after_warmup=True)
            kw.setdefault("slots", 2)
            kw.setdefault("max_queue", 16)
            eng = ServingEngine(port, params, device="cpu", **kw)
            if engines is not None:
                engines[i] = eng
            return eng

        return LocalReplica(build)

    return make


async def _wait_until(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


@time_limited
def test_router_parity_and_fleet_aggregation(lm):
    prompts = _prompts(40, (5, 9, 3, 7))

    async def go():
        cluster = ServingCluster(_factory(lm), 2, supervisor_kwargs=SUP,
                                 registry=MetricsRegistry())
        async with cluster:
            async def one(p, wire_mode):
                async with ServingClient("127.0.0.1", cluster.port, wire_mode=wire_mode) as c:
                    return (await c.generate(p, 6))["tokens"]

            outs = await asyncio.gather(*(one(p, "bin1" if k % 2 else "jsonl")
                                          for k, p in enumerate(prompts)))
            async with ServingClient("127.0.0.1", cluster.port) as c:
                health = await c.healthz()
                metrics = await c.metricsz()
        return outs, health, metrics

    outs, health, metrics = asyncio.run(go())
    for p, got in zip(prompts, outs):
        assert got == _want(lm, p, 6)
    assert health["router"]["replicas_ready"] == 2
    assert health["router"]["outstanding_total"] == 0
    assert set(health["replicas"]) == {"r0", "r1"}
    for entry in health["replicas"].values():
        assert entry["healthz"]["slots"] == 2
        assert entry["healthz"]["device_memory"][0]["available"] is False
    done = sum(snap["serving_requests_completed_total"]["value"]
               for snap in metrics["replicas"].values())
    assert done == len(prompts)
    assert metrics["router"]["router_requests_total"]["value"] == len(prompts)


@time_limited
def test_affinity_pins_prompt_family_to_one_replica(lm):
    family = _prompts(41, (16,))[0]
    tails = _prompts(42, (2,) * 6)

    async def go():
        cluster = ServingCluster(_factory(lm), 2, supervisor_kwargs=SUP,
                                 router_kwargs={"affinity_tokens": 16},
                                 registry=MetricsRegistry())
        async with cluster:
            async with ServingClient("127.0.0.1", cluster.port) as c:
                for t in tails:
                    await c.generate(family + t, 4)
                return await c.metricsz()

    metrics = asyncio.run(go())
    completed = sorted(snap["serving_requests_completed_total"]["value"]
                       for snap in metrics["replicas"].values())
    assert completed == [0.0, 6.0]
    assert metrics["router"]["router_affinity_picks_total"]["value"] == 6


@time_limited(timeout=180)
def test_replica_death_retries_zero_streamed_and_restarts(lm):
    prompts = [_prompts(43 + i, (4 + i % 5,))[0] for i in range(12)]
    post_prompts = _prompts(60, (3, 5, 6, 4, 7, 8))

    async def go():
        cluster = ServingCluster(_factory(lm), 2, supervisor_kwargs=SUP,
                                 registry=MetricsRegistry())
        results, failures = {}, {}
        async with cluster:
            async def client_task(idx, p):
                streamed = []
                c = ServingClient("127.0.0.1", cluster.port)
                try:
                    done = await c.generate(p, 8, on_token=streamed.append)
                    results[idx] = done["tokens"]
                except (ServerError, ConnectionError) as e:
                    failures[idx] = (str(e), len(streamed))
                finally:
                    await c.aclose()

            tasks = [asyncio.create_task(client_task(i, p)) for i, p in enumerate(prompts)]
            await _wait_until(lambda: len(results) >= 2, what="first done")
            await cluster.replicas["r0"].handle.kill()
            await asyncio.gather(*tasks)
            await _wait_until(lambda: cluster.replicas["r0"].restarts >= 1,
                              what="supervisor restart of r0")
            await _wait_until(lambda: cluster.supervisor.ready_count == 2,
                              what="replica rejoin")
            async with ServingClient("127.0.0.1", cluster.port) as c:
                post = [(p, (await c.generate(p, 4))["tokens"]) for p in post_prompts]
        return results, failures, post

    results, failures, post = asyncio.run(go())
    for idx, (msg, streamed) in failures.items():
        assert streamed >= 1, f"request {idx} failed with zero tokens streamed: {msg}"
        # The router's replica_lost, or the killed replica's own engine-
        # failure line flushed before its connection dropped.
        assert "replica" in msg or "engine failure" in msg, msg
    assert len(results) + len(failures) == len(prompts)
    for idx, got in results.items():
        assert got == _want(lm, prompts[idx], 8)
    for p, got in post:
        assert got == _want(lm, p, 4)


@time_limited(timeout=240)
def test_rolling_reload_under_load_zero_downtime(lm, tmp_path):
    ref, _, _, _ = lm
    new_vars = jax.tree.map(np.asarray, ref.init(1))
    path = str(tmp_path / "seed1.npz")
    save_weights_file(path, new_vars)
    pool = _prompts(61, (4, 6, 5, 7))
    want_old = {tuple(p): _want(lm, p, 5) for p in pool}
    want_new = {tuple(p): np.asarray(ref_generate(ref, new_vars, np.asarray([p], np.int32), 5,
                                                  greedy=True))[0].tolist() for p in pool}

    async def go():
        engines = {}
        cluster = ServingCluster(_factory(lm, engines=engines, audit=True), 2,
                                 supervisor_kwargs=SUP, registry=MetricsRegistry())
        completions = []
        stop = asyncio.Event()

        async def worker(k):
            async with ServingClient("127.0.0.1", cluster.port) as c:
                while not stop.is_set():
                    p = pool[(k + len(completions)) % len(pool)]
                    done = await c.generate(p, 5)
                    completions.append((time.monotonic(), tuple(p), done["tokens"],
                                        done.get("weight_version")))

        async with cluster:
            workers = [asyncio.create_task(worker(k)) for k in range(3)]
            await _wait_until(lambda: len(completions) >= 4, what="warm-up completions")
            t0 = time.monotonic()
            async with ServingClient("127.0.0.1", cluster.port) as c:
                rep = await c.reload(path, timeout=60.0)
            t1 = time.monotonic()
            n_after = len(completions) + 4
            await _wait_until(lambda: len(completions) >= n_after,
                              what="post-reload completions")
            stop.set()
            await asyncio.gather(*workers)
            per_replica = {i: await eng.submit(pool[0], 5).result()
                           for i, eng in engines.items()}
            audits = {i: (eng.auditor.compiles("serving_decode"),
                          eng.auditor.report()["serving_decode"]["armed"])
                      for i, eng in engines.items()}
            async with ServingClient("127.0.0.1", cluster.port) as c:
                fleet_health = await c.healthz()
        return rep, completions, t0, t1, audits, per_replica, fleet_health

    rep, completions, t0, t1, audits, per_replica, fleet_health = asyncio.run(go())
    prov = weights_provenance(path)
    assert rep["ok"] and sorted(rep["reloaded"]) == ["r0", "r1"] and rep["failed"] == {}
    assert [c for c in completions if t0 <= c[0] <= t1], "nothing completed during the roll"
    for t, p, got, wv in completions:
        if t < t0:
            assert got == want_old[p] and wv["version"] == 0
        elif t > t1:
            assert got == want_new[p]
            assert (wv["version"], wv["digest"]) == (prov["version"], prov["digest"])
        else:
            assert got in (want_old[p], want_new[p])
    for i, got in per_replica.items():
        assert got == want_new[tuple(pool[0])], f"replica {i} serves stale weights"
    for i, (compiles, armed) in audits.items():
        assert compiles == 1 and armed, f"replica {i}: {audits[i]}"
    key = f"{prov['version']}:{prov['digest']}"
    assert fleet_health["router"]["weight_versions"] == {key: 2}


def _roles_cluster(lm, roles, registry=None, auditors=None, router_kwargs=None):
    kwargs = {"affinity_tokens": 4, "min_handoff_tokens": 4}
    kwargs.update(router_kwargs or {})
    return ServingCluster(
        _factory(lm, audit=auditors is not None, auditors=auditors, paged=True,
                 kv_pool_blocks=64, kv_block_tokens=4),
        len(roles), roles=roles, registry=registry, supervisor_kwargs=SUP,
        router_kwargs=kwargs)


@time_limited(timeout=180)
def test_disaggregated_fleet_token_identical_armed_auditor(lm):
    prompts = _prompts(62, (12, 13, 17, 12))

    async def main():
        registry = MetricsRegistry()
        auditors = {}
        cluster = _roles_cluster(lm, ["prefill", "decode"], registry=registry,
                                 auditors=auditors)
        dones = []
        async with cluster:
            async with ServingClient("127.0.0.1", cluster.port, wire_mode="auto") as c:
                assert c.proto == port_wire.PROTO_BIN1
                for p in prompts:
                    dones.append(await c.generate(p, 6))
                health = await c.healthz()
            snap = registry.snapshot()
            prefill = cluster.replicas["r0"].handle.engine
            decode = cluster.replicas["r1"].handle.engine
            return dones, health, snap, prefill, decode, auditors

    dones, health, snap, prefill, decode, auditors = asyncio.run(main())
    for p, done in zip(prompts, dones):
        assert done["tokens"] == _want(lm, p, 6)
        km = done.get("kv_migration")
        assert km and "fallback" not in km and km["bytes"] > 0, km
        assert km["matched_tokens"] == len(p) // 4 * 4
    assert snap["router_kv_handoffs_total"]["value"] == len(prompts)
    assert snap["router_kv_handoff_fallbacks_total"]["value"] == 0
    assert prefill.metrics.kv_exports == len(prompts)
    assert decode.metrics.kv_migrations == len(prompts)
    assert decode.decode_compile_count() == 1
    assert auditors[1].report()["serving_decode"]["armed"]
    assert health["router"]["roles"] == {"prefill": 1, "decode": 1}
    assert health["router"]["kv_migrations"]["migrations"] == len(prompts)
    assert health["replicas"]["r1"]["role"] == "decode"


@time_limited
def test_transfer_failure_falls_back_with_zero_client_errors(lm):
    _, _, port, params = lm
    prompt = _prompts(63, (12,))[0]

    async def main():
        engine = ServingEngine(port, params, slots=2, kv_pool_blocks=64, kv_block_tokens=4,
                               device="cpu")
        server = ServingServer(engine, port=0, kv_transfer_timeout_s=2.0)
        await server.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            spec = {"prompt": prompt, "max_new_tokens": 5,
                    "kv_from": {"host": "127.0.0.1", "port": 1}}
            writer.write((json.dumps(spec) + "\n").encode())
            await writer.drain()
            done = None
            while done is None:
                rec = json.loads(await reader.readline())
                assert "error" not in rec, rec
                if rec.get("done"):
                    done = rec
            writer.close()
        finally:
            await server.stop()
        return done, engine

    done, engine = asyncio.run(main())
    assert done["tokens"] == _want(lm, prompt, 5)
    assert "fallback" in done["kv_migration"]
    assert engine.metrics.kv_migration_fallbacks == 1 and engine.metrics.kv_migrations == 0


@pytest.mark.parametrize("kv_fail", [False, True], ids=["handoff", "fallback"])
@pytest.mark.parametrize("pkg", ["reference", "port"])
@time_limited
def test_echo_fleet_handoff_and_fallback(pkg, kv_fail):
    """The router's prefill handoff over an engine-free Echo fleet (the
    KVBLK frames and the kv_export/kv_prefill verbs emulated, the pull
    client real) for each package's router, replicas and client: the
    happy path migrates one 4-token block; a failing prefill replica is a
    counted fallback, and generation never fails either way."""
    if pkg == "reference":
        from distkeras_tpu.serving import ServingClient as Client
        from distkeras_tpu.serving import ServingCluster as Cluster
        from distkeras_tpu.telemetry import MetricsRegistry as Registry
        Echo = ref_replicas.EchoReplica
    else:
        Client, Cluster, Registry = ServingClient, ServingCluster, MetricsRegistry
        Echo = port_replicas.EchoReplica

    async def main():
        registry = Registry()
        cluster = Cluster(lambda i: Echo(kv_fail=kv_fail, kv_block_tokens=4), 3,
                          roles=["prefill", "decode", "decode"], registry=registry,
                          supervisor_kwargs=SUP,
                          router_kwargs={"affinity_tokens": 4, "min_handoff_tokens": 4})
        async with cluster:
            async with Client("127.0.0.1", cluster.port, wire_mode="auto") as c:
                done = await c.generate([5, 6, 7, 8, 9], 1)
            prefill = cluster.replicas["r0"].handle.server
            return done, prefill, registry.snapshot()

    done, prefill, snap = asyncio.run(main())
    assert done["tokens"] == [5]
    km = done.get("kv_migration")
    if kv_fail:
        assert km is None
        assert snap["router_kv_handoff_fallbacks_total"]["value"] == 1
        assert snap["router_kv_handoffs_total"]["value"] == 0
    else:
        assert km and "fallback" not in km and km["matched_tokens"] == 4, km
        assert prefill.kv_prefills == 1 and prefill.kv_exports == 1
        assert snap["router_kv_handoffs_total"]["value"] == 1


@time_limited(timeout=240)
def test_process_replica_serves_one_stream(lm):
    """A real child (``python -m distkeras_tpu_torch.run serve --device cpu``)
    behind the router: one greedy stream equal to ``generate()`` on the
    same seed's weights, and fleet healthz."""
    from distkeras_tpu_torch.serving.cluster import ProcessReplica
    from distkeras_tpu_torch.models import bert as port_bert

    p = _prompts(64, (5,))[0]
    port_model = port_bert.gpt_tiny(seq_len=32, vocab_size=VOCAB)
    from distkeras_tpu_torch.inference.generate import generate

    want = generate(port_model, port_model.init(0, device="cpu"), np.asarray([p], np.int32),
                    4, greedy=True, device="cpu")[0].tolist()

    async def go():
        extra = ["--model", "gpt_tiny", "--model-args", '{"seq_len": 32, "vocab_size": 64}',
                 "--slots", "2", "--seed", "0", "--device", "cpu"]
        cluster = ServingCluster(lambda i: ProcessReplica(extra), 1,
                                 supervisor_kwargs=dict(health_interval_s=0.5))
        async with cluster:
            async with ServingClient("127.0.0.1", cluster.port) as c:
                done = await c.generate(p, 4)
                health = await c.healthz()
        return done, health

    done, health = asyncio.run(go())
    assert done["tokens"] == want
    assert health["router"]["replicas_ready"] == 1
    assert health["replicas"]["r0"]["healthz"]["device_memory"][0]["device"] == "cpu:0"
