"""The serving telemetry of the port against the reference's.

``telemetry/request_trace.py``, ``wide_events.py``, ``flight_recorder.py``,
``exposition.py`` and the ``HostGapTracker`` of ``serving/metrics.py`` are
jax-free copies; the reference's unit cases run here against both
packages, parametrized over the module, and the same registry operations
render the same Prometheus page. Then the port's engine, as the
reference's tests drive the reference's: a traced request's timeline
through the server (with the armed auditor silent), the path with tracing
off building no timeline, the run loop's crash dump, and the spans'
Chrome trace.
"""

import asyncio
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.serving import ServingClient, ServingEngine, ServingServer
from distkeras_tpu_torch.telemetry import spans
from distkeras_tpu_torch.telemetry.flight_recorder import FlightRecorder, load_flight_dump
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from distkeras_tpu_torch.telemetry.request_trace import TraceStore, new_trace_id
from distkeras_tpu_torch.utils.bridge import params_from_jax
from tests.torch_time_limit import time_limited

VOCAB = 64


def _both(name):
    return pytest.mark.parametrize(
        "mod", [importlib.import_module(f"distkeras_tpu.{name}"),
                importlib.import_module(f"distkeras_tpu_torch.{name}")],
        ids=["reference", "port"])


# -- units, against both packages ---------------------------------------------

@_both("telemetry.request_trace")
def test_trace_store_bounds_hops_and_chrome_export(mod):
    store = mod.TraceStore(capacity=3)
    tids = [mod.new_trace_id() for _ in range(5)]
    assert len(set(tids)) == 5
    for tid in tids:
        rec = mod.TimelineRecord(tid, "engine", "r0")
        rec.event("submit", prompt_tokens=4)
        rec.event("admit", dur_s=0.01)
        rec.data["status"] = "ok"
        store.put(rec)
    assert len(store) == 3 and store.evicted == 2
    assert store.get(tids[0]) is None
    assert store.get(tids[-1])["data"]["status"] == "ok"
    ct = mod.chrome_trace(store.recent(10))
    assert len([e for e in ct["traceEvents"] if e["ph"] == "M"]) == 3
    body = [e for e in ct["traceEvents"] if e["ph"] != "M"]
    assert all(e["args"]["trace_id"] in tids for e in body)
    assert any(e["ph"] == "X" and e["dur"] > 0 for e in body)
    hops = mod.TraceStore(capacity=8)
    tid = mod.new_trace_id()
    for src in ("r0", "r1"):
        rec = mod.TimelineRecord(tid, "engine", src)
        rec.event("submit")
        hops.put(rec)
    merged = mod.merge_trace(tid, hops.get_all(tid))
    assert merged["hops"] == ["r0", "r1"]


@pytest.mark.parametrize("raw", ["cafe01", "a b\n", "x" * 200, "", None, 17, "tr-ä"])
def test_trace_ids_sanitize_as_the_reference(raw):
    from distkeras_tpu.telemetry import request_trace as ref_rt
    from distkeras_tpu_torch.telemetry import request_trace as port_rt

    assert port_rt.sanitize_trace_id(raw) == ref_rt.sanitize_trace_id(raw)


@_both("telemetry.flight_recorder")
def test_flight_recorder_ring_and_dump(mod, tmp_path):
    fr = mod.FlightRecorder(capacity=4, timeline_capacity=2, slow_capacity=2,
                            dump_path=str(tmp_path / "black_box.json"), source="r7")
    for i in range(7):
        fr.record_event(f"e{i}", n=i)
    assert [e[1] for e in fr._events.items()] == ["e3", "e4", "e5", "e6"]
    assert fr.stats()["events_recorded"] == 7
    for i in range(3):
        fr.record_timeline({"trace_id": f"t{i}", "data": {}}, slow=(i == 1))
    dump = mod.load_flight_dump(fr.dump())
    assert dump["source"] == "r7"
    assert [e["kind"] for e in dump["events"]] == ["e3", "e4", "e5", "e6"]
    assert [t["trace_id"] for t in dump["timelines"]] == ["t1", "t2"]
    assert [t["trace_id"] for t in dump["slow_exemplars"]] == ["t1"]
    bad = mod.FlightRecorder(capacity=2, dump_path=str(tmp_path / "no" / "dir" / "x.json"))
    assert bad.crash_dump(error="boom") is None


@_both("telemetry.wide_events")
def test_wide_event_ring_and_query(mod):
    store = mod.WideEventStore(capacity=4)
    for i in range(6):
        store.append({"trace_id": f"t{i}", "tenant": f"ten{i}", "prompt_tokens": i,
                      "latency_s": 0.1 * (i + 1)})
    st = store.stats()
    assert st["appended"] == 6 and st["rows"] == 4 and st["overwritten"] == 2
    assert [r["trace_id"] for r in store.tail(10)] == ["t2", "t3", "t4", "t5"]
    with pytest.raises(ValueError, match="unknown wide-event col"):
        store.append({"trace_id": "x", "latency_ms": 5})
    big = mod.WideEventStore(capacity=64)
    for i in range(30):
        big.append({"trace_id": f"t{i}", "tenant": "a" if i % 3 else "b",
                    "kind": "generate", "prompt_tokens": i, "ttft_s": 0.002 * (i + 1)})
    out = big.query(where=["prompt_tokens>=10"], group_by=["tenant"],
                    aggs=["count", "sum:prompt_tokens", "p50:ttft_s"])
    by = {g["key"]["tenant"]: g for g in out["groups"]}
    assert by["a"]["count"] + by["b"]["count"] == out["matched"] == 20
    assert by["b"]["aggs"]["sum:prompt_tokens"]["value"] == sum(
        i for i in range(10, 30) if i % 3 == 0)
    with pytest.raises(ValueError):
        big.query(group_by=["tenant", "kind", "trace_id"])


def test_wide_event_queries_equal_reference():
    from distkeras_tpu.telemetry import wide_events as ref_we
    from distkeras_tpu_torch.telemetry import wide_events as port_we

    rows = [{"trace_id": f"t{i}", "tenant": "abc"[i % 3], "kind": "generate",
             "status": "ok" if i % 5 else "timeout", "prompt_tokens": i,
             "output_tokens": 2 * i, "ttft_s": 0.001 * (i + 1) ** 1.5,
             "latency_s": 0.01 * (i + 1)} for i in range(50)]
    results = []
    for mod in (ref_we, port_we):
        store = mod.WideEventStore(capacity=64)
        for r in rows:
            store.append(r)
        results.append(store.query(where=["status=ok"], group_by=["tenant"],
                                   aggs=["count", "mean:latency_s", "p99:ttft_s",
                                         "sum:output_tokens"]))
    assert results[0] == results[1]


def test_prometheus_page_equals_reference():
    from distkeras_tpu.telemetry import exposition as ref_exp
    from distkeras_tpu.telemetry import registry as ref_reg
    from distkeras_tpu_torch.telemetry import exposition as port_exp
    from distkeras_tpu_torch.telemetry import registry as port_reg

    pages, snaps = [], []
    for reg_mod, exp_mod in ((ref_reg, ref_exp), (port_reg, port_exp)):
        reg = reg_mod.MetricsRegistry()
        reg.counter("serving_requests_completed_total", help="done").inc(3)
        reg.gauge("serving_slot_occupancy", help="occ", tenant="a").set(0.5)
        h = reg.histogram("serving_ttft_seconds", help="ttft",
                          buckets=reg_mod.log_buckets(1e-3, 10.0))
        for v, ex in ((0.002, "x"), (0.04, "y"), (1.5, "z")):
            h.observe(v, exemplar=ex)
        pages.append(exp_mod.prometheus_text(reg))
        snap = reg.snapshot()
        snaps.append(snap)
    assert pages[0] == pages[1]
    assert snaps[0] == snaps[1]
    assert ref_reg.merge_hist_states(h.state(), h.state()) == port_reg.merge_hist_states(
        h.state(), h.state())


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@_both("serving.metrics")
def test_host_gap_depth0_and_pipelined(mod):
    clk = FakeClock()
    hg = mod.HostGapTracker(clock=clk)
    for t_d, t_hs, t_he in ((0.0, 0.001, 0.101), (0.141, 0.142, 0.241)):
        clk.t = t_d
        hg.tick_dispatched()
        clk.t = t_hs
        hg.harvest_started()
        clk.t = t_he
        hg.harvest_ended()
    assert list(hg.gaps) == [0.0, pytest.approx(0.04)]
    assert hg.idle_ratio == pytest.approx(0.04 / 0.141)
    p = mod.HostGapTracker(clock=clk)
    clk.t = 1.0
    p.tick_dispatched()
    clk.t = 1.05
    p.tick_dispatched()  # tick 0 still in flight: the queue never emptied
    assert p.last_gap == 0.0
    assert mod.HostGapTracker(clock=FakeClock()).summary() == {}


# -- the engine's telemetry ---------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    ref = ref_bert.gpt_tiny(seq_len=32, vocab_size=VOCAB)
    ref = ref_bert._make(dataclasses.replace(ref.config, dtype=jnp.float32), 32, "gpt_tiny")
    port = port_bert.gpt_tiny(seq_len=32, vocab_size=VOCAB)
    port = port_bert._make(dataclasses.replace(port.config, dtype=torch.float32), 32,
                           "gpt_tiny")
    return port, params_from_jax(jax.tree.map(np.asarray, ref.init(0)), device="cpu")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(n,)).tolist()


@time_limited
def test_engine_timeline_debugz_and_auditor_silence(lm, tmp_path):
    """One traced request through the server: its timeline has the
    reference's phases, debugz shows the live tables, exemplars name the
    request, and the armed auditor stays at one decode signature."""
    model, params = lm
    store = TraceStore(64)
    recorder = FlightRecorder(64, dump_path=str(tmp_path / "flight.json"), source="e0")
    engine = ServingEngine(model, params, slots=2, max_queue=8, prefix_cache_mb=1.0,
                           prefix_block_tokens=4, prefill_chunk=4,
                           auditor=RecompileAuditor(), arm_auditor_after_warmup=True,
                           trace_store=store, flight_recorder=recorder, slo_s=1e-9,
                           device="cpu")
    prompt = _prompt(30, 9)

    async def go():
        server = ServingServer(engine, port=0)
        await server.start()
        try:
            async with ServingClient("127.0.0.1", server.port) as c:
                tid = new_trace_id()
                done = await c.generate(prompt, 5, trace_id=tid)
                done2 = await c.generate(prompt[:8] + _prompt(31, 3), 4)
                return (tid, done, done2, await c.debugz(), await c.tracez(tid),
                        await c.healthz(), await c.metricsz())
        finally:
            await server.stop(drain=True)

    tid, done, done2, dz, tz, health, metrics = asyncio.run(go())
    assert done["trace_id"] == tid
    hops = tz["hops"]
    assert len(hops) == 1 and hops[0]["trace_id"] == tid
    names = [e[0] for e in hops[0]["events"]]
    assert names[0] == "submit" and names[-1] == "done"
    assert "admit" in names and "first_token" in names
    d = hops[0]["data"]
    assert names.count("prefill_chunk") == d["prefill_chunks"] == 3
    assert d["status"] == "ok" and d["tokens_out"] == 5 and d["slo_violation"] is True
    assert d["prefill_device_s"] > 0 and d["decode_iterations"] >= 1
    assert [s["state"] for s in dz["slots"]] == ["free", "free"]
    assert dz["prefix_cache"]["families"] >= 1
    assert dz["flight_recorder"]["timelines_recorded"] == 2
    assert health["slo_violations"] == 2
    assert health["recompile_audit"]["serving_decode"]["compiles"] == 1
    ttft_ex = metrics["serving_ttft_seconds"]["exemplars"]
    assert ttft_ex and all(v["trace_id"] in (tid, done2["trace_id"])
                           for v in ttft_ex.values())
    assert len(recorder.slow_exemplars()) == 2
    assert engine.auditor.report()["serving_decode"]["armed"]
    assert len(engine.wide_events) == 2


@time_limited
def test_disabled_path_builds_no_timelines(lm):
    model, params = lm
    engine = ServingEngine(model, params, slots=1, max_queue=4, device="cpu")

    async def go():
        task = asyncio.create_task(engine.run())
        req = engine.submit(_prompt(32, 5), 4, trace_id="cafe01")
        assert req.trace is None
        out = await req.result()
        engine.shutdown(drain=True)
        await task
        return req, out

    req, out = asyncio.run(go())
    assert req.trace is None and req.trace_id == "cafe01" and len(out) == 4
    snap = engine.metrics.registry.snapshot()
    assert any(v["trace_id"] == "cafe01"
               for v in snap["serving_ttft_seconds"]["exemplars"].values())


@time_limited
def test_engine_crash_dumps_flight_recorder(lm, tmp_path):
    model, params = lm
    path = str(tmp_path / "last_words.json")
    engine = ServingEngine(model, params, slots=1, max_queue=4, device="cpu",
                           flight_recorder=FlightRecorder(32, dump_path=path, source="dying"))

    async def go():
        task = asyncio.create_task(engine.run())
        req = engine.submit(_prompt(33, 20), 10)
        async for _ in req.tokens():
            break  # mid-stream
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return req

    req = asyncio.run(go())
    assert req.error is not None and req.error.code == "error"
    kinds = [e["kind"] for e in load_flight_dump(path)["events"]]
    assert "engine_start" in kinds and "crash" in kinds


@time_limited
def test_engine_spans_export_chrome_trace(lm):
    model, params = lm
    tracer = spans.enable_tracing()
    try:
        engine = ServingEngine(model, params, slots=2, device="cpu")

        async def work():
            task = asyncio.create_task(engine.run())
            reqs = [engine.submit(_prompt(34 + n, n), 4) for n in (3, 6)]
            out = [await r.result() for r in reqs]
            engine.shutdown(drain=True)
            await task
            return out

        asyncio.run(work())
    finally:
        spans.disable_tracing()
    trace = tracer.chrome_trace()
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "B"}
    assert {"admit", "prefill", "decode_tick", "stream"} <= names
    stacks = {}
    for ev in trace["traceEvents"]:
        if ev["ph"] == "B":
            stacks.setdefault(ev["tid"], []).append(ev["name"])
        elif ev["ph"] == "E":
            assert stacks[ev["tid"]].pop() == ev["name"]
    assert all(not s for s in stacks.values())
    prefill_b = next(e for e in trace["traceEvents"]
                     if e["ph"] == "B" and e["name"] == "prefill")
    assert prefill_b["args"]["parent"] == "admit"
    json.dumps(trace)
