"""Pipeline-parallel serving: the port's ``ServingEngine`` on a ``pp`` (and
``tp x pp``) serving mesh over gloo ranks on the CPU, against the
reference's pp engine on its virtual CPU devices and its ``generate()``;
``parallel/pp.py`` and the stage-sliced bert apply against the reference's.

One spawn of two ``tests/torch_dp_worker.py`` ranks (runner ``serve_mesh``,
mesh ``tp=1, pp=2``: gpt_tiny's two layers, one a stage) runs the cases of
the reference's ``tests/test_pp_serving.py``, then one of four runs
``tp=2, pp=2``. Weights: the reference's ``gpt_tiny(64, 64)`` init in
float32, bridged. Rank 0 (stage 0) leads.

- dense, paged (a pool tight enough to preempt), chunked prefix cache and
  speculative engines give the reference ``generate()``'s greedy tokens,
  the dense ones also the reference's own pp=2 engine's, with the decode
  step compiled once on every stage;
- ``pipeline_depth=2`` (two micro-batches a tick through the stages)
  gives depth 1's tokens, dense and paged under preemption, and records
  ``bubble_fraction``;
- score, a two-way fork and embed through the stages (score and embed
  within 2e-5 of the reference's unsharded engine, float32);
- a parameter swap without a retrace; the healthz and debugz ``pipeline``
  rows (stages, micro-batches, bubble) and ``mesh`` row (per-stage ranks,
  layers, bytes); KV export and import refused typed, as the reference's;
- ``tp x pp`` dense and paged parity;
- ``StagePlan`` against the reference's, and the stage-sliced apply
  (``stage=(lo, hi, first, last)``) equal to the whole apply in the full,
  decode and paged modes, and to the reference's stage apply within 1e-5
  (float32, the layer arithmetic of ``tests/test_torch_bert.py``).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.parallel.mesh import serving_mesh as ref_serving_mesh
from distkeras_tpu.parallel.pp import plan_stages as ref_plan_stages
from distkeras_tpu.serving.engine import ServingEngine as RefEngine
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.bert import decode_cache
from distkeras_tpu_torch.parallel.pp import plan_stages
from distkeras_tpu_torch.serving.debugz import format_debugz
from test_torch_sharded_serving import (
    REF, VARS, VARS7, WEIGHTS, _case, _np_weights, _port_model, _prompts, _reqs, want,
)
from torch_dp_worker import spawn_ranks
from torch_time_limit import time_limited

STAGE_ATOL = 1e-5
KIND_ATOL = 2e-5
PP2 = {"tp": 1, "pp": 2}
P = {
    "dense": _prompts(11, (3, 5, 8, 13, 6, 4, 9, 7)),
    "paged": _prompts(12, (12, 12, 12, 12)),
    "prefix": [_prompts(13, (16,))[0] + t for t in _prompts(14, (4, 4, 4))],
    "spec": _prompts(15, (3, 6, 9)),
}
PAGED_TIGHT = {"slots": 4, "max_queue": 16, "kv_pool_blocks": 13, "kv_block_tokens": 4}

TWO = {
    "dense": _case(PP2, _reqs(P["dense"], 8), engine={"slots": 4, "max_queue": 16}),
    "depth2": _case(PP2, _reqs(P["dense"], 8),
                    engine={"slots": 4, "max_queue": 16, "pipeline_depth": 2}),
    "paged": _case(PP2, _reqs(P["paged"], 10), engine=PAGED_TIGHT),
    "paged_depth2": _case(PP2, _reqs(P["paged"], 10),
                          engine={**PAGED_TIGHT, "pipeline_depth": 2}),
    "prefix": _case(PP2, _reqs(P["prefix"], 6), sequential=True,
                    engine={"slots": 2, "prefix_cache_mb": 4.0, "prefix_block_tokens": 8,
                            "prefill_chunk": 8}),
    "spec": _case(PP2, _reqs(P["spec"], 8) + [(P["spec"][1], 8, {"temperature": 0.8})],
                  engine={"slots": 2, "max_queue": 16, "draft": True, "spec_k": 3}),
    "kinds": _case(PP2, [(P["spec"][0], 0, {"kind": "score"}),
                         (P["spec"][1], 4, {"kind": "sample", "n": 2, "speculate": False}),
                         (P["spec"][2], 0, {"kind": "embed"})],
                   engine={"slots": 4, "kv_pool_blocks": 64, "kv_block_tokens": 4}),
    "swap": _case(PP2, _reqs(P["spec"][:1], 6), swap=_np_weights(VARS7), engine={"slots": 2}),
    "healthz": _case(PP2, _reqs(P["spec"][:2], 4), healthz=True, kv_refuse=True,
                     engine={"slots": 2, "pipeline_depth": 2, "kv_pool_blocks": 32,
                             "kv_block_tokens": 4}),
}
FOUR = {
    "pp_tp": _case({"tp": 2, "pp": 2}, _reqs(P["dense"][:4], 8), engine={"slots": 2}),
    "pp_tp_paged": _case({"tp": 2, "pp": 2}, _reqs(P["paged"], 10), engine=PAGED_TIGHT),
}


@time_limited(timeout=300)
def _spawn(workdir, world, cases):
    return spawn_ranks(workdir, world, {"serve": {"kind": "serve_mesh", "cases": cases}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world, cases in ((2, TWO), (4, FOUR)):
        ranks = _spawn(str(tmp_path_factory.mktemp(f"pp{world}")), world, cases)
        for name in cases:
            out[name] = [r["serve"][name] for r in ranks]
    return out


def _leader(runs, name):
    rep = runs[name][0]
    assert "error" not in rep, rep
    return rep


def _per_stage_once(runs, name, names=("serving_decode",)):
    rep = _leader(runs, name)
    assert rep["counts"] == [1] * len(runs[name]), rep["counts"]
    for rank_rep in runs[name]:
        for n in names:
            assert rank_rep["compiles"][n] == 1, (name, rank_rep["compiles"])


def test_pp_dense_matches_reference_engine_compile_once_per_stage(runs):
    rep = _leader(runs, "dense")
    assert rep["outs"] == [want(p, 8) for p in P["dense"]]
    ref = RefEngine(REF, VARS, slots=4, max_queue=16,
                    mesh=ref_serving_mesh(PP2, devices=jax.devices()[:2]))

    async def go():
        task = asyncio.create_task(ref.run())
        try:
            reqs = [ref.submit(p, 8) for p in P["dense"]]
            return [await r.result() for r in reqs]
        finally:
            ref.shutdown(drain=True)
            await task

    assert rep["outs"] == asyncio.run(go())
    _per_stage_once(runs, "dense")


def test_pp_depth2_equals_depth1_with_bubble(runs):
    rep = _leader(runs, "depth2")
    assert rep["outs"] == _leader(runs, "dense")["outs"]
    assert rep["bubble"] is not None and 0.0 <= rep["bubble"] <= 1.0
    assert rep["debugz"]["pipeline"]["micro_batches"] == 2
    assert _leader(runs, "dense")["debugz"]["pipeline"]["micro_batches"] == 1
    _per_stage_once(runs, "depth2")


def test_pp_paged_preempt_resume_parity(runs):
    for name in ("paged", "paged_depth2"):
        rep = _leader(runs, name)
        assert rep["outs"] == [want(p, 10) for p in P["paged"]], name
        assert rep["preemptions"] > 0, name
        _per_stage_once(runs, name)


def test_pp_prefix_cache_chunked_parity(runs):
    rep = _leader(runs, "prefix")
    assert rep["outs"] == [want(p, 6) for p in P["prefix"]]
    assert rep["prefix_hits"] > 0
    _per_stage_once(runs, "prefix")


def test_pp_speculative_parity_compile_once(runs):
    rep = _leader(runs, "spec")
    assert rep["outs"][:3] == [want(p, 8) for p in P["spec"]]
    assert len(rep["outs"][3]) == 8
    assert rep["spec_accepted"] > 0
    _per_stage_once(runs, "spec", ("serving_decode", "serving_draft", "serving_verify"))


def test_pp_request_kinds(runs):
    """score, a two-way fork and embed through the stages: the fork gives
    ``generate()``'s tokens, score and embed within 2e-5 of the
    reference's unsharded engine (float32 on every stage)."""
    rep = _leader(runs, "kinds")
    assert rep["forks"][1] == [want(P["spec"][1], 4)] * 2
    ref = RefEngine(REF, VARS, slots=4, kv_pool_blocks=64, kv_block_tokens=4)

    async def go():
        task = asyncio.create_task(ref.run())
        try:
            score = ref.submit(P["spec"][0], 0, kind="score")
            embed = ref.submit(P["spec"][2], 0, kind="embed")
            await score.result()
            await embed.result()
            return score.logprobs, embed.embedding
        finally:
            ref.shutdown(drain=True)
            await task

    logprobs, embedding = asyncio.run(go())
    np.testing.assert_allclose(rep["scores"][0], logprobs, atol=KIND_ATOL, rtol=0)
    np.testing.assert_allclose(rep["embeds"][2], embedding, atol=KIND_ATOL, rtol=0)
    _per_stage_once(runs, "kinds")


def test_pp_param_swap_without_retrace(runs):
    rep = _leader(runs, "swap")
    p = P["spec"][0]
    assert rep["outs"] == [want(p, 6)] and rep["after_swap"] == [want(p, 6, VARS7)]
    _per_stage_once(runs, "swap")


def test_pp_healthz_debugz_mesh_rows_and_kv_refusals(runs):
    rep = _leader(runs, "healthz")
    health = rep["healthz"]
    assert health["pipeline"]["stages"] == 2
    assert health["pipeline"]["micro_batches"] == 2
    assert "bubble_fraction" in health["pipeline"]
    for info in (rep["mesh_info"], health["mesh"]):
        assert info["pp"] == 2 and info["axes"] == PP2
        stages = info["stages"]
        assert [st["stage"] for st in stages] == [0, 1]
        assert stages[0]["layers"] == [0, 1] and stages[1]["layers"] == [1, 2]
        for st in stages:
            assert len(st["devices"]) == 1 and st["params_bytes"] > 0 and st["kv_bytes"] > 0
        assert set(stages[0]["devices"]).isdisjoint(stages[1]["devices"])
    assert rep["debugz"]["pipeline"]["stages"] == 2
    page = format_debugz(rep["debugz"])
    assert "stages: 2 pp stage(s) x 2 micro-batch(es)" in page and "bubble=" in page
    ref = RefEngine(REF, VARS, slots=2, kv_pool_blocks=32, kv_block_tokens=4,
                    mesh=ref_serving_mesh(PP2, devices=jax.devices()[:2]))
    msgs = []
    for verb, arg in (("request_kv_export", P["spec"][0]), ("request_kv_import", b"")):
        with pytest.raises(Exception) as e:
            getattr(ref, verb)(arg)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert [tuple(m) for m in rep["refused"]] == msgs


def test_pp_tp_combined_parity(runs):
    rep = _leader(runs, "pp_tp")
    assert rep["outs"] == [want(p, 8) for p in P["dense"][:4]]
    assert rep["mesh_info"]["axes"] == {"tp": 2, "pp": 2}
    _per_stage_once(runs, "pp_tp")
    paged = _leader(runs, "pp_tp_paged")
    assert paged["outs"] == [want(p, 10) for p in P["paged"]]
    _per_stage_once(runs, "pp_tp_paged")


@pytest.mark.parametrize("layers,stages", [(4, 2), (12, 4), (2, 2), (4, 1), (2, 4), (3, 2),
                                           (4, 0)])
def test_stage_plan_matches_reference(layers, stages):
    try:
        ref = ref_plan_stages(layers, stages)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            plan_stages(layers, stages)
        assert str(got.value) == str(e)
        return
    plan = plan_stages(layers, stages)
    for s in range(stages):
        assert plan.layer_range(s) == ref.layer_range(s)
        assert plan.stage_arg(s) == ref.stage_arg(s)
    for i in range(layers):
        assert plan.stage_of_layer(i) == ref.stage_of_layer(i)
    for key in ("token_embed", "pos_embed", "ln_final", "mlm_bias", "layer_0"):
        assert plan.owner_stages(key) == ref.owner_stages(key)


def test_split_params_and_cache_over_port_names():
    """The port's flat names split as the reference's top-level keys do."""
    cfg = dataclasses.replace(_port_model().config, decode=True, decode_slots=True)
    plan = plan_stages(cfg.num_layers, 2)
    names = list(WEIGHTS)
    parts = plan.split_params(dict.fromkeys(names))
    ref_parts = ref_plan_stages(cfg.num_layers, 2).split_params(VARS["params"])
    for mine, theirs in zip(parts, ref_parts):
        assert {k.split(".")[0] for k in mine} == set(theirs)
    cache = plan.split_tree(decode_cache(cfg, 2, "meta"))
    assert "pos_index" in cache[0] and "pos_index" not in cache[1]
    assert all(k.startswith("layer_1.") for k in cache[1])


def _stage_chain(model, params, x, **kw):
    """The two stages of gpt_tiny applied one after the other."""
    h, c0 = model.apply(params, x, stage=(0, 1, True, False), **kw)
    out, c1 = model.apply(params, h, stage=(1, 2, False, True), **kw)
    return h, out, {**c0, **c1}


def test_stage_sliced_apply_equals_whole_and_reference():
    port = _port_model()
    params = {k: torch.as_tensor(v) for k, v in WEIGHTS.items()}
    x = torch.as_tensor(np.asarray(_prompts(16, (7, 7)), np.int32))
    whole, _ = port.apply(params, x)
    h, staged, _ = _stage_chain(port, params, x)
    torch.testing.assert_close(staged, whole, rtol=0, atol=0)
    ref_h = ref_bert.Bert(REF.config).apply(VARS, jnp.asarray(x.numpy()),
                                             stage=(0, 1, True, False))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=STAGE_ATOL, rtol=0)
    # Decode mode (dense slots) and paged mode, with their caches.
    from distkeras_tpu_torch.inference.generate import _decode_module

    dec, cfg = _decode_module(port, slots=True)
    cache = decode_cache(cfg, 2, "cpu")
    whole, wc = dec.apply({**params, **cache}, x)
    _, staged, sc = _stage_chain(dec, {**params, **cache}, x)
    torch.testing.assert_close(staged, whole, rtol=0, atol=0)
    assert set(sc) == set(wc)
    for k in wc:
        torch.testing.assert_close(sc[k], wc[k], rtol=0, atol=0)
    paged, pcfg = _decode_module(port, slots=True, paged_blocks=8, page_tokens=4,
                                 page_table_blocks=2)
    pools = decode_cache(pcfg, 2, "cpu")
    kw = {"positions": torch.zeros(2, dtype=torch.int32),
          "block_tables": torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)}
    whole, _ = paged.apply({**params, **{k: v.clone() for k, v in pools.items()}}, x, **kw)
    _, staged, _ = _stage_chain(paged, {**params, **pools}, x, **kw)
    torch.testing.assert_close(staged, whole, rtol=0, atol=0)
