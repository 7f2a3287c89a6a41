"""Tensor-parallel serving: the port's ``ServingEngine(mesh=...)`` over gloo
ranks on the CPU, against the reference's sharded engine on its virtual CPU
devices and its ``generate()``.

One spawn of two ``tests/torch_dp_worker.py`` ranks (runner ``serve_mesh``)
runs every tp=2 case in order, then one of four runs tp=4. Each rank builds
the engine from the same whole weights (the reference's ``gpt_tiny(64, 64)``
init in float32, bridged); rank 0 leads and serves, rank 1 follows. The
scenarios are the reference's ``tests/test_sharded_serving.py`` and
``tests/test_decode_pipeline.py::test_pipeline_parity_sharded_tp2``:

- dense greedy tokens equal the reference ``generate()``'s, and at
  ``slots=1`` the reference's tp=2 engine's, with the decode step's
  compile count 1 on every rank; ``pipeline_depth`` 0 gives depth 1's;
- the chunked prefix cache hits and stays token-identical; a tight paged
  pool preempts and resumes token-identically; speculative decoding (a
  replicated draft over the sharded target) commits drafts, with greedy,
  opt-out and sampled rows, decode/draft/verify compiled once;
- score log-probabilities and an embedding, whose values go through the
  tp sums, within 2e-5 of the reference's unsharded engine (float32; the
  sums change the rounding order, as ``tests/test_torch_model_parallel.py``
  bounds it); constrained rows (greedy and sampled through the masked
  row) obey their automata and a two-way fork gives ``generate()``'s
  tokens;
- a parameter swap without a retrace gives ``generate()``'s tokens under
  the new weights; the healthz ``mesh`` row; KVX1 exported at tp=2,
  relayed through an unsharded engine (tp=1) and imported at tp=2 again is
  byte-equal all the way;
- batch-parallel ``generate``/``beam_search`` on a dp=2 mesh give the
  unsharded call's tokens (sampled too: each shard draws the whole batch's
  numbers) and beam scores within 2e-5 (float32 sums of log-probabilities
  computed at half the batch);
- a follower rank whose decode step raises ends the leader's requests with
  the typed ``MeshRankError`` naming it, well inside the spawn's limit;
- the reference's typed rejections, message for message, before any rank
  is needed.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu.parallel.mesh import serving_mesh as ref_serving_mesh
from distkeras_tpu.serving.engine import ServingEngine as RefEngine
from distkeras_tpu_torch.inference.generate import beam_search, generate
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.parallel.mesh import make_mesh, serving_mesh
from distkeras_tpu_torch.serving import ServingEngine
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_dp_worker import spawn_ranks
from torch_time_limit import time_limited

VOCAB, SEQ = 64, 64
SCORE_ATOL = 2e-5
BEAM_ATOL = 2e-5


def _ref_model(seq=SEQ):
    m = ref_bert.gpt_tiny(seq_len=seq, vocab_size=VOCAB)
    return ref_bert._make(dataclasses.replace(m.config, dtype=jnp.float32), seq, "gpt_tiny")


def _port_model(seq=SEQ):
    m = port_bert.gpt_tiny(seq_len=seq, vocab_size=VOCAB)
    return port_bert._make(dataclasses.replace(m.config, dtype=torch.float32), seq, "gpt_tiny")


REF = _ref_model()
VARS = REF.init(0)
VARS7 = REF.init(7)


def _np_weights(variables):
    return {k: v.numpy() for k, v in
            params_from_jax(jax.tree.map(np.asarray, variables), device="cpu").items()}


WEIGHTS = _np_weights(VARS)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=(n,)).tolist() for n in lengths]


_WANT: dict = {}


def want(prompt, n, variables=VARS):
    key = (id(variables), tuple(prompt), n)
    if key not in _WANT:
        _WANT[key] = np.asarray(ref_generate(REF, variables, np.asarray([prompt], np.int32),
                                             n, greedy=True))[0].tolist()
    return _WANT[key]


def _reqs(prompts, n, **kw):
    return [(p, n, kw) for p in prompts]


SHARED = _prompts(5, (16,))[0]
P = {
    "dense": _prompts(1, (3, 5, 8, 13, 6, 4, 9, 7)),
    "slots1": _prompts(2, (4, 9, 6)),
    "prefix": [SHARED + t for t in _prompts(6, (4, 4, 4, 4))],
    "paged": _prompts(3, (12, 12, 12, 12)),
    "spec": _prompts(4, (3, 6, 9, 5)),
    "score": _prompts(7, (11, 7)),
    "kv": _prompts(8, (13,)),
}
GEN_PROMPT = np.asarray(_prompts(9, (6, 6, 6, 6)), np.int32)


def _case(mesh, requests, **kw):
    return {"mesh": mesh, "seq": SEQ, "vocab": VOCAB, "weights": WEIGHTS,
            "requests": requests, "engine": kw.pop("engine", {}), **kw}


TWO = {
    "dense": _case({"tp": 2}, _reqs(P["dense"], 8), engine={"slots": 4, "max_queue": 16}),
    "slots1": _case({"tp": 2}, _reqs(P["slots1"], 6), engine={"slots": 1}),
    "depth0": _case({"tp": 2}, _reqs(P["dense"][:4], 8),
                    engine={"slots": 2, "pipeline_depth": 0}),
    "prefix": _case({"tp": 2}, _reqs(P["prefix"], 6), sequential=True,
                    engine={"slots": 2, "prefix_cache_mb": 4.0, "prefix_block_tokens": 8,
                            "prefill_chunk": 8}),
    "paged": _case({"tp": 2}, _reqs(P["paged"], 10),
                   engine={"slots": 4, "max_queue": 16, "kv_pool_blocks": 13,
                           "kv_block_tokens": 4}),
    "score": _case({"tp": 2}, _reqs(P["score"], 0, kind="score"),
                   engine={"slots": 2, "kv_pool_blocks": 64, "kv_block_tokens": 4}),
    "kinds": _case({"tp": 2}, [
        (P["score"][0], 6, {"constraint": {"start": 0, "edges": [[0, 1, 1], [1, 2, 0]]}}),
        (P["score"][0], 6, {"constraint": {"start": 0, "edges": [[0, 3, 1], [1, 4, 2]]}}),
        (P["score"][0], 6, {"constraint": {"start": 0, "edges": [[0, 1, 1], [1, 2, 0]]},
                            "temperature": 0.9}),
        (P["score"][1], 4, {"kind": "sample", "n": 2, "speculate": False}),
        (P["kv"][0], 0, {"kind": "embed"})],
        engine={"slots": 6, "max_queue": 16, "constrained": True, "kv_pool_blocks": 64,
                "kv_block_tokens": 4}),
    "spec": _case({"tp": 2}, _reqs(P["spec"], 8) + [(P["spec"][0], 8, {"speculate": False}),
                                                    (P["spec"][1], 8, {"temperature": 0.8})],
                  engine={"slots": 2, "max_queue": 16, "kv_pool_mb": 1.0, "draft": True,
                          "spec_k": 4}),
    "swap": _case({"tp": 2}, _reqs(P["slots1"][:1], 6), swap=_np_weights(VARS7),
                  engine={"slots": 2}),
    "healthz": _case({"tp": 2}, _reqs(P["slots1"][:1], 4), healthz=True, engine={"slots": 2}),
    "kv_out": _case({"tp": 2}, _reqs(P["kv"], 4), kv_export=True, kv_relay=True,
                    engine={"slots": 2, "kv_pool_blocks": 64, "kv_block_tokens": 4}),
    "kv_back": _case({"tp": 2}, _reqs(P["kv"], 4), kv_export=True, kv_import="kv_out",
                     engine={"slots": 2, "kv_pool_blocks": 64, "kv_block_tokens": 4}),
    "generate": {"generate": True, "mesh": {"dp": 2}, "seq": SEQ, "vocab": VOCAB,
                 "weights": WEIGHTS, "prompt": GEN_PROMPT, "new": 6},
    # Last: the failing follower leaves the process group.
    "fail": _case({"tp": 2}, _reqs(P["slots1"], 12), fail={"rank": 1, "after": 3},
                  engine={"slots": 2}),
}
FOUR = {
    "tp4_paged": _case({"tp": 4}, _reqs(P["dense"][:3], 8),
                       engine={"slots": 2, "max_queue": 16, "kv_pool_mb": 1.0}),
}


@time_limited(timeout=300)
def _spawn(workdir, world, cases):
    return spawn_ranks(workdir, world, {"serve": {"kind": "serve_mesh", "cases": cases}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two = _spawn(str(tmp_path_factory.mktemp("tp2")), 2, TWO)
    four = _spawn(str(tmp_path_factory.mktemp("tp4")), 4, FOUR)
    out = {}
    for world in (two, four):
        for name in world[0]["serve"]:
            out[name] = [r["serve"].get(name) for r in world]
    return out


def _leader(runs, name):
    rep = runs[name][0]
    assert rep is not None and "error" not in rep, rep
    return rep


def _compiled_once(runs, name, names=("serving_decode",)):
    for rank, rep in enumerate(runs[name]):
        for n in names:
            assert rep["compiles"][n] == 1, (name, rank, rep["compiles"])


def test_dense_greedy_matches_reference_compile_once(runs):
    rep = _leader(runs, "dense")
    assert rep["outs"] == [want(p, 8) for p in P["dense"]]
    assert rep["counts"] == [1, 1]
    _compiled_once(runs, "dense")
    info = rep["mesh_info"]
    assert info["tp"] == 2 and info["axes"] == {"tp": 2} and len(info["devices"]) == 2
    assert runs["dense"][1]["ops"] > 0


def test_slots1_equals_reference_sharded_engine(runs):
    """At one slot the reference's own tp=2 engine on two virtual devices
    gives the same greedy tokens."""
    ref = RefEngine(REF, VARS, slots=1, mesh=ref_serving_mesh({"tp": 2}, devices=jax.devices()[:2]))

    async def go():
        task = asyncio.create_task(ref.run())
        try:
            return [await ref.submit(p, 6).result() for p in P["slots1"]]
        finally:
            ref.shutdown(drain=True)
            await task

    assert _leader(runs, "slots1")["outs"] == asyncio.run(go())
    _compiled_once(runs, "slots1")


def test_pipeline_depth0_equals_depth1(runs):
    assert _leader(runs, "depth0")["outs"] == _leader(runs, "dense")["outs"][:4]
    _compiled_once(runs, "depth0")


def test_prefix_cache_chunked_parity(runs):
    rep = _leader(runs, "prefix")
    assert rep["outs"] == [want(p, 6) for p in P["prefix"]]
    assert rep["prefix_hits"] > 0
    _compiled_once(runs, "prefix")


def test_paged_preempt_resume_parity(runs):
    rep = _leader(runs, "paged")
    assert rep["outs"] == [want(p, 10) for p in P["paged"]]
    assert rep["preemptions"] > 0
    _compiled_once(runs, "paged")


def test_score_logprobs_within_tolerance_of_reference(runs):
    rep = _leader(runs, "score")
    ref = RefEngine(REF, VARS, slots=2, kv_pool_blocks=64, kv_block_tokens=4)

    async def go():
        task = asyncio.create_task(ref.run())
        try:
            reqs = [ref.submit(p, 0, kind="score") for p in P["score"]]
            for r in reqs:
                await r.result()
            return [r.logprobs for r in reqs]
        finally:
            ref.shutdown(drain=True)
            await task

    for got, exp in zip(rep["scores"], asyncio.run(go())):
        assert len(got) == len(exp)
        np.testing.assert_allclose(got, exp, atol=SCORE_ATOL, rtol=0)


def test_constrained_fork_and_embed_kinds(runs):
    """Constrained rows (greedy, terminal, sampled through the masked
    row), a two-way fork and an embedding on the tp=2 paged engine: the
    automata obeyed, the forks the reference ``generate()``'s tokens, the
    embedding within 2e-5 of the reference's unsharded engine."""
    rep = _leader(runs, "kinds")
    assert rep["outs"][:3] == [[1, 2, 1, 2, 1, 2], [3, 4], [1, 2, 1, 2, 1, 2]]
    assert rep["forks"][3] == [want(P["score"][1], 4)] * 2
    ref = RefEngine(REF, VARS, slots=2, kv_pool_blocks=64, kv_block_tokens=4)

    async def go():
        task = asyncio.create_task(ref.run())
        try:
            req = ref.submit(P["kv"][0], 0, kind="embed")
            await req.result()
            return req.embedding
        finally:
            ref.shutdown(drain=True)
            await task

    np.testing.assert_allclose(rep["embeds"][4], asyncio.run(go()), atol=SCORE_ATOL, rtol=0)
    _compiled_once(runs, "kinds")


def test_speculative_parity_compile_once(runs):
    rep = _leader(runs, "spec")
    wants = [want(p, 8) for p in P["spec"]]
    assert rep["outs"][:4] == wants
    assert rep["outs"][4] == wants[0]  # opted out
    assert len(rep["outs"][5]) == 8  # sampled
    assert rep["spec_accepted"] > 0
    _compiled_once(runs, "spec", ("serving_decode", "serving_draft", "serving_verify"))


def test_param_swap_without_retrace(runs):
    rep = _leader(runs, "swap")
    p = P["slots1"][0]
    assert rep["outs"] == [want(p, 6)]
    assert rep["after_swap"] == [want(p, 6, VARS7)]
    assert rep["weight_version"] == {"version": 9, "digest": "d9"}
    _compiled_once(runs, "swap")


def test_healthz_mesh_row(runs):
    health = _leader(runs, "healthz")["healthz"]
    assert health["mesh"]["axes"] == {"tp": 2} and health["mesh"]["tp"] == 2
    assert health["mesh"]["pp"] == 1 and "stages" not in health["pipeline"]
    assert health["decode_compile_count"] == 1


def test_kvx1_tp2_tp1_tp2_bitwise(runs):
    out, back = _leader(runs, "kv_out"), _leader(runs, "kv_back")
    assert out["outs"] == [want(P["kv"][0], 4)] == back["outs"]
    assert out["payload"] and out["payload"] == out["relayed"] == back["payload"]
    assert back["import"]["adopted_blocks"] == len(P["kv"][0]) // 4


def test_generate_and_beam_search_on_dp2_mesh(runs):
    port = _port_model()
    weights = {k: torch.as_tensor(v) for k, v in WEIGHTS.items()}
    greedy = generate(port, weights, GEN_PROMPT, 6, greedy=True, device="cpu")
    sampled = generate(port, weights, GEN_PROMPT, 6, temperature=0.9, top_k=8, seed=3,
                       device="cpu")
    seqs, scores = beam_search(port, weights, GEN_PROMPT, 6, num_beams=3, device="cpu")
    for rep in runs["generate"]:
        np.testing.assert_array_equal(rep["greedy"], greedy)
        np.testing.assert_array_equal(rep["sampled"], sampled)
        np.testing.assert_array_equal(rep["beam"][0], seqs)
        # The scores sum six float32 log-probabilities computed at half the
        # batch: the matmuls block differently, so the sums differ in the
        # last places (4e-6 seen), the beams not at all.
        np.testing.assert_allclose(rep["beam"][1], scores, atol=BEAM_ATOL, rtol=0)
    np.testing.assert_array_equal(
        greedy, np.asarray(ref_generate(REF, VARS, GEN_PROMPT, 6, greedy=True)))


def test_generate_mesh_rejections():
    port = _port_model()
    weights = {k: torch.as_tensor(v) for k, v in WEIGHTS.items()}
    with pytest.raises(ValueError) as got:
        generate(port, weights, GEN_PROMPT[:3], 2, mesh=make_mesh({"dp": 2}, devices=[0, 1]),
                 device="cpu")
    with pytest.raises(ValueError) as ref:
        ref_generate(REF, VARS, GEN_PROMPT[:3], 2,
                     mesh=ref_make_mesh({"dp": 2}, devices=jax.devices()[:2]))
    assert str(got.value) == str(ref.value)
    with pytest.raises(TypeError, match="Mesh"):
        beam_search(port, weights, GEN_PROMPT, 2, mesh=object(), device="cpu")


def test_follower_failure_is_typed_and_prompt(runs):
    leader, follower = runs["fail"]
    kind, code, msg = leader["error"]
    assert code == "mesh_rank_failed" or "MeshRankError" in msg, leader["error"]
    assert "rank 1" in msg and "injected follower failure" in msg
    assert leader["seconds"] < 60
    assert follower["error"] == ("RuntimeError", "injected follower failure"), follower


def test_tp4_paged_parity(runs):
    rep = _leader(runs, "tp4_paged")
    assert rep["outs"] == [want(p, 8) for p in P["dense"][:3]]
    assert rep["counts"] == [1, 1, 1, 1]
    assert rep["mesh_info"]["axes"]["tp"] == 4


def _both(port_kw, ref_kw, mesh, ref_mesh, port_model=None, ref_model=None):
    """The port's and the reference's constructor errors for one bad
    configuration (no process group is needed to reach them)."""
    with pytest.raises((ValueError, TypeError)) as got:
        ServingEngine(port_model or _port_model(), {k: torch.as_tensor(v)
                                                    for k, v in WEIGHTS.items()},
                      mesh=mesh, device="cpu", **port_kw)
    with pytest.raises((ValueError, TypeError)) as ref:
        RefEngine(ref_model or REF, VARS, mesh=ref_mesh, **ref_kw)
    return str(got.value), str(ref.value)


@pytest.mark.parametrize("shape,kw", [
    ({"dp": 2}, {"slots": 2}),
    ({"tp": 3}, {"slots": 2}),
    ({"tp": 2}, {"slots": 2, "pipeline_depth": 2}),
    ({"tp": 1, "pp": 2}, {"slots": 3, "pipeline_depth": 2}),
    ({"tp": 1, "pp": 2}, {"slots": 2, "pipeline_depth": 2, "draft": True}),
    ({"tp": 1, "pp": 2}, {"slots": 2, "kv_pool_blocks": 16, "kv_block_tokens": 4,
                          "constrained": True}),
    ({"tp": 1, "pp": 2}, {"slots": 2, "kv_pool_blocks": 16, "kv_block_tokens": 4,
                          "kv_host_tier_mb": 1.0}),
], ids=["dp-axis", "tp3-heads", "depth-no-pp", "depth-slots", "depth-spec", "constrained-pp",
        "host-tier-pp"])
def test_typed_rejections_match_reference(shape, kw):
    n = int(np.prod(list(shape.values())))
    port_kw, ref_kw = dict(kw), dict(kw)
    if port_kw.pop("draft", False):
        port_kw.update(draft_model=_port_model(),
                       draft_variables={k: torch.as_tensor(v) for k, v in WEIGHTS.items()})
        ref_kw.pop("draft")
        ref_kw.update(draft_model=REF, draft_variables=VARS)
    axes = dict(shape)
    mesh = make_mesh(axes, devices=list(range(n)))
    ref_mesh = ref_make_mesh(axes, devices=jax.devices()[:n])
    got, ref = _both(port_kw, ref_kw, mesh, ref_mesh)
    assert got == ref


def test_mesh_needs_a_process_group_and_a_mesh():
    weights = {k: torch.as_tensor(v) for k, v in WEIGHTS.items()}
    with pytest.raises(RuntimeError, match="process group"):
        ServingEngine(_port_model(), weights, mesh=serving_mesh({"tp": 2}, devices=[0, 1]),
                      device="cpu")
    with pytest.raises(TypeError, match="serving_mesh"):
        ServingEngine(_port_model(), weights, mesh=object(), device="cpu")


def test_fleet_verify_reads_a_sharded_replicas_mesh_row(runs, tmp_path):
    """The deploy controller's fleet verify over a sharded replica's
    healthz ``mesh`` row: a fleet mixing it with an unsharded replica
    fails, two alike pass, in both packages."""
    from distkeras_tpu.deploy.controller import DeployController as RefController
    from distkeras_tpu_torch.deploy.controller import DeployController

    row = _leader(runs, "healthz")["healthz"]["mesh"]

    class Router:
        supervisor = registry = trace_store = flight_recorder = None

        def __init__(self, subs):
            self.subs = subs

        async def _control(self, msg):
            reps = {f"r{i}": {"status": "ready", "healthz": h} for i, h in enumerate(self.subs)}
            return {"healthz": {"router": {"weight_versions": {"1:d": len(reps)},
                                           "replicas_ready": len(reps)}, "replicas": reps}}

    for cls in (DeployController, RefController):
        for subs, ok in (([{"mesh": row}, {}], False), ([{"mesh": row}, {"mesh": row}], True)):
            got, detail = asyncio.run(cls(Router(subs), str(tmp_path))._verify_fleet(
                {"version": 1, "digest": "d"}, attempts=1))
            assert got is ok, (cls, detail)
            assert detail["meshes"]["r0"] == '{"tp": 2}'
