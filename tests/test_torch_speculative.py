"""Speculative decoding on the port against the reference, dense and paged.

``gpt_tiny(seq_len=32, vocab_size=64)`` in float32 on both sides, the
reference's weights bridged to the port. Two drafts: the target itself
(acceptance near 1, so deep accept prefixes and the remaining-budget clamp
run) and the same model with other weights (low acceptance, so rejection,
rollback and the one-token fallback ticks run).

- Greedy tokens equal the reference's speculative engine's, the port's
  plain engine's and ``generate()``'s, dense and paged, with the armed
  auditor seeing one signature of each of draft, verify and fallback
  decode; a paged pool too small for every lookahead preempts and still
  gives the same tokens; a request may use the whole trained context.
- Mixed batches: sampled and opted-out rows ride the speculative ticks,
  and only speculating rows book drafts.
- The parameter swap under speculation changes the target only.
- ``_spec_accept`` on fixed logits commits what the reference's commits.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu.serving import engine as ref_engine_mod
from distkeras_tpu_torch.inference.generate import accept_prefix_length, greedy_accept_length
from distkeras_tpu_torch.models.bert import gpt_tiny
from distkeras_tpu_torch.serving import ServingEngine
from distkeras_tpu_torch.serving.engine import _spec_accept
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from distkeras_tpu_torch.utils.bridge import params_from_jax
from tests.test_torch_serving_engine import _pair, _prompts, _run_engine, _want
from tests.torch_time_limit import time_limited

SPEC_CALLABLES = ("serving_decode", "serving_draft", "serving_verify")
PAGED = dict(kv_pool_blocks=64, kv_block_tokens=4)


@pytest.fixture(scope="module")
def lm():
    return _pair()


def _bridged(lm, seed):
    ref = lm[0]
    variables = ref.init(seed)
    return variables, params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")


@pytest.fixture(scope="module")
def other(lm):
    """The same model with other weights: a draft whose proposals are
    mostly rejected."""
    return _bridged(lm, 11)


def _spec_port(lm, draft_params=None, *, auditor=None, spec_k=4, **kw):
    _, _, port, params = lm
    return ServingEngine(port, params, draft_model=port,
                         draft_variables=params if draft_params is None else draft_params,
                         spec_k=spec_k, auditor=auditor,
                         arm_auditor_after_warmup=auditor is not None, device="cpu", **kw)


def _spec_ref(lm, draft_variables=None, spec_k=4, **kw):
    ref, variables = lm[0], lm[1]
    return ref_engine_mod.ServingEngine(
        ref, variables, draft_model=ref,
        draft_variables=variables if draft_variables is None else draft_variables,
        spec_k=spec_k, **kw)


def _staggered(engine, jobs, **submit_kw):
    async def work():
        reqs = []
        for i, (p, n) in enumerate(jobs):
            reqs.append(engine.submit(p, n, **submit_kw))
            await asyncio.sleep(0.01 * i)
        return [await r.result() for r in reqs]

    return asyncio.run(_run_engine(engine, work()))


def _compile_once(auditor):
    for name in SPEC_CALLABLES:
        assert auditor.compiles(name) == 1, name


# -- parity ------------------------------------------------------------------------

@pytest.mark.parametrize("layout", [{}, PAGED], ids=["dense", "paged"])
@pytest.mark.parametrize("draft", ["self", "other"])
@time_limited
def test_spec_greedy_matches_reference_plain_engine_and_generate(lm, other, layout, draft):
    jobs = [(p, 6) for p in _prompts(41, (5, 9, 3, 7))]
    auditor = RecompileAuditor()
    draft_port = None if draft == "self" else other[1]
    draft_ref = None if draft == "self" else other[0]
    engine = _spec_port(lm, draft_port, auditor=auditor, slots=2, max_queue=8, **layout)
    got = _staggered(engine, jobs)
    ref_got = _staggered(_spec_ref(lm, draft_ref, slots=2, max_queue=8, **layout), jobs)
    plain = _staggered(ServingEngine(lm[2], lm[3], slots=2, max_queue=8, device="cpu",
                                     **layout), jobs)
    want = [_want(lm, p, n) for p, n in jobs]
    assert got == ref_got == plain == want
    _compile_once(auditor)
    rate = engine.metrics.summary()["spec_accept_rate"]
    if draft == "self":
        assert rate == 1.0
    else:
        assert rate < 1.0  # rejection, rollback and fallback really ran
    assert engine.active_slots == 0


@time_limited
def test_spec_mixed_temperature_and_opt_out_one_batch(lm):
    engine = _spec_port(lm, slots=3, max_queue=8, seed=3)
    p, p2 = _prompts(42, (5, 6))

    async def work():
        greedy = engine.submit(p, 8)
        hot = engine.submit(p, 8, temperature=5.0)
        optout = engine.submit(p2, 8, speculate=False)
        return [await r.result() for r in (greedy, hot, optout)]

    g, h, o = asyncio.run(_run_engine(engine, work()))
    assert g == _want(lm, p, 8)
    assert o == _want(lm, p2, 8)
    assert len(h) == 8 and all(0 <= t < 64 for t in h)
    assert engine.debugz()["speculative"]["spec_k"] == 4
    assert 0 < engine.metrics.spec_draft_tokens == engine.metrics.spec_accepted_tokens


@time_limited
def test_spec_shared_prefix_chunked_parity(lm):
    engine = _spec_port(lm, slots=2, max_queue=16, prefill_chunk=4, prefix_cache_mb=1.0,
                        prefix_block_tokens=4)
    shared = _prompts(43, (12,))[0]
    prompts = [shared + p for p in _prompts(44, (3, 4, 5, 3))]

    async def drive():
        return [await engine.submit(p, 5).result() for p in prompts]

    assert asyncio.run(_run_engine(engine, drive())) == [_want(lm, p, 5) for p in prompts]
    assert engine.prefix_cache.stats()["hit_requests"] >= 3
    assert engine.metrics.summary()["spec_accept_rate"] == 1.0


@time_limited
def test_spec_paged_preempt_resume_and_room_clamp_parity(lm):
    """An 8-block pool: preemption while streams speculate, lookahead
    allocations that fail under pressure, then a request using the whole
    trained context (20 + 12 = 32 tokens = the 8 blocks)."""
    auditor = RecompileAuditor()
    engine = _spec_port(lm, auditor=auditor, slots=2, max_queue=8, kv_pool_blocks=8,
                        kv_block_tokens=4)
    jobs = [(p, 10) for p in _prompts(45, (9, 8))]
    assert _staggered(engine, jobs) == [_want(lm, p, n) for p, n in jobs]
    assert engine.metrics.preemptions >= 1
    _compile_once(auditor)
    engine.reopen()
    p = _prompts(46, (20,))[0]
    assert _staggered(engine, [(p, 12)]) == [_want(lm, p, 12)]
    _compile_once(auditor)
    assert 0.8 < engine.metrics.summary()["spec_accept_rate"] <= 1.0


@pytest.mark.parametrize("layout", [{}, PAGED], ids=["dense", "paged"])
@time_limited
def test_spec_param_swap_changes_target_only(lm, layout):
    ref = lm[0]
    new_vars, new_params = _bridged(lm, 7)
    auditor = RecompileAuditor()
    engine = _spec_port(lm, auditor=auditor, slots=2, max_queue=8, **layout)
    p = _prompts(47, (5,))[0]

    async def work():
        before = await engine.submit(p, 6).result()
        ev, res = engine.request_param_swap(new_params)
        await ev.wait()
        assert res.get("ok"), res
        after = await engine.submit(p, 6).result()
        return before, after

    before, after = asyncio.run(_run_engine(engine, work()))
    assert before == _want(lm, p, 6)
    assert after == np.asarray(ref_generate(ref, new_vars, np.asarray([p], np.int32), 6,
                                            greedy=True))[0].tolist()
    assert engine.weight_version["version"] == 1
    _compile_once(auditor)


def test_spec_ctor_validation(lm):
    _, _, port, params = lm
    with pytest.raises(ValueError, match="draft_variables"):
        ServingEngine(port, params, draft_model=port, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(port, params, draft_model=port, draft_variables=params, spec_k=0,
                      device="cpu")
    wide = gpt_tiny(seq_len=32, vocab_size=128)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(port, params, draft_model=wide, draft_variables=params, device="cpu")


# -- the accept rule ------------------------------------------------------------------

def test_accept_length_helpers():
    drafts = torch.tensor([[1, 2, 3], [1, 9, 3], [9, 9, 9]], dtype=torch.int32)
    target = torch.tensor([[1, 2, 3], [1, 2, 3], [1, 2, 3]], dtype=torch.int32)
    assert greedy_accept_length(drafts, target).tolist() == [3, 1, 0]
    assert accept_prefix_length(torch.tensor([[True, False, True]])).tolist() == [1]


def test_spec_accept_matches_reference_on_fixed_inputs():
    """Greedy rows: a full accept, a reject at each offset, a draft within
    the 2-ulp band of a tie, the remaining-budget clamp, an opted-out row;
    plus one sampled row, which commits exactly one token."""
    B, K, V = 7, 4, 16
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((B, K, V)).astype(np.float32)
    best = logits.argmax(-1)
    drafts = best.copy()
    drafts[1, 0] = (best[1, 0] + 1) % V          # reject at offset 0
    drafts[2, 2] = (best[2, 2] + 1) % V          # reject at offset 2
    other = (best[3, 1] + 3) % V                 # a near-tie at offset 1
    logits[3, 1, other] = logits[3, 1, best[3, 1]] - 1e-3
    drafts[3, 1] = other
    tokens = rng.integers(0, V, size=(B,)).astype(np.int32)
    temps = np.array([0, 0, 0, 0, 0, 0, 1.5], np.float32)
    spec_ok = np.array([1, 1, 1, 1, 1, 0, 1], bool)
    remaining = np.array([9, 9, 9, 9, 2, 9, 9], np.int32)
    out, commit = _spec_accept(torch.tensor(logits), torch.tensor(drafts, dtype=torch.int32),
                               torch.tensor(tokens), torch.tensor(temps),
                               torch.tensor(spec_ok), torch.tensor(remaining),
                               torch.Generator().manual_seed(0), 4)
    want_out, want_commit = ref_engine_mod._spec_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(tokens), jnp.asarray(temps),
        jnp.asarray(spec_ok), jnp.asarray(remaining), jax.random.PRNGKey(0), 4)
    assert commit.tolist() == np.asarray(want_commit).tolist() == [4, 0, 2, 4, 2, 0, 1]
    greedy = slice(0, 6)
    np.testing.assert_array_equal(out.numpy()[greedy], np.asarray(want_out)[greedy])
    # The sampled row commits its offset-0 draw, which lies in the top 4.
    assert logits[6, 0, int(out[6, 0])] >= np.sort(logits[6, 0])[-4]
