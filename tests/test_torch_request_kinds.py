"""The request kinds of the paged engine (``score``, ``embed``, ``sample``)
and constrained decoding, on the port against the reference.

``gpt_tiny(seq_len=32, vocab_size=64)`` in float32 on both sides, the
reference's weights bridged to the port:

- ``score`` log-probabilities and ``embed`` vectors equal the reference
  engine's (rtol 1e-5), chunked or not, and the port's own full forward;
- ``sample`` forks are ``n`` greedy continuations equal to ``generate()``'s,
  their prompt blocks shared copy-on-write: the pool's fork accounting
  (shared rows, CoW copies, drained refcounts) equals the reference's and
  a flush returns every block;
- masked greedy rows obey their ``TokenDFA`` on every token, a terminal
  state ends the stream, and an unconstrained neighbour is untouched;
  one decode signature under an armed auditor in a mixed batch of every
  kind;
- every contradictory submission raises the reference's error, message
  for message.
"""

import asyncio

import numpy as np
import pytest
import torch

from distkeras_tpu.serving.constraints import TokenDFA as RefTokenDFA
from distkeras_tpu_torch.serving.constraints import MASK_NEG, TokenDFA
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from tests.test_torch_serving_engine import _pair, _port, _prompts, _ref, _run_engine, _want
from tests.torch_time_limit import time_limited

PAGED = dict(kv_pool_blocks=64, kv_block_tokens=4)


@pytest.fixture(scope="module")
def lm():
    return _pair()


def _one(engine, prompt, new, **kw):
    async def work():
        req = engine.submit(prompt, new, **kw)
        await req.result()
        return req

    return asyncio.run(_run_engine(engine, work()))


def _full_forward(lm, prompt, hidden=False):
    _, _, port, params = lm
    with torch.inference_mode():
        out = port.apply(params, torch.tensor([prompt], dtype=torch.int32),
                         return_hidden=hidden)[0][0]
    return out.double().numpy()


# -- score and embed -----------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 4])
@time_limited
def test_score_logprobs_match_reference_engine_and_full_forward(lm, chunk):
    p = _prompts(31, (11,))[0]
    got = _one(_port(lm, slots=2, prefill_chunk=chunk, **PAGED), p, 0, kind="score")
    ref = _one(_ref(lm, slots=2, prefill_chunk=chunk, **PAGED), p, 0, kind="score")
    assert got.out_tokens == [] and len(got.logprobs) == len(p) - 1
    np.testing.assert_allclose(got.logprobs, ref.logprobs, rtol=1e-5, atol=1e-6)
    logits = _full_forward(lm, p)
    top = logits.max(-1, keepdims=True)
    logp = logits - top - np.log(np.exp(logits - top).sum(-1, keepdims=True))
    want = [logp[i, p[i + 1]] for i in range(len(p) - 1)]
    np.testing.assert_allclose(got.logprobs, want, rtol=1e-5, atol=1e-5)
    assert got.ttft > 0


@pytest.mark.parametrize("chunk", [None, 4])
@time_limited
def test_embed_matches_reference_engine_and_mean_pooled_hidden(lm, chunk):
    p = _prompts(32, (7,))[0]
    got = _one(_port(lm, slots=2, prefill_chunk=chunk, **PAGED), p, 0, kind="embed")
    ref = _one(_ref(lm, slots=2, prefill_chunk=chunk, **PAGED), p, 0, kind="embed")
    np.testing.assert_allclose(got.embedding, ref.embedding, rtol=1e-5, atol=1e-6)
    want = _full_forward(lm, p, hidden=True).mean(axis=0)
    np.testing.assert_allclose(got.embedding, want, rtol=1e-5, atol=1e-5)


# -- sample forks ---------------------------------------------------------------------

def _fork_stats(engine):
    s = engine.kv_pool.stats()
    return {k: s[k] for k in ("fork_shared_blocks", "forked_blocks_total",
                              "fork_cow_copies", "blocks_used", "inserted_blocks")}


@pytest.mark.parametrize("plen", [9, 8])  # a partial tail block, and none
@time_limited
def test_fork_parity_and_exact_cow_accounting(lm, plen):
    p = _prompts(33, (plen,))[0]
    want = _want(lm, p, 6)
    port = _port(lm, slots=4, max_queue=16, **PAGED)
    ref = _ref(lm, slots=4, max_queue=16, **PAGED)
    got = _one(port, p, 6, kind="sample", n=3, speculate=False)
    theirs = _one(ref, p, 6, kind="sample", n=3, speculate=False)
    assert got.fork_completions == theirs.fork_completions == [want] * 3
    assert _fork_stats(port) == _fork_stats(ref)
    assert port.kv_pool.fork_cow_copies == (2 if plen % 4 else 0)
    assert port.metrics.fork_blocks == ref.metrics.fork_blocks > 0
    assert port.kv_pool._fork_refs == {}
    port.kv_pool.flush()
    assert port.kv_pool.blocks_free == port.kv_pool.capacity


@time_limited
def test_sampled_forks_are_seeded_and_within_top_k(lm):
    p = _prompts(34, (6,))[0]

    def run(seed):
        engine = _port(lm, slots=4, seed=seed, top_k=8, **PAGED)
        return _one(engine, p, 5, kind="sample", n=3, speculate=False,
                    temperature=3.0).fork_completions

    a, b = run(5), run(5)
    assert a == b
    for fork in a:
        seq = list(p)
        for tok in fork:
            logits = _full_forward(lm, seq)[-1]
            assert logits[tok] >= np.sort(logits)[-8]
            seq.append(tok)


# -- constrained decoding --------------------------------------------------------------

def _alternating():
    """Tokens must alternate 1, 2, 1, 2, ... (no terminal state)."""
    return {"start": 0, "edges": [[0, 1, 1], [1, 2, 0]]}


@time_limited
def test_masked_greedy_obeys_automaton_every_token(lm):
    p = _prompts(35, (6,))[0]
    terminal = {"start": 0, "edges": [[0, 3, 1], [1, 4, 2]]}  # 3, 4, stop

    def run(engine):
        async def work():
            alt = engine.submit(p, 6, constraint=_alternating())
            fin = engine.submit(p, 6, constraint=terminal)
            plain = engine.submit(p, 6)
            return [await r.result() for r in (alt, fin, plain)]

        return asyncio.run(_run_engine(engine, work()))

    port = _port(lm, slots=3, max_queue=8, constrained=True, **PAGED)
    got = run(port)
    assert got == run(_ref(lm, slots=3, max_queue=8, constrained=True, **PAGED))
    assert got == [[1, 2, 1, 2, 1, 2], [3, 4], _want(lm, p, 6)]
    assert port.decode_compile_count() == 1


def test_token_dfa_copy_matches_reference():
    spec = {"start": 0, "edges": [[0, 5, 1], [1, 6, 0], [0, 7, 2]]}
    a, b = TokenDFA.from_spec(spec), RefTokenDFA.from_spec(spec)
    for state in (0, 1, 2):
        np.testing.assert_array_equal(a.mask_row(state, 10), b.mask_row(state, 10))
        assert a.is_terminal(state) == b.is_terminal(state)
    assert a.valid_prefix(0, [5, 6, 7, 9]) == b.valid_prefix(0, [5, 6, 7, 9]) == 3
    assert a.max_token() == 7 and float(MASK_NEG) == -1e9


@time_limited
def test_mixed_batch_armed_auditor_one_decode_signature(lm):
    """generate + sample forks + a constrained row in one decode batch,
    score and embed on the prefill path, under an armed auditor."""
    prompts = _prompts(36, (5, 7, 6, 4, 8))
    auditor = RecompileAuditor()
    engine = _port(lm, slots=4, max_queue=16, constrained=True, auditor=auditor,
                   arm_auditor_after_warmup=True, **PAGED)

    async def work():
        gen = engine.submit(prompts[0], 5)
        await asyncio.sleep(0.02)  # decode starts; the auditor arms
        fork = engine.submit(prompts[1], 4, kind="sample", n=2, speculate=False)
        con = engine.submit(prompts[2], 4, constraint=_alternating())
        score = engine.submit(prompts[3], 0, kind="score")
        embed = engine.submit(prompts[4], 0, kind="embed")
        reqs = (gen, fork, con, score, embed)
        await asyncio.gather(*(r.result() for r in reqs))
        return reqs

    gen, fork, con, score, embed = asyncio.run(_run_engine(engine, work()))
    assert gen.out_tokens == _want(lm, prompts[0], 5)
    assert fork.fork_completions == [_want(lm, prompts[1], 4)] * 2
    assert con.out_tokens == [1, 2, 1, 2]
    assert len(score.logprobs) == 3 and len(embed.embedding) == 128
    assert auditor.compiles("serving_decode") == 1
    kinds = engine.metrics.kind_counters()
    assert kinds["generate"] == 2 and kinds["sample"] == 1
    assert kinds["score"] == 1 and kinds["embed"] == 1
    assert engine.debugz()["request_kinds"] == kinds
    assert engine.active_slots == 0


# -- validation ---------------------------------------------------------------------------

BAD_SUBMITS = [
    ([1, 2], 4, {"kind": "score"}),                         # score decodes nothing
    ([1, 2], 0, {"kind": "embed", "n": 2}),                 # n outside sample
    ([1, 2], 4, {"n": 3}),                                  # n needs kind="sample"
    ([1, 2], 4, {"kind": "sample", "n": 1}),                # a fork of one
    ([1, 2], 4, {"kind": "sample", "n": 99}),               # n > slots
    ([1, 2], 4, {"kind": "nope"}),
    ([1, 2], 4, {"constraint": {"start": 0, "edges": [[0, 1, 0]]}}),  # no mask hook
    (list(range(33)), 0, {"kind": "score"}),                # past the context
]


@pytest.mark.parametrize("case", range(len(BAD_SUBMITS)))
def test_submit_validation_errors_equal_reference(lm, case):
    prompt, n, kw = BAD_SUBMITS[case]
    errors = []
    for make in (_port, _ref):
        engine = make(lm, slots=2, **PAGED)
        with pytest.raises(Exception) as info:
            engine.submit(prompt, n, **kw)
        errors.append((type(info.value).__name__, str(info.value),
                       getattr(info.value, "code", None)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("spec", [
    {"start": 0, "edges": [[0, 64, 1]]},   # token past the vocabulary
    {"start": 0, "edges": [[0, 1]]},       # malformed edge
])
def test_constraint_validation_errors_equal_reference(lm, spec):
    errors = []
    for make in (_port, _ref):
        engine = make(lm, slots=2, constrained=True, **PAGED)
        with pytest.raises(ValueError) as info:
            engine.submit([1, 2], 4, constraint=spec)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
