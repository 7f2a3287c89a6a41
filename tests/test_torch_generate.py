"""The port's ``inference/generate.py`` against the reference's.

The cases of the reference's ``tests/test_generate.py`` that need no mesh,
on the port, plus cross-package checks: ``gpt_tiny(seq_len=32,
vocab_size=64)`` weights from the reference's init cross to the port
through ``utils/bridge.py``, and the same numpy prompts go through
``distkeras_tpu.generate``/``beam_search`` and the port's.

- Greedy tokens: identical in float32. In bfloat16 identical, or the first
  divergence of a row is a bf16 tie in the reference's own logits (its two
  candidates within one bf16 ulp of each other), which either side may
  break its way.
- Beam search in float32: the same sequences, and scores within 1e-5 (the
  same float32 arithmetic in another order; observed ~1e-6).
- Sampling draws from a ``torch.Generator``, not ``jax.random``, so it is
  checked for determinism, top-k membership and greedy rows, not against
  the reference's draws.
"""

import copy
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk_ref
import distkeras_tpu_torch as dk
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.mlp import mnist_mlp
from distkeras_tpu_torch.utils.bridge import params_from_jax

ref_gen = importlib.import_module("distkeras_tpu.inference.generate")
port_gen = importlib.import_module("distkeras_tpu_torch.inference.generate")

SEQ, VOCAB = 32, 64
BEAM_SCORE_ATOL = 1e-5


def _pair(dtype):
    """(reference model, its variables, port model, the bridged weights)."""
    ref = ref_bert.gpt_tiny(seq_len=SEQ, vocab_size=VOCAB)
    ref = ref_bert._make(dataclasses.replace(ref.config, dtype=getattr(jnp, dtype)),
                         SEQ, "gpt_tiny")
    port = port_bert.gpt_tiny(seq_len=SEQ, vocab_size=VOCAB)
    port = port_bert._make(dataclasses.replace(port.config, dtype=getattr(torch, dtype)),
                           SEQ, "gpt_tiny")
    variables = ref.init(0)
    return ref, variables, port, params_from_jax(jax.tree.map(np.asarray, variables),
                                                 device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


@pytest.fixture(scope="module")
def bf16():
    return _pair("bfloat16")


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(np.int32)


def _logits(port, params, tokens):
    """The port's no-cache full forward: last position's float32 logits."""
    with torch.inference_mode():
        return port.apply(params, torch.from_numpy(np.asarray(tokens, np.int32)))[0][:, -1]


def _rollout_nocache(port, params, prompt, n):
    """Full forward each step, the next token by ``greedy_ids``."""
    toks, out = np.asarray(prompt, np.int32), []
    for _ in range(n):
        nxt = port_gen.greedy_ids(_logits(port, params, toks)).numpy()
        out.append(nxt)
        toks = np.concatenate([toks, nxt[:, None]], axis=1)
    return np.stack(out, axis=1)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_matches_reference(dtype, request):
    ref, variables, port, params = request.getfixturevalue({"float32": "f32",
                                                             "bfloat16": "bf16"}[dtype])
    prompt = _prompt(0, (2, 5))
    want = np.asarray(dk_ref.generate(ref, variables, prompt, 8, greedy=True))
    got = dk.generate(port, params, prompt, 8, greedy=True, device="cpu")
    assert got.shape == (2, 8) and got.dtype == np.int32
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    for b in range(2):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size == 0:
            continue
        t = int(diff[0])
        # The reference's logits at the first divergence: a bf16 tie.
        tokens = np.concatenate([prompt[b:b + 1], want[b:b + 1, :t]], axis=1)
        logits = np.asarray(ref.apply(variables, jnp.asarray(tokens))[0], np.float32)[0, -1]
        a, c = logits[want[b, t]], logits[got[b, t]]
        assert abs(a - c) <= _bf16_ulp(max(abs(a), abs(c))), (b, t, a, c)


def test_greedy_matches_nocache_rollout(bf16):
    _, _, port, params = bf16
    prompt = _prompt(1, (2, 5))
    want = _rollout_nocache(port, params, prompt, 8)
    got = dk.generate(port, params, prompt, 8, greedy=True, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_sampling_shapes_and_determinism(bf16):
    _, _, port, params = bf16
    prompt = _prompt(2, (3, 4))
    a = dk.generate(port, params, prompt, 6, temperature=0.8, top_k=10, seed=7, device="cpu")
    b = dk.generate(port, params, prompt, 6, temperature=0.8, top_k=10, seed=7, device="cpu")
    c = dk.generate(port, params, prompt, 6, temperature=0.8, top_k=10, seed=8, device="cpu")
    assert a.shape == (3, 6) and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)  # same seed, same tokens
    assert (a != c).any()  # a different seed diverges somewhere
    assert (a >= 0).all() and (a < VOCAB).all()


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_sampled_tokens_lie_in_top_k(bf16, top_k):
    _, _, port, params = bf16
    prompt = _prompt(3, (3, 4))
    toks = dk.generate(port, params, prompt, 6, temperature=1.5, top_k=top_k, seed=5,
                       device="cpu")
    seq = prompt
    for t in range(toks.shape[1]):
        logits = _logits(port, params, seq).float()
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1]
        picked = logits[torch.arange(3), torch.from_numpy(toks[:, t]).long()]
        assert (picked >= kth).all(), (t, picked, kth)
        seq = np.concatenate([seq, toks[:, t:t + 1]], axis=1)
    if top_k == 1:
        np.testing.assert_array_equal(
            toks, dk.generate(port, params, prompt, 6, greedy=True, device="cpu"))


def test_rows_at_zero_temperature_are_greedy(bf16):
    """``sample_rows``: rows with temperature <= 0 take ``greedy_ids``;
    ``generate(temperature=0)`` equals greedy decoding."""
    _, _, port, params = bf16
    logits = torch.from_numpy(np.random.default_rng(4).normal(size=(4, VOCAB))
                              .astype(np.float32))
    temps = torch.tensor([0.0, 1.0, -1.0, 0.5])
    gen = torch.Generator().manual_seed(0)
    rows = port_gen.sample_rows(logits, temps, gen, top_k=None)
    greedy = port_gen.greedy_ids(logits)
    assert rows.dtype == torch.int32
    assert rows[0] == greedy[0] and rows[2] == greedy[2]
    prompt = _prompt(5, (2, 4))
    np.testing.assert_array_equal(
        dk.generate(port, params, prompt, 5, temperature=0.0, seed=3, device="cpu"),
        dk.generate(port, params, prompt, 5, greedy=True, device="cpu"))


def test_generator_wrapper_and_single_token(bf16):
    _, _, port, params = bf16
    gen = dk.Generator(port, params, device="cpu")
    prompt = _prompt(6, (1, 3))
    out = gen(prompt, 1, greedy=True)
    assert out.shape == (1, 1)
    np.testing.assert_array_equal(out, _rollout_nocache(port, params, prompt, 1))
    seqs, scores = gen.beam(prompt, 3, num_beams=2)
    assert seqs.shape == (1, 2, 3) and scores.shape == (1, 2)


def test_generate_with_none_input_shape(bf16):
    """``input_shape=None`` falls back to the config's ``max_seq_len``."""
    _, _, port, params = bf16
    m2 = copy.copy(port)
    m2.input_shape = None
    prompt = _prompt(7, (2, 4))
    np.testing.assert_array_equal(
        dk.generate(m2, params, prompt, 5, greedy=True, device="cpu"),
        dk.generate(port, params, prompt, 5, greedy=True, device="cpu"))


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_check_context_messages_match_reference(bf16):
    ref, variables, port, params = bf16
    long_prompt = _prompt(8, (1, 28))
    _, ref_cfg = ref_gen._decode_module(ref)
    _, port_cfg = port_gen._decode_module(port)
    for prompt, n in ((long_prompt, 8), (long_prompt[:, :4], 0), (long_prompt[0], 2)):
        want = _message(lambda: ref_gen._check_context(ref, ref_cfg, jnp.asarray(prompt), n))
        got = _message(lambda: port_gen._check_context(port, port_cfg, torch.from_numpy(prompt),
                                                       n))
        assert got == want
    assert port_gen._context_limit(port, port_cfg) == ref_gen._context_limit(ref, ref_cfg) == SEQ


def test_generate_rejects_bad_inputs(bf16):
    _, _, port, params = bf16
    prompt = _prompt(9, (1, 28))
    # gpt_tiny(seq_len=32) has cache capacity 64 but TRAINED context 32.
    with pytest.raises(ValueError, match="trained context"):
        dk.generate(port, params, prompt, 8, device="cpu")  # 28 + 8 > 32
    with pytest.raises(ValueError, match="trained context"):
        dk.beam_search(port, params, prompt, 8, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        dk.generate(port, params, prompt[:, :4], 2, top_k=2000, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        dk.generate(port, params, prompt[:, :4], 2, top_k=0, device="cpu")
    with pytest.raises(ValueError, match="num_beams"):
        dk.beam_search(port, params, prompt[:, :4], 2, num_beams=0, device="cpu")
    enc = port_bert.bert_tiny_mlm(seq_len=16)
    with pytest.raises(ValueError, match="causal"):
        dk.generate(enc, enc.init(0, device="cpu"), prompt[:, :4], 2, device="cpu")
    with pytest.raises(ValueError, match="bert zoo"):
        dk.generate(mnist_mlp(), {}, prompt[:, :4], 2, device="cpu")
    # A mesh is ported (batch-parallel decoding, tests/test_torch_sharded_serving.py):
    # what is not one is a typed error.
    with pytest.raises(TypeError, match="Mesh"):
        dk.generate(port, params, prompt[:, :4], 2, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        dk.beam_search(port, params, prompt[:, :4], 2, mesh=object(), device="cpu")


def test_beam_search_k1_equals_greedy(bf16):
    _, _, port, params = bf16
    prompt = _prompt(10, (2, 4))
    greedy = dk.generate(port, params, prompt, 6, greedy=True, device="cpu")
    seqs, scores = dk.beam_search(port, params, prompt, 6, num_beams=1, device="cpu")
    np.testing.assert_array_equal(seqs[:, 0], greedy)
    assert scores.shape == (2, 1) and seqs.dtype == np.int32 and scores.dtype == np.float32


def test_beam_search_matches_reference(f32):
    ref, variables, port, params = f32
    prompt = _prompt(11, (2, 4))
    want_seqs, want_scores = dk_ref.beam_search(ref, variables, prompt, 5, num_beams=3)
    seqs, scores = dk.beam_search(port, params, prompt, 5, num_beams=3, device="cpu")
    np.testing.assert_array_equal(seqs, np.asarray(want_seqs))
    np.testing.assert_allclose(scores, np.asarray(want_scores), atol=BEAM_SCORE_ATOL, rtol=0)
    assert (np.diff(scores, axis=1) <= 0).all()


def test_beam_search_scores_exact_and_sorted(f32):
    """A beam's score is its sequence's total log-probability under no-cache
    full forwards, the beams are sorted, and the best never scores below
    greedy (float32: within 1e-5)."""
    _, _, port, params = f32
    prompt = _prompt(12, (1, 4))
    n, K = 5, 4
    seqs, scores = dk.beam_search(port, params, prompt, n, num_beams=K, device="cpu")
    assert seqs.shape == (1, K, n) and scores.shape == (1, K)
    assert all(scores[0, i] >= scores[0, i + 1] for i in range(K - 1))

    def true_logprob(seq):
        toks, total = prompt, 0.0
        for t in seq:
            total += float(torch.log_softmax(_logits(port, params, toks), -1)[0, t])
            toks = np.concatenate([toks, [[t]]], axis=1).astype(np.int32)
        return total

    for b in range(K):
        assert abs(true_logprob(seqs[0, b]) - scores[0, b]) < BEAM_SCORE_ATOL
    greedy = dk.generate(port, params, prompt, n, greedy=True, device="cpu")
    assert scores[0, 0] >= true_logprob(greedy[0]) - BEAM_SCORE_ATOL


def test_top_k_breaks_ties_to_the_lower_index():
    """``beam_search``'s top-k puts the lower index first on a tie, as
    ``lax.top_k`` does."""
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]])
    values, idx = port_gen._top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 2, 4, 5]]
    assert values.tolist() == np.asarray(want_v).tolist()


def test_greedy_ids_with_bf16_ties_match_reference():
    """Logits that differ below bf16 resolution tie after the rounding; the
    lowest index wins in both packages (``torch.argmax`` returns the first
    maximum)."""
    rng = np.random.default_rng(13)
    logits = rng.normal(size=(6, VOCAB)).astype(np.float32)
    top = np.ceil(logits.max(axis=1)) + 1.0  # an integer: exact in bfloat16
    for r, cols in enumerate(([3, 9], [0, 63], [5, 6, 7], [40], [62, 63], [1, 30, 50])):
        # Distinct float32 values, each within half a bf16 ulp above the
        # integer, so all round to it.
        for j, c in enumerate(cols):
            logits[r, c] = np.float32(top[r] * (1 + j * 2.0 ** -12))
    assert logits[0, 3] < logits[0, 9]
    want = np.asarray(ref_gen.greedy_ids(jnp.asarray(logits)))
    got = port_gen.greedy_ids(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [3, 0, 5, 40, 62, 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_lengths_match_reference(seed):
    rng = np.random.default_rng(seed)
    match = rng.random((8, 6)) < 0.7
    match[0] = True
    match[1] = False
    want = np.asarray(ref_gen.accept_prefix_length(jnp.asarray(match)))
    got = port_gen.accept_prefix_length(torch.from_numpy(match))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    drafts = rng.integers(0, 4, size=(8, 6)).astype(np.int32)
    target = rng.integers(0, 4, size=(8, 6)).astype(np.int32)
    want = np.asarray(ref_gen.greedy_accept_length(jnp.asarray(drafts), jnp.asarray(target)))
    got = port_gen.greedy_accept_length(torch.from_numpy(drafts), torch.from_numpy(target))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_with_index_matches_reference(bf16):
    ref, _, port, _ = bf16
    ref_dec, _ = ref_gen._decode_module(ref, slots=True)
    _, dec_cfg = port_gen._decode_module(port, slots=True)
    want = ref_gen.cache_with_index(ref_gen._empty_cache(ref_dec, 3),
                                    jnp.asarray([4, 0, 7], jnp.int32))
    got = port_gen.cache_with_index(port_gen._empty_cache(dec_cfg, 3, "cpu"),
                                    torch.tensor([4, 0, 7]))
    assert got["pos_index"].tolist() == np.asarray(want["pos_index"]).tolist() == [4, 0, 7]
    assert got["layer_1.attention.cache_index"].dtype == torch.int32
    assert got["layer_1.attention.cached_key"].shape == (3, 64, 4, 32)
    scalar = port_gen.cache_with_index(port_gen._empty_cache(dec_cfg, 2, "cpu"), 5)
    assert scalar["pos_index"].tolist() == [5, 5]
