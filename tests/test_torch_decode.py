"""The port's decode mode of ``models/bert.py`` against the reference's.

``gpt_tiny(seq_len=32, vocab_size=64)`` weights from the reference's init
cross to the port through ``utils/bridge.py``; the reference's decode module
(``Bert(dec_cfg).apply(..., mutable=["cache"])``) and the port's
(``apply({**params, **cache}, tokens)``) run the same numpy tokens: a
prefill of 5 tokens, then 6 one-token steps, in float32 and bfloat16,
without and with ``decode_slots`` (the slot rows rewound to different depths
through ``cache_with_index`` after the prefill). After every apply the
logits and every cache leaf are compared (the reference's cache carried
into the port's layout by ``cache_from_jax``).

Tolerances: float32 logits and K/V within 1e-5 in relative norm (the same
float32 arithmetic in another order; observed ~1e-6). bfloat16 logits
within 0.0078 absolute, one bf16 ulp at the logits' magnitude (< 2), the
envelope of the non-decode forward (the two frameworks round bf16 LayerNorm,
GELU and the biased q/k/v/mlp_in products at different places); observed
0.0049. bfloat16 K/V within one bf16 ulp at the leaf's largest magnitude
(2^-7 of the power of two at or below it): |K| and |V| reach 3.1-3.7 here,
where one ulp is 0.0156, and the observed gap is that one ulp. The position
and cache indices exactly.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.utils.bridge import cache_from_jax, cache_to_jax, params_from_jax

# The reference's package exports a function of the module's name.
ref_gen = importlib.import_module("distkeras_tpu.inference.generate")
port_gen = importlib.import_module("distkeras_tpu_torch.inference.generate")

SEQ, VOCAB, B = 32, 64, 2
PREFILL, STEPS = 5, 6
F32_REL = 1e-5
BF16_LOGITS_ATOL = 0.0078


def _models(dtype):
    ref = ref_bert.gpt_tiny(seq_len=SEQ, vocab_size=VOCAB)
    ref = ref_bert._make(dataclasses.replace(ref.config, dtype=getattr(jnp, dtype)),
                         SEQ, "gpt_tiny")
    port = port_bert.gpt_tiny(seq_len=SEQ, vocab_size=VOCAB)
    port = port_bert._make(dataclasses.replace(port.config, dtype=getattr(torch, dtype)),
                           SEQ, "gpt_tiny")
    return ref, port


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _bf16_ulps(want, got):
    """Largest difference in bf16 ulps at the leaf's largest magnitude."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(want - got).max() / ulp)


def _tokens():
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, VOCAB, size=(B, PREFILL)).astype(np.int32)
    return [prompt] + [rng.integers(0, VOCAB, size=(B, 1)).astype(np.int32)
                       for _ in range(STEPS)]


@pytest.mark.parametrize("slots", [False, True], ids=["dense", "slots"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_and_cache_match_reference(dtype, slots):
    ref, port = _models(dtype)
    variables = ref.init(0)
    params = params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    ref_dec, _ = ref_gen._decode_module(ref, slots=slots)
    port_dec, dec_cfg = port_gen._decode_module(port, slots=slots)
    ref_cache = ref_gen._empty_cache(ref_dec, B)
    cache = port_gen._empty_cache(dec_cfg, B, "cpu")
    for i, tokens in enumerate(_tokens()):
        if slots and i == 1:
            # Row 1 rewinds to depth 3: its rows 3-4 are overwritten, and
            # masked until then.
            ref_cache = ref_gen.cache_with_index(ref_cache, jnp.asarray([PREFILL, 3], jnp.int32))
            cache = port_gen.cache_with_index(cache, torch.tensor([PREFILL, 3]))
        want, mut = ref_dec.apply({"params": variables["params"], "cache": ref_cache},
                                  jnp.asarray(tokens), train=False, mutable=["cache"])
        ref_cache = mut["cache"]
        with torch.inference_mode():
            got, cache = port_dec.apply({**params, **cache}, torch.from_numpy(tokens))
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape == (B, tokens.shape[1], VOCAB)
        assert got.dtype == torch.float32
        if dtype == "float32":
            assert _rel(want, got.numpy()) < F32_REL, (i, _rel(want, got.numpy()))
        else:
            err = float(np.abs(want - got.numpy()).max())
            assert err <= BF16_LOGITS_ATOL, (i, err)
        ref_leaves = cache_from_jax(jax.tree.map(np.asarray, ref_cache), device="cpu")
        assert set(ref_leaves) == set(cache)
        for name, want_leaf in ref_leaves.items():
            got_leaf = cache[name]
            assert got_leaf.dtype == want_leaf.dtype and got_leaf.shape == want_leaf.shape, name
            if "index" in name:
                assert torch.equal(got_leaf, want_leaf), (i, name, got_leaf, want_leaf)
            elif dtype == "float32":
                assert _rel(want_leaf, got_leaf) < F32_REL, (i, name)
            else:
                assert _bf16_ulps(want_leaf.float(), got_leaf.float()) <= 1.0, (i, name)


def test_cache_layout_round_trips():
    """``cache_to_jax`` inverts ``cache_from_jax`` leaf for leaf, in each
    leaf's dtype; the reference's decode module takes the carried cache."""
    ref, port = _models("bfloat16")
    ref_dec, _ = ref_gen._decode_module(ref, slots=True)
    variables = ref.init(0)
    tokens = _tokens()[0]
    _, mut = ref_dec.apply({"params": variables["params"],
                            "cache": ref_gen._empty_cache(ref_dec, B)},
                           jnp.asarray(tokens), train=False, mutable=["cache"])
    ported = cache_from_jax(jax.tree.map(np.asarray, mut["cache"]), device="cpu")
    back = cache_to_jax(ported)
    again = cache_from_jax(back, device="cpu")
    assert set(again) == set(ported) and all(torch.equal(again[k], ported[k]) for k in ported)
    assert ported["layer_0.attention.cached_key"].dtype == torch.bfloat16
    assert ported["pos_index"].dtype == torch.int32
    assert list(ported["pos_index"]) == [PREFILL, PREFILL]


def test_positions_clamp_as_the_reference():
    """Without slots the positional window start clamps to ``max_seq_len -
    S`` (``lax.dynamic_slice``) and the counter runs on; with slots each
    position clips on its own. Both against the reference at a counter
    past the table's end."""
    ref, port = _models("float32")
    variables = ref.init(0)
    params = params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    tokens = np.arange(4, dtype=np.int32).reshape(1, 4) % VOCAB
    for slots in (False, True):
        ref_dec, _ = ref_gen._decode_module(ref, slots=slots)
        port_dec, dec_cfg = port_gen._decode_module(port, slots=slots)
        L = dec_cfg.max_seq_len
        ref_cache = jax.tree.map(
            lambda a: jnp.full_like(a, L - 2) if a.dtype == jnp.int32 else a,
            ref_gen._empty_cache(ref_dec, 1))
        cache = {k: torch.full_like(v, L - 2) if v.dtype == torch.int32 else v
                 for k, v in port_gen._empty_cache(dec_cfg, 1, "cpu").items()}
        want, mut = ref_dec.apply({"params": variables["params"], "cache": ref_cache},
                                  jnp.asarray(tokens), train=False, mutable=["cache"])
        got, new = port_dec.apply({**params, **cache}, torch.from_numpy(tokens))
        assert _rel(np.asarray(want), got.numpy()) < F32_REL, slots
        assert int(np.asarray(mut["cache"]["pos_index"]).reshape(-1)[0]) == \
            int(new["pos_index"].reshape(-1)[0]) == (L if slots else L + 2)


def test_paged_decode_is_refused():
    """The paged geometry is accepted now (``tests/test_torch_paged_kv.py``
    holds it against the reference); what stays refused is a paged apply
    without its positions and block tables, with the reference's message."""
    _, port = _models("float32")
    dec, cfg = port_gen._decode_module(port, slots=True, paged_blocks=8)
    params = port.init(0, device="cpu")
    cache = port_bert.decode_cache(cfg, 1, "cpu")
    tokens = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"paged decode needs positions \[B\]$"):
        dec.apply({**params, **cache}, tokens)
    with pytest.raises(ValueError, match="block_tables"):
        dec.apply({**params, **cache}, tokens, positions=torch.zeros(1, dtype=torch.int32))


def test_decode_cache_len_caps_the_cache():
    """``decode_cache_len`` shrinks the K/V caches below ``max_seq_len``
    (the position table is untouched); float32 against the reference with
    slots. The last two steps run past the cache's end: their writes clamp
    onto its last row and the index stays at the cap, as in the
    reference."""
    ref, port = _models("float32")
    variables = ref.init(0)
    params = params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    cap = PREFILL + STEPS - 2
    ref_dec, _ = ref_gen._decode_module(ref, slots=True, decode_cache_len=cap)
    port_dec, dec_cfg = port_gen._decode_module(port, slots=True, decode_cache_len=cap)
    ref_cache = ref_gen._empty_cache(ref_dec, B)
    cache = port_gen._empty_cache(dec_cfg, B, "cpu")
    assert cache["layer_0.attention.cached_key"].shape == (B, cap, 4, 32)
    for tokens in _tokens():
        want, mut = ref_dec.apply({"params": variables["params"], "cache": ref_cache},
                                  jnp.asarray(tokens), train=False, mutable=["cache"])
        ref_cache = mut["cache"]
        with torch.inference_mode():
            got, cache = port_dec.apply({**params, **cache}, torch.from_numpy(tokens))
        assert _rel(np.asarray(want), got.numpy()) < F32_REL
    ref_leaves = cache_from_jax(jax.tree.map(np.asarray, ref_cache), device="cpu")
    for name, want_leaf in ref_leaves.items():
        if "index" in name:
            assert torch.equal(cache[name], want_leaf), name
        else:
            assert _rel(want_leaf, cache[name]) < F32_REL, name
    assert cache["layer_1.attention.cache_index"].tolist() == [cap, cap]
