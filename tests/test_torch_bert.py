"""The port's BERT/GPT forward against the reference's, on bridged weights.

The reference model (flax) is initialised from a seed; its params cross to
the port through ``utils/bridge.py``; seeded numpy token ids go through
both. Flash attention is on, as on the slice's path (the reference runs its
Pallas kernel in interpret mode).

Tolerances: float32 logits to 2e-5 absolute (the algorithm: the same
float32 arithmetic in another order; the observed gap is ~1e-6 on logits of
std ~0.22). bfloat16 logits to 3e-2 absolute: the two frameworks round
bfloat16 at different places (GELU in one rounding against per-op
rounding, P against a block max against the row max, bias folded into the
matmul or not), a few bfloat16 ulps (2^-7 at magnitude 1-2) on the logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.checkpoint import save_weights_file
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.core import TrainedModel
from distkeras_tpu_torch.utils.bridge import (
    load_weights_file,
    params_from_jax,
    params_to_jax,
)

SEQ = 64
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(name, dtype, flash=True):
    """(reference model, port model) of the same config."""
    ref = getattr(ref_bert, name)(seq_len=SEQ)
    ref_cfg = dataclasses.replace(ref.config, use_flash_attention=flash,
                                  dtype=getattr(jnp, dtype), dropout_rate=0.0)
    port = getattr(port_bert, name)(seq_len=SEQ)
    port_cfg = dataclasses.replace(port.config, use_flash_attention=flash,
                                   dtype=getattr(torch, dtype), dropout_rate=0.0)
    return (ref_bert._make(ref_cfg, SEQ, name), port_bert._make(port_cfg, SEQ, name))


def _tokens(seed, n=2):
    return np.random.default_rng(seed).integers(0, 1024, size=(n, SEQ)).astype(np.int32)


@pytest.mark.parametrize("name,dtype,flash", [
    ("bert_tiny_mlm", "float32", True),
    ("bert_tiny_mlm", "bfloat16", True),
    ("gpt_tiny", "float32", True),
    ("gpt_tiny", "bfloat16", True),
    ("gpt_tiny", "float32", False),
])
def test_logits_match_reference(name, dtype, flash):
    ref, port = _pair(name, dtype, flash)
    variables = ref.init(0)
    x = _tokens(1)
    want = np.asarray(ref.apply(variables, jnp.asarray(x))[0])
    state = params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    got = TrainedModel(port, state).predict(x)
    assert got.shape == want.shape == (2, SEQ, 1024) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


def test_weight_file_round_trip(tmp_path):
    """A real reference weight file read by the port's numpy reader gives
    the same weights, and logits, as bridging the live params; bfloat16
    leaves come back from their uint16 view bit for bit."""
    ref, port = _pair("bert_tiny_mlm", "float32")
    variables = ref.init(0)
    path = str(tmp_path / "w.npz")
    save_weights_file(path, variables)
    direct = params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    loaded = params_from_jax(load_weights_file(path), device="cpu")
    assert direct.keys() == loaded.keys() == port.module.state_dict().keys()
    for k in direct:
        assert torch.equal(direct[k], loaded[k]), k
    trained = TrainedModel(port, direct)
    trained.load_weights(path)
    x = _tokens(2)
    np.testing.assert_array_equal(trained.predict(x), TrainedModel(port, direct).predict(x))

    bf16 = {"params": {"w": jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32),
                                        jnp.bfloat16)}}
    save_weights_file(str(tmp_path / "b.npz"), bf16)
    back = load_weights_file(str(tmp_path / "b.npz"))["params"]["w"]
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(bf16["params"]["w"], np.float32))


def test_params_to_jax_round_trip():
    ref, port = _pair("gpt_tiny", "float32")
    variables = jax.tree.map(np.asarray, ref.init(0))
    back = params_to_jax(params_from_jax(variables, device="cpu"), port.module)
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_port_init_draws_the_reference_distributions():
    port = port_bert.bert_tiny_mlm(seq_len=SEQ)
    state = port.init(3, device="cpu")
    assert state.keys() == port.module.state_dict().keys()
    assert port.count_params() == sum(v.numel() for v in state.values())
    emb = state["token_embed.weight"]
    assert abs(emb.std().item() - 0.02) < 2e-3
    kernel = state["layer_0.mlp_in.weight"]  # [512, 128]: fan_in 128
    assert abs(kernel.std().item() - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert torch.count_nonzero(state["mlm_bias"]) == 0
    again = port.init(3, device="cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)


@pytest.mark.parametrize("field,value", [
    ("ring_mesh", object()), ("tp_mesh", object()),
    ("paged_blocks", 8), ("moe_experts", 4),
])
def test_later_slice_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="slice"):
        port_bert.BertConfig(**{field: value})
