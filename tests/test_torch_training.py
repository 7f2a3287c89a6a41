"""Training, the slice as a whole, against the reference.

``bert_tiny_mlm`` and ``gpt_tiny`` (float32, flash attention on, dropout 0)
start from the reference's weights bridged across; the same seeded numpy
batches go through the reference's ``make_train_step`` / ``SingleTrainer``
(its Pallas kernels in interpret mode) and the port's (the plain versions
of its kernels). The optimizer is adagrad, the trainers' default: its update
``lr·g/sqrt(0.1 + Σg²)`` is smooth in g, so gradients that agree to float32
rounding give weights that agree as closely. (Adam's first update is about
``lr·sign(g)``, and the attention key bias has a gradient that is zero up
to rounding noise, so under Adam those weights may differ by up to lr.)

Tolerances: the loss of each step to 1e-5 relative and every weight after
the last step to 2e-6 absolute: the same float32 arithmetic in another
order, compounded over three steps of weights of magnitude ~0.1-1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.data.dataset import Dataset as RefDataset
from distkeras_tpu.data.feed import index_windows as ref_index_windows
from distkeras_tpu.data.feed import minibatches as ref_minibatches
from distkeras_tpu.data.feed import window_batches as ref_window_batches
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.ops.losses import get_optimizer as ref_get_optimizer
from distkeras_tpu.training.step import TrainState as RefTrainState
from distkeras_tpu.training.step import make_train_step as ref_make_train_step
from distkeras_tpu.training.trainers import SingleTrainer as RefSingleTrainer
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.feed import DeviceFeed, index_windows, minibatches, window_batches
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.bert import dropout
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.training.step import (
    TrainState,
    make_cached_window_train_step,
    make_train_step,
    make_window_train_step,
)
from distkeras_tpu_torch.training.trainers import SingleTrainer
from distkeras_tpu_torch.utils.bridge import params_from_jax

SEQ, VOCAB, BATCH, STEPS = 32, 256, 4, 3
LOSS = "fused_categorical_crossentropy"
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 2e-6


def _pair(name, dropout_rate=0.0):
    """(reference model, port model) of the same float32 config."""
    ref = getattr(ref_bert, name)(seq_len=SEQ, vocab_size=VOCAB)
    ref = ref_bert._make(dataclasses.replace(
        ref.config, use_flash_attention=True, dtype=jnp.float32,
        dropout_rate=dropout_rate), SEQ, name)
    port = getattr(port_bert, name)(seq_len=SEQ, vocab_size=VOCAB)
    port = port_bert._make(dataclasses.replace(
        port.config, use_flash_attention=True, dtype=torch.float32,
        dropout_rate=dropout_rate), SEQ, name)
    return ref, port


def _batches(seed, n=STEPS, batch=BATCH):
    rng = np.random.default_rng(seed)
    return [{"features": rng.integers(0, VOCAB, size=(batch, SEQ)).astype(np.int32),
             "label": rng.integers(0, VOCAB, size=(batch, SEQ)).astype(np.int32)}
            for _ in range(n)]


def _bridge(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _ref_train(ref, params, batches, accum):
    tx = ref_get_optimizer("adagrad")
    state = RefTrainState(params=params, model_state={}, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    step = ref_make_train_step(ref, tx, LOSS, donate=False, grad_accum_steps=accum)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, _bridge(state.params)


def _port_state(weights, optimizer="adagrad"):
    params = {k: v.clone().requires_grad_() for k, v in weights.items()}
    return TrainState(params, {}, get_optimizer(optimizer)(list(params.values())))


def _port_train(port, weights, batches, **step_kwargs):
    state = _port_state(weights)
    step = make_train_step(port, LOSS, **step_kwargs)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert m["loss"].ndim == 0 and m["accuracy"].ndim == 0
        losses.append(float(m["loss"]))
    return losses, {k: v.detach() for k, v in state.params.items()}


def _assert_weights_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=WEIGHT_ATOL,
                                   rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def runs():
    """Reference and port runs shared by the tests: for each model, the
    bridged initial weights and the reference's losses and final weights at
    grad_accum_steps 1 and 2."""
    out = {}
    for name in ("bert_tiny_mlm", "gpt_tiny"):
        ref, port = _pair(name)
        params = ref.init(0)["params"]
        batches = _batches(1)
        out[name] = {"port": port, "weights": _bridge(params), "batches": batches,
                     **{accum: _ref_train(ref, params, batches, accum) for accum in (1, 2)}}
    return out


@pytest.mark.parametrize("name", ["bert_tiny_mlm", "gpt_tiny"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(runs, name, accum):
    r = runs[name]
    want_losses, want_weights = r[accum]
    losses, weights = _port_train(r["port"], r["weights"], r["batches"],
                                  grad_accum_steps=accum)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    _assert_weights_close(weights, want_weights)


def test_remat_and_dropout_masks_repeat():
    """remat=True recomputes the forward in the backward pass; with dropout
    on, the recompute draws its masks again from the same seeds, so the run
    is the same as without remat."""
    _, port = _pair("bert_tiny_mlm", dropout_rate=0.1)
    weights = port.init(3, device="cpu")
    batches = _batches(2, n=2)
    plain = _port_train(port, weights, batches)
    remat = _port_train(port, weights, batches, remat=True)
    assert plain[0] == remat[0]
    for k in plain[1]:
        torch.testing.assert_close(remat[1][k], plain[1][k], rtol=0, atol=0)


def test_grad_accum_requires_a_divisible_batch(runs):
    r = runs["bert_tiny_mlm"]
    step = make_train_step(r["port"], LOSS, grad_accum_steps=3)
    batch = {k: torch.from_numpy(v) for k, v in r["batches"][0].items()}
    with pytest.raises(ValueError, match="not divisible"):
        step(_port_state(r["weights"]), batch)


def test_window_steps_match_single_steps(runs):
    """The window step and the device-cached window step are the train step
    in a loop: the same losses and weights as three single steps."""
    r = runs["gpt_tiny"]
    want_losses, want_weights = _port_train(r["port"], r["weights"], r["batches"])
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in r["batches"]]))
               for k in ("features", "label")}
    state, m = make_window_train_step(r["port"], LOSS)(_port_state(r["weights"]), stacked)
    np.testing.assert_allclose(m["loss"].numpy(), want_losses, rtol=1e-6)
    _assert_weights_close({k: v.detach() for k, v in state.params.items()}, want_weights)

    xcol, ycol = (v.reshape(-1, SEQ) for v in stacked.values())
    idx = torch.arange(STEPS * BATCH).reshape(STEPS, BATCH)
    state, m = make_cached_window_train_step(r["port"], LOSS)(
        _port_state(r["weights"]), xcol, ycol, idx)
    assert m["loss"].shape == (STEPS,) and state.step == STEPS
    np.testing.assert_allclose(m["loss"].numpy(), want_losses, rtol=1e-6)


@pytest.mark.parametrize("name", ["bert_tiny_mlm", "gpt_tiny"])
def test_single_trainer_matches_reference(runs, name):
    """SingleTrainer.train, shuffled over two epochs with a validation set,
    from the weights the reference's trainer initialises (seed 0). The port
    model's ``init`` is set to return them bridged."""
    ref, port = _pair(name)
    params = ref.init(jax.random.split(jax.random.PRNGKey(0))[0])
    weights = _bridge(params["params"])
    port.init = lambda seed=0, device=None: {k: v.clone() for k, v in weights.items()}
    cols = _batches(3, n=1, batch=8)[0]
    val = _batches(4, n=1, batch=4)[0]
    kw = dict(loss=LOSS, batch_size=4, num_epoch=2)
    ref_tr = RefSingleTrainer(ref, validation_data=RefDataset(val), **kw)
    want = ref_tr.train(RefDataset(cols), shuffle=True)
    tr = SingleTrainer(port, validation_data=Dataset(val), device="cpu", **kw)
    got = tr.train(Dataset(cols), shuffle=True)
    assert len(tr.get_history()) == len(ref_tr.get_history()) == 4
    for h, w in zip(tr.get_history(), ref_tr.get_history()):
        assert h.keys() == w.keys() == {"loss", "accuracy"}
        np.testing.assert_allclose(h["loss"], w["loss"], rtol=LOSS_RTOL)
        assert h["accuracy"] == pytest.approx(w["accuracy"], abs=1e-6)
    averaged = tr.get_averaged_history()
    np.testing.assert_allclose(averaged["loss"], ref_tr.get_averaged_history()["loss"],
                               rtol=LOSS_RTOL)
    assert len(tr.validation_history) == 2
    for h, w in zip(tr.validation_history, ref_tr.validation_history):
        assert h["epoch"] == w["epoch"]
        np.testing.assert_allclose(h["val_loss"], w["val_loss"], rtol=LOSS_RTOL)
    assert got.device == torch.device("cpu")
    _assert_weights_close(got.variables, _bridge(want.variables["params"]))


def test_dropout_keep_rate_scale_and_seed():
    """flax's Dropout semantics: kept with probability 1 - rate, kept values
    scaled by 1/(1 - rate), the rest 0, in the input's dtype; the same seed
    gives the same mask, another seed another one."""
    x = torch.ones(256, 1024, dtype=torch.bfloat16)
    y = dropout(x, 0.1, seed=5)
    assert y.dtype == torch.bfloat16
    kept = y != 0
    # 262144 Bernoulli(0.9) draws: the mean is within 5 sigma of 0.9.
    assert abs(kept.float().mean().item() - 0.9) < 5 * (0.09 / kept.numel()) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(dropout(x, 0.1, seed=5), y)
    assert not torch.equal(dropout(x, 0.1, seed=6), y)
    assert dropout(x, 0.0, seed=None) is x
    with pytest.raises(ValueError, match="seed"):
        dropout(x, 0.1, seed=None)


def test_feeds_match_reference():
    rng = np.random.default_rng(8)
    cols = {"features": rng.normal(size=(23, 3)).astype(np.float32), "label": np.arange(23)}
    want = list(ref_window_batches(ref_minibatches(RefDataset(cols), 4, num_epoch=2, seed=7), 3))
    got = list(window_batches(minibatches(Dataset(cols), 4, num_epoch=2, seed=7), 3))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in cols:
            np.testing.assert_array_equal(g[k], w[k])
    for g, w in zip(index_windows(23, 4, 3, num_epoch=2, seed=7),
                    ref_index_windows(23, 4, 3, num_epoch=2, seed=7)):
        np.testing.assert_array_equal(g, w)

    batches = list(minibatches(Dataset(cols), 5, seed=1))
    fed = list(DeviceFeed(iter(batches), device="cpu", buffer_size=2))
    assert len(fed) == len(batches)
    for f, b in zip(fed, batches):
        for k in cols:
            assert isinstance(f[k], torch.Tensor) and f[k].device.type == "cpu"
            np.testing.assert_array_equal(f[k].numpy(), b[k])
