"""The port's fused softmax cross-entropy, forward and backward, and its loss
and optimizer registries against the reference's (Pallas kernels in
interpret mode on the CPU, optax).

Ragged shapes (T = 37 rows, V = 1000 columns) exercise the reference's
padding of T with dummy rows and V with -1e30 columns, which the port
replaces with masks. Tolerances: rtol 1e-5 on the float32 mean loss (the
same float32 logsumexp summed in another order); 1e-5 too for bfloat16
logits, since both sides widen them to float32 before any arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.ops.losses import LOSSES as REF_LOSSES
from distkeras_tpu.ops.losses import get_optimizer as ref_get_optimizer
from distkeras_tpu.ops.pallas.fused_xent import fused_softmax_xent as ref_xent
from distkeras_tpu_torch.ops.fused_xent import (
    fused_softmax_xent,
    xent_forward,
    xent_forward_reference,
    xent_grad,
    xent_stats,
)
from distkeras_tpu_torch.ops.losses import LOSSES, get_loss, get_optimizer

RTOL = 1e-5


def _data(seed, T, V):
    rng = np.random.default_rng(seed)
    logits = np.asarray(rng.normal(size=(T, V)) * 3, np.float32)
    labels = rng.integers(0, V, size=T).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,V", [(37, 1000), (64, 512)])
def test_xent_matches_reference(dtype, T, V):
    logits, labels = _data(0, T, V)
    ref = float(ref_xent(jnp.asarray(logits, dtype), labels))
    x = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = float(fused_softmax_xent(x, torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_xent_sequence_shaped_inputs():
    rng = np.random.default_rng(1)
    logits = np.asarray(rng.normal(size=(2, 16, 300)), np.float32)
    labels = rng.integers(0, 300, size=(2, 16)).astype(np.int32)
    ref = float(ref_xent(logits, labels, block_t=8, block_v=64))
    got = float(fused_softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_fused_loss_one_hot_falls_back():
    """One-hot targets take plain categorical CE on both sides."""
    logits, labels = _data(2, 12, 40)
    onehot = np.eye(40, dtype=np.float32)[labels]
    ref = float(REF_LOSSES["fused_categorical_crossentropy"](logits, onehot))
    got = float(get_loss("fused_categorical_crossentropy")(
        torch.from_numpy(logits), torch.from_numpy(onehot)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_registry_matches_reference(name):
    rng = np.random.default_rng(3)
    if name in ("binary_crossentropy", "mse", "mean_squared_error", "mae",
                "mean_absolute_error"):
        preds = np.asarray(rng.normal(size=(16, 1)), np.float32)
        targets = (rng.random((16,)) > 0.5).astype(np.float32)
    else:
        preds, targets = _data(4, 16, 10)
    ref = float(REF_LOSSES[name](preds, targets))
    got = float(get_loss(name)(torch.from_numpy(preds), torch.from_numpy(targets)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        get_loss("nope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_gradient_matches_reference(dtype):
    """The gradient of fused_softmax_xent (the plain K5 and K6) against
    jax.grad through the reference's Pallas kernels, at an odd vocabulary
    (which the reference pads with -1e30 columns) and with labels out of
    range on both sides of it (which pick no column). Held element by
    element, so that the many small entries count as much as the label
    column: float32 to 1e-5 relative (the same float32 softmax summed in
    another order); bfloat16 to 2**-7 relative, one bfloat16 rounding of the
    same float32 values. The absolute floor, 1e-15, lies far below the
    smallest entry (about 3e-12 here)."""
    logits, labels = _data(5, 37, 1000)
    labels[:3] = [-1, 4096, -7]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.grad(lambda x: ref_xent(x, labels))(jnp.asarray(logits, jdt)),
                      np.float32)
    x = torch.from_numpy(logits).to(tdt).requires_grad_()
    (got,) = torch.autograd.grad(fused_softmax_xent(x, torch.from_numpy(labels)), (x,))
    assert got.dtype == tdt
    rtol = RTOL if dtype == "float32" else 2**-7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-15)
    # Out-of-range rows: softmax only, no -1 anywhere.
    assert (got[:3].float() >= 0).all()


def test_xent_stats_and_grad_plain_versions():
    """K5's and K6's plain versions against numpy, row by row."""
    logits, labels = _data(9, 6, 50)
    labels[0] = 50  # out of range: no onehot
    g = np.linspace(0.5, 2.0, 6).astype(np.float32)
    m, s = xent_stats(torch.from_numpy(logits))
    np.testing.assert_allclose(m.numpy(), logits.max(1), rtol=0)
    np.testing.assert_allclose(s.numpy(), np.exp(logits - logits.max(1, keepdims=True)).sum(1),
                               rtol=1e-6)
    d = xent_grad(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(g), m, s)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[np.arange(1, 6), labels[1:]] -= 1
    np.testing.assert_allclose(d.numpy(), p * g[:, None], rtol=1e-5, atol=1e-7)



def test_cpu_tensors_take_the_plain_version():
    logits, labels = (torch.from_numpy(a) for a in _data(6, 9, 33))
    before = xent_forward.launches
    assert torch.equal(xent_forward(logits, labels), xent_forward_reference(logits, labels))
    assert xent_forward.launches == before


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw", "adagrad",
                                  "adadelta", "rmsprop"])
def test_optimizers_match_optax(name):
    """Five updates from the same fixed gradients, default learning rates,
    against the reference's optax transformation of the same name. One
    gradient is zero at first, where adagrad's accumulator rule matters.
    float32 to 1e-6: the same update rules, rounded in another order."""
    rng = np.random.default_rng(10)
    p0 = {"w": np.asarray(rng.normal(size=(4, 3)), np.float32), "b": np.zeros(3, np.float32)}
    grads = [{k: np.asarray(rng.normal(size=v.shape), np.float32) for k, v in p0.items()}
             for _ in range(5)]
    grads[0]["b"][:] = 0
    tx = ref_get_optimizer(name)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)
    port = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p0.items()}
    opt = get_optimizer(name)(list(port.values()))
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        for k, t in port.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(port[k].detach().numpy(), np.asarray(params[k]),
                                   atol=1e-6, rtol=0)


def test_optimizer_learning_rate_and_unknown_name():
    assert get_optimizer("adam", 0.5)([torch.zeros(1, requires_grad=True)]).defaults["lr"] == 0.5
    assert get_optimizer("SGD")([torch.zeros(1, requires_grad=True)]).defaults["lr"] == 0.01
    custom = get_optimizer(torch.optim.SGD)
    assert custom is torch.optim.SGD
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("lamb")
