"""The port's fused softmax cross-entropy forward and loss registry against
the reference's (Pallas kernel in interpret mode on the CPU).

Ragged shapes (T = 37 rows, V = 1000 columns) exercise the reference's
padding of T with dummy rows and V with -1e30 columns, which the port
replaces with masks. Tolerances: rtol 1e-5 on the float32 mean loss (the
same float32 logsumexp summed in another order); 1e-5 too for bfloat16
logits, since both sides widen them to float32 before any arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.losses import LOSSES as REF_LOSSES
from distkeras_tpu.ops.pallas.fused_xent import fused_softmax_xent as ref_xent
from distkeras_tpu_torch.ops.fused_xent import (
    fused_softmax_xent,
    xent_forward,
    xent_forward_reference,
)
from distkeras_tpu_torch.ops.losses import LOSSES, get_loss

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


def test_xent_backward_is_not_ported():
    logits, labels = _data(5, 4, 16)
    x = torch.from_numpy(logits).requires_grad_()
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_softmax_xent(x, torch.from_numpy(labels)).backward()



def test_cpu_tensors_take_the_plain_version():
    logits, labels = (torch.from_numpy(a) for a in _data(6, 9, 33))
    before = xent_forward.launches
    assert torch.equal(xent_forward(logits, labels), xent_forward_reference(logits, labels))
    assert xent_forward.launches == before
