"""``Model.from_module`` against the reference's ``Model.from_flax``.

The same MLP (16 -> 32 -> 24 -> 5, ReLU, float32) as a flax module and as
an ``nn.Module`` with the same submodule names, the reference's weights
bridged across: the forward in eval and train mode, one training step's
loss and weights, and a BatchNorm model's returned statistics agree within
1e-6 absolute (float32 products in another order, on values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn

from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu.ops.losses import get_optimizer as ref_get_optimizer
from distkeras_tpu.training.step import TrainState as RefTrainState
from distkeras_tpu.training.step import make_train_step as ref_make_train_step
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.training.step import TrainState, make_train_step
from distkeras_tpu_torch.training.trainers import SingleTrainer
from distkeras_tpu_torch.utils.bridge import params_from_jax, params_to_jax

ATOL = 1e-6


class TorchMLP(nn.Module):
    def __init__(self, dims=(16, 32, 24, 5)):
        super().__init__()
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"Dense_{i}", nn.Linear(a, b))
        self.n = len(dims) - 1

    def forward(self, x):
        for i in range(self.n - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n - 1}")(x)


@pytest.fixture(scope="module")
def pair():
    ref = RefModel.from_flax(RefMLP(features=(32, 24), num_classes=5,
                                    compute_dtype=jnp.float32), input_shape=(16,))
    params = ref.init(0)["params"]
    port = Model.from_module(TorchMLP(), input_shape=(16,))
    weights = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return ref, params, port, weights


def test_init_is_the_modules_weights():
    module = TorchMLP()
    m = Model.from_module(module, input_shape=(16,), name="mlp", output_dim=5)
    w = m.init(0, device="cpu")
    assert w.keys() == module.state_dict().keys()
    for k, v in module.state_dict().items():
        assert torch.equal(w[k], v) and w[k] is not v
    assert m.name == "mlp" and m.input_shape == (16,) and m.output_dim == 5
    assert m.count_params() == sum(p.numel() for p in module.parameters())
    assert all(p.device.type == "meta" for p in m.module.parameters())
    # the module wrapped is not touched by the model's later use
    with torch.no_grad():
        module.Dense_0.weight.zero_()
    assert not torch.equal(m.init(1, device="cpu")["Dense_0.weight"], module.Dense_0.weight)
    assert Model.from_module(module, (16,)).name == "TorchMLP"


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_from_flax(pair, train):
    ref, params, port, weights = pair
    x = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    want, want_state = ref.apply({"params": params}, jnp.asarray(x), train=train)
    got, state = port.apply(weights, torch.from_numpy(x), train=train, rng=0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert state == {} and dict(want_state) == ({} if not train else dict(want_state))


def test_train_step_matches_from_flax(pair):
    ref, params, port, weights = pair
    rng = np.random.default_rng(2)
    batch = {"features": rng.normal(size=(8, 16)).astype(np.float32),
             "label": rng.integers(0, 5, size=8).astype(np.float32)}
    tx = ref_get_optimizer("adagrad")
    state = RefTrainState(params=params, model_state={}, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    step = ref_make_train_step(ref, tx, "categorical_crossentropy", donate=False)
    state, m = step(state, batch)
    leaves = {k: v.clone().requires_grad_() for k, v in weights.items()}
    pstate = TrainState(leaves, {}, get_optimizer("adagrad")(list(leaves.values())))
    pstate, pm = make_train_step(port, "categorical_crossentropy")(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(pm["loss"]) == pytest.approx(float(m["loss"]), abs=ATOL)
    want = params_from_jax(jax.tree.map(np.asarray, state.params), device="cpu")
    for k, v in pstate.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), atol=ATOL, rtol=0)
    back = params_to_jax({k: v.detach() for k, v in pstate.params.items()}, port.module)
    assert jax.tree.structure(back["params"]) == jax.tree.structure(
        jax.tree.map(np.asarray, state.params))


class _FlaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Dense(8, name="Dense_0")(x)
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                          name="BatchNorm_0")(x)
        return fnn.Dense(3, name="Dense_1")(fnn.relu(x))


class _TorchBN(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(6, 8)
        self.BatchNorm_0 = _BN(8)
        self.Dense_1 = nn.Linear(8, 3)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.BatchNorm_0(self.Dense_0(x))))


class _BN(nn.Module):
    """BatchNorm with flax's buffer names (``mean``, ``var``) and update
    (``momentum`` the old statistics' weight, biased batch variance)."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def forward(self, x):
        if self.training:
            mu, var = x.mean(0), x.var(0, unbiased=False)
            with torch.no_grad():
                self.mean.mul_(0.9).add_(0.1 * mu)
                self.var.mul_(0.9).add_(0.1 * var)
        else:
            mu, var = self.mean, self.var
        return (x - mu) / torch.sqrt(var + 1e-5) * self.weight + self.bias


def test_batch_stats_are_the_new_state():
    ref = RefModel.from_flax(_FlaxBN(), input_shape=(6,))
    variables = ref.init(0)
    port = Model.from_module(_TorchBN(), input_shape=(6,))
    weights = params_from_jax(jax.tree.map(np.asarray, dict(variables)), device="cpu")
    x = np.random.default_rng(3).normal(size=(10, 6)).astype(np.float32)
    want, want_state = ref.apply(variables, jnp.asarray(x), train=True)
    before = {k: v.clone() for k, v in weights.items()}
    got, state = port.apply(weights, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for name in ("mean", "var"):
        np.testing.assert_allclose(state[f"BatchNorm_0.{name}"].numpy(),
                                   np.asarray(want_state["batch_stats"]["BatchNorm_0"][name]),
                                   atol=ATOL, rtol=0)
    assert all(torch.equal(weights[k], before[k]) for k in weights)  # inputs untouched
    no_state = Model.from_module(_TorchBN(), (6,), train_mutable=False)
    assert no_state.apply(weights, torch.from_numpy(x), train=True)[1] == {}
    eval_out, eval_state = port.apply(weights, torch.from_numpy(x), train=False)
    assert eval_state == {}
    want_eval, _ = ref.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(eval_out.detach().numpy(), np.asarray(want_eval), atol=ATOL,
                               rtol=0)


def test_dropout_draws_from_the_step_seed():
    module = nn.Sequential(nn.Linear(4, 64), nn.Dropout(0.5))
    m = Model.from_module(module, (4,))
    w = m.init(0, device="cpu")
    x = torch.ones(3, 4)
    a, b, c = (m.apply(w, x, train=True, rng=r)[0] for r in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(m.apply(w, x)[0], module.eval()(x))


def test_single_trainer_takes_a_wrapped_module():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    from distkeras_tpu_torch.data import Dataset

    model = Model.from_module(TorchMLP(dims=(16, 32, 2)), input_shape=(16,))
    trainer = SingleTrainer(model, worker_optimizer="adam", learning_rate=0.01,
                            loss="categorical_crossentropy", batch_size=32, num_epoch=4,
                            device="cpu")
    trained = trainer.train(Dataset.from_arrays(features=x, label=y))
    acc = float(np.mean(np.argmax(trained.predict(x), -1) == y))
    assert acc > 0.9, acc
