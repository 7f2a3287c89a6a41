"""``Model.from_keras`` on Keras's torch backend, against the reference's
``Model.from_keras`` on the JAX backend.

Keras fixes its backend once a process, and this one runs JAX (the
reference's), so ONE child process with ``KERAS_BACKEND=torch`` builds the
reference test's ``Sequential`` (12 -> 16 ReLU -> 2) from seeded numpy
weights and runs the port: ``Model.from_keras`` outputs on seeded inputs
(eval and train mode), the weight tree bridged to the reference's layout,
and ``SingleTrainer`` and ``DOWNPOUR`` handed the Keras model itself on the
CPU. Here the same ``Sequential`` on the JAX backend goes through the
reference's ``Model.from_keras``: the outputs agree within 1e-5 absolute
(float32 products on two backends), the bridged tree has the reference's
structure and values exactly, and the trainers reach the reference test's
bars (0.85 for SingleTrainer, 0.8 for DOWNPOUR).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

keras = pytest.importorskip("keras")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _weights():
    rng = np.random.default_rng(0)
    return [rng.normal(0, 0.3, size=s).astype(np.float32) for s in ((12, 16), (16,), (16, 2), (2,))]


def _inputs():
    return np.random.default_rng(1).normal(size=(6, 12)).astype(np.float32)


CHILD = r'''
import json, os, sys
# Nothing of JAX or the reference in the port's process (keras would
# otherwise import jax, tensorflow and sklearn for optional features).
for m in ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflow", "sklearn", "distkeras_tpu"):
    sys.modules[m] = None
import numpy as np
import keras
from distkeras_tpu_torch import DOWNPOUR, Dataset, SingleTrainer
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.utils.bridge import params_to_jax

out_dir, weights_path, x_path = sys.argv[1:4]
weights = [a for _, a in sorted(np.load(weights_path).items())]
x = np.load(x_path)


def sequential():
    m = keras.Sequential([keras.layers.Input(shape=(12,)),
                          keras.layers.Dense(16, activation="relu"), keras.layers.Dense(2)])
    m.set_weights(weights)
    return m


result = {"backend": keras.backend.backend()}
m = Model.from_keras(sequential())
w = m.init(0, device="cpu")
result["names"] = sorted(w)
import torch
y, state = m.apply(w, torch.from_numpy(x), train=False)
yt, state_t = m.apply(w, torch.from_numpy(x), train=True)
np.save(os.path.join(out_dir, "eval.npy"), y.detach().numpy())
np.save(os.path.join(out_dir, "train.npy"), yt.detach().numpy())
result["state"] = [state, sorted(state_t)]
tree = params_to_jax(w, m.module)
np.savez(os.path.join(out_dir, "tree.npz"), *tree["params"]["w"])
result["tree_keys"] = sorted(tree)
result["w_len"] = len(tree["params"]["w"])
result["input_shape"] = list(m.input_shape)

rng = np.random.default_rng(0)
xs = rng.normal(size=(256, 12)).astype(np.float32)
ys = (xs[:, 0] + xs[:, 1] > 0).astype(np.float32)
trainer = SingleTrainer(sequential(), worker_optimizer="adam", learning_rate=0.01,
                        loss="categorical_crossentropy", batch_size=32, num_epoch=6,
                        device="cpu")
trained = trainer.train(Dataset.from_arrays(features=xs, label=ys))
result["single_acc"] = float(np.mean(np.argmax(trained.predict(xs), -1) == ys))
result["single_steps"] = len(trainer.get_history())

rng = np.random.default_rng(1)
xs = rng.normal(size=(256, 12)).astype(np.float32)
ys = (xs[:, 0] + xs[:, 1] > 0).astype(np.float32)
trainer = DOWNPOUR(sequential(), worker_optimizer="adam", learning_rate=0.01,
                   loss="categorical_crossentropy", num_workers=2, batch_size=16,
                   num_epoch=4, communication_window=4, device="cpu")
trained = trainer.train(Dataset.from_arrays(features=xs, label=ys))
result["downpour_commits"] = trainer.parameter_server.num_commits
result["downpour_acc"] = float(np.mean(np.argmax(trained.predict(xs), -1) == ys))
print("RESULT " + json.dumps(result))
'''


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras_torch")
    np.savez(d / "weights.npz", **{f"w{i}": a for i, a in enumerate(_weights())})
    np.save(d / "x.npy", _inputs())
    env = {**os.environ, "KERAS_BACKEND": "torch", "PYTHONPATH": REPO,
           "TF_CPP_MIN_LOG_LEVEL": "3"}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(d), str(d / "weights.npz"),
                           str(d / "x.npy")], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    return d, json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def reference():
    if keras.backend.backend() != "jax":
        pytest.skip("keras JAX backend not active")
    from distkeras_tpu.models.core import Model as RefModel

    m = keras.Sequential([keras.layers.Input(shape=(12,)),
                          keras.layers.Dense(16, activation="relu"), keras.layers.Dense(2)])
    m.set_weights(_weights())
    return m, RefModel.from_keras(m)


def test_outputs_match_the_reference(child, reference):
    d, result = child
    _, ref = reference
    assert result["backend"] == "torch"
    variables = ref.init(0)
    for mode, train in (("eval", False), ("train", True)):
        want, _ = ref.apply(variables, _inputs(), train=train)
        got = np.load(d / f"{mode}.npy")
        assert got.shape == (6, 2)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert result["state"] == [{}, []]  # eval: no state; no non-trainable variables
    assert result["input_shape"] == [12]


def test_weights_bridge_to_the_reference_layout(child, reference):
    d, result = child
    _, ref = reference
    variables = ref.init(0)
    assert result["names"] == ["w.0", "w.1", "w.2", "w.3"]
    assert result["tree_keys"] == ["params"] and result["w_len"] == 4
    with np.load(d / "tree.npz") as tree:
        got = [tree[f"arr_{i}"] for i in range(4)]
    for g, want in zip(got, variables["params"]["w"]):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(want))


def test_trainers_take_the_keras_model(child):
    _, result = child
    assert result["single_steps"] == 6 * (256 // 32)
    assert result["single_acc"] > 0.85, result
    assert result["downpour_commits"] > 0
    assert result["downpour_acc"] > 0.8, result


def test_from_keras_refuses_another_backend():
    from distkeras_tpu_torch.models.core import Model

    m = keras.Sequential([keras.layers.Input(shape=(3,)), keras.layers.Dense(2)])
    if keras.backend.backend() == "torch":
        pytest.skip("the torch backend is active")
    with pytest.raises(RuntimeError, match="KERAS_BACKEND=torch"):
        Model.from_keras(m)


def test_trainer_refuses_a_keras_model_on_another_backend():
    from distkeras_tpu_torch import SingleTrainer

    if keras.backend.backend() == "torch":
        pytest.skip("the torch backend is active")
    m = keras.Sequential([keras.layers.Input(shape=(3,)), keras.layers.Dense(2)])
    with pytest.raises(RuntimeError, match="Keras torch backend"):
        SingleTrainer(m, device="cpu")


def test_from_keras_without_keras(monkeypatch):
    from distkeras_tpu_torch.models.core import Model

    monkeypatch.setitem(sys.modules, "keras", None)
    with pytest.raises(ImportError):
        Model.from_keras(object())


def test_bridge_round_trips_the_keras_layout():
    """``params_from_jax`` of the reference's ``{"params": {"w": [...]},
    "keras_state": [...]}`` gives ``w.<i>``/``keras_state.<i>`` and
    ``params_to_jax`` gives the lists back."""
    import torch

    from distkeras_tpu_torch.models.core import _TensorList
    from distkeras_tpu_torch.utils.bridge import params_from_jax, params_to_jax

    tree = {"params": {"w": [np.ones((2, 3), np.float32), np.zeros(3, np.float32)]},
            "keras_state": [np.full(3, 2.0, np.float32)]}
    flat = params_from_jax(tree, device="cpu")
    assert sorted(flat) == ["keras_state.0", "w.0", "w.1"]

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.ParameterList([torch.nn.Parameter(flat["w.0"]),
                                             torch.nn.Parameter(flat["w.1"])])
            self.keras_state = _TensorList([flat["keras_state.0"]])

    back = params_to_jax(flat, Holder())
    assert set(back) == {"params", "keras_state"}
    assert isinstance(back["params"]["w"], list) and isinstance(back["keras_state"], list)
    for g, w in zip(back["params"]["w"] + back["keras_state"],
                    tree["params"]["w"] + tree["keras_state"]):
        np.testing.assert_array_equal(g, w)
