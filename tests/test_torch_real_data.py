"""Real-data acceptance on the port: the reference's only correctness
criterion, "distributed accuracy ≈ the single-node run on real data"
(``tests/test_real_data.py``, ``BASELINE.md`` "Real-data acceptance").

The data is the UCI digits set (1797 8x8 handwritten-digit images, pixel
values 0-16, and a label), copied from scikit-learn's bundled
``sklearn/datasets/data/digits.csv.gz`` into ``tests/data/`` and read here
with numpy, so neither the tests nor the card need scikit-learn. The split,
model and settings are the reference test's: ``MinMaxTransformer(min=0,
max=16)``, ``shuffle(seed=0)``, rows 0-1500 to train and the other 297 to
test; ``MLP(features=(64, 64), num_classes=10)``; adam 1e-3, batch 32, 20
epochs, seed 0; the async trainers with 4 workers, AEASGD and EAMSGD at
``rho=50``, ``communication_window=8``. The reference measured 0.9933 for
single and 0.946-0.970 for the async trainers. Bars: single above 0.93, each
async trainer within 0.08 of single.

``SingleTrainer`` and ADAG run in the default lane; the other async
trainers are marked ``slow``, as the reference's whole file is.

With 4 workers an async run's result depends on the order in which the
threads' commits reach the PS. So the last test forces one order, round
robin, in both packages and holds the port's DOWNPOUR center (4 workers,
overlapped exchange) to the reference's on the digits data: the same
float32 arithmetic in another order, 1e-5 absolute on weights moved by
~0.06 (observed 6e-7).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
import distkeras_tpu_torch as dk
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu.parallel import protocols as ref_protocols
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.parallel import protocols as port_protocols
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_time_limit import time_limited

DIGITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "digits.csv.gz")
_KWARGS = dict(worker_optimizer="adam", learning_rate=1e-3, batch_size=32, num_epoch=20,
               seed=0, device="cpu")
SINGLE_MIN, ASYNC_GAP = 0.93, 0.08


def load_digits_csv(path=DIGITS):
    """(features float32 [1797, 64], labels int [1797]) from the csv."""
    table = np.loadtxt(path, delimiter=",", dtype=np.float64)
    return table[:, :-1].astype(np.float32), table[:, -1].astype(int)


def test_digits_file_equals_sklearn():
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    x, y = load_digits_csv()
    want = sklearn_datasets.load_digits()
    assert x.shape == (1797, 64) and y.shape == (1797,)
    np.testing.assert_array_equal(x, want.data.astype(np.float32))
    np.testing.assert_array_equal(y, want.target)


@pytest.fixture(scope="module")
def digits():
    x, y = load_digits_csv()
    ds = dk.Dataset.from_arrays(features=x, label=y.astype(np.float32))
    ds = dk.MinMaxTransformer(min=0, max=16, output_col="features").transform(ds)
    ds = ds.shuffle(seed=0)
    return ds.slice(0, 1500), ds.slice(1500, len(ds))


def _model():
    return Model(lambda: MLP(64, (64, 64), 10), name="digits_mlp", input_shape=(64,),
                 output_dim=10)


def _accuracy(trained, test):
    pred = dk.ModelPredictor(trained, device="cpu").predict(test)
    return dk.AccuracyEvaluator(prediction_col="prediction", label_col="label").evaluate(pred)


@pytest.fixture(scope="module")
def single_acc(digits):
    """The single-node baseline, trained once for the module."""
    train, test = digits
    trainer = dk.SingleTrainer(_model(), **_KWARGS)
    return _accuracy(trainer.train(train, shuffle=True), test)


@time_limited(timeout=120)
def test_real_digits_single_node_learns(single_acc):
    assert single_acc > SINGLE_MIN, single_acc


def _async_acc(digits, name):
    train, test = digits
    extra = dict(rho=50.0, communication_window=8) if name in ("AEASGD", "EAMSGD") else {}
    trainer = getattr(dk, name)(_model(), num_workers=4, **extra, **_KWARGS)
    return _accuracy(trainer.train(train, shuffle=True), test)


@pytest.mark.parametrize("name", [
    "ADAG",
    pytest.param("DOWNPOUR", marks=pytest.mark.slow),
    pytest.param("DynSGD", marks=pytest.mark.slow),
    pytest.param("AEASGD", marks=pytest.mark.slow),
    pytest.param("EAMSGD", marks=pytest.mark.slow),
])
@time_limited(timeout=240)
def test_real_digits_async_parity_with_single(digits, single_acc, name):
    acc = _async_acc(digits, name)
    assert abs(acc - single_acc) < ASYNC_GAP, (name, acc, single_acc)


def _round_robin(monkeypatch, module, num_workers: int) -> None:
    """Let the workers' fused exchanges reach the PS in the order 0, 1, ...,
    N-1, 0, ... (each worker runs the same number of windows)."""
    cond, turn = threading.Condition(), [0]
    window = module._DeltaWindowMixin.worker_window

    def ordered(self, params, carry, client):
        wid = client._worker_id
        with cond:
            assert cond.wait_for(lambda: turn[0] == wid, timeout=60), "round robin stalled"
        try:
            return window(self, params, carry, client)
        finally:
            with cond:
                turn[0] = (turn[0] + 1) % num_workers
                cond.notify_all()

    monkeypatch.setattr(module._DeltaWindowMixin, "worker_window", ordered)


CENTER_ATOL = 1e-5


@time_limited(timeout=180)
def test_downpour_four_workers_match_reference_in_one_commit_order(monkeypatch):
    nw = 4
    for module in (ref_protocols, port_protocols):
        _round_robin(monkeypatch, module, nw)
    x, y = load_digits_csv()
    n = 32 * 8 * nw  # 8 batches, two windows of 4, per worker and epoch
    x, y = x[:n] / 16.0, y[:n].astype(np.float32)
    ref_model = RefModel.from_flax(
        RefMLP(features=(64, 64), num_classes=10, compute_dtype=jnp.float32),
        input_shape=(64,), output_dim=10)
    params = ref_model.init(jax.random.split(jax.random.PRNGKey(0))[0])["params"]
    start = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    port_model = Model(lambda: MLP(64, (64, 64), 10, compute_dtype=torch.float32),
                       input_shape=(64,), output_dim=10)
    port_model.init = lambda seed=0, device=None: {k: v.clone() for k, v in start.items()}
    kwargs = dict(worker_optimizer="adam", learning_rate=1e-3, batch_size=32, num_epoch=2,
                  seed=0, communication_window=4, overlap_window=True, num_workers=nw)
    want_tr = ref.DOWNPOUR(ref_model, **kwargs)
    want = want_tr.train(ref.Dataset.from_arrays(features=x, label=y), shuffle=True)
    got_tr = dk.DOWNPOUR(port_model, device="cpu", **kwargs)
    got = got_tr.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    assert got_tr.parameter_server.num_commits == want_tr.parameter_server.num_commits == 16
    want = params_from_jax(jax.tree.map(np.asarray, want.params), device="cpu")
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 1e-2  # the center trained
    for k in want:
        torch.testing.assert_close(got.variables[k], want[k], atol=CENTER_ATOL, rtol=0)
