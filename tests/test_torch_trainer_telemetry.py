"""The trainers' telemetry surface against the reference.

Every trainer takes the reference's ``metric_stream``, ``registry`` and
``auditor`` arguments and has a ``publisher`` attribute. After ``train()``
the history goes to the metric stream, one ``emit`` per row, and the
registry gets ``train_steps_total``, ``train_time_seconds`` and a
``train_last_<key>`` gauge per numeric metric of the last row, as the
reference's ``_emit_history`` publishes them; the replica trainers, as the
reference's, emit nothing. On the same float32 MLP
weights and data as the reference, the step counts are equal and the last
loss and accuracy agree to 1e-5 relative (the same float32 arithmetic in
another order over a few adagrad steps); the wall clock is each run's own.
Under ``auditor=`` each trainer's step has as many abstract signatures as
the reference's jitted step compiles executables over one ``train()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
import distkeras_tpu_torch as dk
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu.telemetry import MetricsRegistry as RefRegistry
from distkeras_tpu.telemetry import sanitize_metric_name as ref_sanitize
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.telemetry.registry import MetricsRegistry, sanitize_metric_name
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_time_limit import time_limited

D = 16
RTOL = 1e-5
TRAINERS = ["SingleTrainer", "EnsembleTrainer", "AveragingTrainer",
            "SynchronousDistributedTrainer", "DOWNPOUR", "ADAG", "AEASGD", "EAMSGD", "DynSGD"]


class Stream:
    """A metric stream: records every ``emit``."""

    def __init__(self):
        self.records = []

    def emit(self, i, record):
        self.records.append((i, dict(record)))


def _toy(n=128):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(D,))
    x = rng.normal(size=(n, D)).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


@pytest.fixture(scope="module")
def mlp_pair():
    ref_model = RefModel.from_flax(
        RefMLP(features=(32,), num_classes=2, compute_dtype=jnp.float32),
        input_shape=(D,), output_dim=2)
    params = ref_model.init(jax.random.split(jax.random.PRNGKey(0))[0])["params"]
    weights = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return ref_model, weights


def _port_mlp(weights=None):
    model = Model(lambda: MLP(D, (32,), 2, compute_dtype=torch.float32), input_shape=(D,),
                  output_dim=2)
    if weights is not None:
        model.init = lambda seed=0, device=None: {k: v.clone() for k, v in weights.items()}
    return model


def _gauge(registry, name):
    return registry.gauge(name).value


@time_limited
def test_single_trainer_publishes_the_reference_series(mlp_pair):
    ref_model, weights = mlp_pair
    x, y = _toy()
    kwargs = dict(batch_size=16, num_epoch=2)
    want_reg, want_stream = RefRegistry(), Stream()
    want = ref.SingleTrainer(ref_model, registry=want_reg, metric_stream=want_stream, **kwargs)
    want.train(ref.Dataset.from_arrays(features=x, label=y), shuffle=True)
    reg, stream = MetricsRegistry(), Stream()
    tr = dk.SingleTrainer(_port_mlp(weights), registry=reg, metric_stream=stream, device="cpu",
                          **kwargs)
    tr.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)

    assert reg.counter("train_steps_total").value == want_reg.counter(
        "train_steps_total").value == len(tr.history) == 16
    assert _gauge(reg, "train_time_seconds") == pytest.approx(tr.get_training_time(), abs=0.05)
    assert _gauge(reg, "train_time_seconds") > 0 and _gauge(want_reg, "train_time_seconds") > 0
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(_gauge(reg, f"train_last_{key}"),
                                   _gauge(want_reg, f"train_last_{key}"), rtol=RTOL)
    assert [i for i, _ in stream.records] == list(range(len(tr.history)))
    assert [r for _, r in stream.records] == tr.history
    assert len(want_stream.records) == len(stream.records)
    for (_, got), (_, w) in zip(stream.records, want_stream.records):
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=RTOL)


@time_limited
def test_async_trainer_publishes_the_train_series(mlp_pair):
    _, weights = mlp_pair
    x, y = _toy()
    reg, stream = MetricsRegistry(), Stream()
    tr = dk.DOWNPOUR(_port_mlp(weights), num_workers=1, batch_size=16, communication_window=4,
                     registry=reg, metric_stream=stream, device="cpu")
    tr.train(dk.Dataset.from_arrays(features=x, label=y))
    assert reg.counter("train_steps_total").value == len(tr.history) == 8
    assert _gauge(reg, "train_last_loss") == tr.history[-1]["loss"]
    assert _gauge(reg, "train_last_worker") == 0
    assert reg.counter("ps_commits_total").value == 2  # the PS series, as before
    assert [r for _, r in stream.records] == tr.history


@pytest.mark.parametrize("name", ["EnsembleTrainer", "AveragingTrainer"])
@time_limited
def test_replica_trainers_emit_nothing_as_the_reference(mlp_pair, name):
    ref_model, weights = mlp_pair
    x, y = _toy(64)
    want_reg, want_stream = RefRegistry(), Stream()
    getattr(ref, name)(ref_model, registry=want_reg, metric_stream=want_stream,
                       batch_size=16).train(ref.Dataset.from_arrays(features=x, label=y))
    reg, stream = MetricsRegistry(), Stream()
    tr = getattr(dk, name)(_port_mlp(weights), registry=reg, metric_stream=stream, batch_size=16,
                           device="cpu")
    tr.train(dk.Dataset.from_arrays(features=x, label=y))
    assert len(tr.history) == 2
    assert stream.records == want_stream.records == []
    assert reg.snapshot() == want_reg.snapshot()


@pytest.mark.parametrize("name", TRAINERS)
@time_limited
def test_auditor_counts_match_reference(mlp_pair, name):
    """One ``train()`` under an auditor: the same audited steps, each with
    as many signatures as the reference's jit compiled executables."""
    from distkeras_tpu.telemetry import RecompileAuditor as RefAuditor

    from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor

    ref_model, weights = mlp_pair
    x, y = _toy(72)  # 72 rows: a ragged last window for the async trainers
    kwargs = dict(batch_size=8, num_epoch=2)
    if name in ("DOWNPOUR", "ADAG", "AEASGD", "EAMSGD", "DynSGD"):
        # One worker: the reference places each worker on a device of its own,
        # and a second device compiles the same program again.
        kwargs.update(num_workers=1, communication_window=4)
    want = RefAuditor()
    getattr(ref, name)(ref_model, auditor=want, **kwargs).train(
        ref.Dataset.from_arrays(features=x, label=y))
    got = RecompileAuditor()
    tr = getattr(dk, name)(_port_mlp(weights), auditor=got, device="cpu", **kwargs)
    assert tr.auditor is got
    tr.train(dk.Dataset.from_arrays(features=x, label=y))
    counts = {k: v["compiles"] for k, v in got.report().items()}
    assert counts == {k: v["compiles"] for k, v in want.report().items()}
    assert sum(v["calls"] for v in got.report().values()) > 0


@pytest.mark.parametrize("name", TRAINERS)
def test_every_trainer_has_the_telemetry_surface(name):
    reg, stream = MetricsRegistry(), Stream()
    tr = getattr(dk, name)(_port_mlp(), device="cpu", registry=reg, metric_stream=stream)
    assert tr.publisher is None and tr.registry is reg and tr.metric_stream is stream
    want = getattr(ref, name)(RefModel.from_flax(RefMLP(features=(4,), num_classes=2),
                                                 input_shape=(D,)))
    assert want.publisher is None


def test_averaged_history_skips_non_numeric_keys():
    tr = dk.SingleTrainer(_port_mlp(), device="cpu")
    tr.history = [{"loss": np.array([1.0, 3.0]), "tag": "a", "worker": 0},
                  {"loss": np.array([2.0, 2.0]), "tag": "b", "worker": 1}]
    assert tr.get_averaged_history() == {"loss": 2.0, "worker": 0.5}
    want = ref.SingleTrainer(RefModel.from_flax(RefMLP(features=(4,), num_classes=2),
                                                input_shape=(D,)))
    want.history = tr.history
    assert want.get_averaged_history() == tr.get_averaged_history()


@pytest.mark.parametrize("key", ["loss", "val/acc", "3x", "a-b c", ""])
def test_sanitize_metric_name_matches_reference(key):
    assert sanitize_metric_name(key) == ref_sanitize(key)
