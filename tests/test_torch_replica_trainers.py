"""EnsembleTrainer, AveragingTrainer and SynchronousDistributedTrainer
against the reference's.

The reference trains its replicas as one vmapped program (padded to the 8
virtual devices of the test harness and sharded over them); the port steps
one state per replica in turn. Each replica starts from the reference
replica's weights (its seed ``worker_seed(seed, i)``, bridged across) and
sees the same shuffled partition, so the per-step losses and the final
weights must agree: float32 MLP, adagrad, tolerance 1e-5 relative on each
loss and 1e-6 absolute on each weight (weights ~0.1-1; the same float32
arithmetic in another order over a few dozen steps). The averaged model is
the mean of the ensemble's models to float32 rounding (1e-7 absolute).
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
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.utils.bridge import params_from_jax
from distkeras_tpu_torch.utils.rng import worker_seed
from torch_time_limit import time_limited

D = 16
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 1e-6
KWARGS = dict(batch_size=16, num_epoch=2, seed=0)


def _toy(n=256, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(D,))
    x = rng.normal(size=(n, D)).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """The reference's MLP, and the port's, whose ``init(seed)`` returns the
    reference's weights for that seed, bridged."""
    ref_model = RefModel.from_flax(
        RefMLP(features=(32,), num_classes=2, compute_dtype=jnp.float32),
        input_shape=(D,), output_dim=2)

    def bridged(seed):
        key = jax.random.split(jax.random.PRNGKey(seed))[0]  # TrainState.create's init key
        return params_from_jax(jax.tree.map(np.asarray, ref_model.init(key)["params"]),
                               device="cpu")

    table = {worker_seed(0, i): bridged(worker_seed(0, i)) for i in range(3)}
    table[0] = bridged(0)
    port_model = Model(lambda: MLP(D, (32,), 2, compute_dtype=torch.float32), input_shape=(D,),
                       output_dim=2)
    port_model.init = lambda seed=0, device=None: {k: v.clone() for k, v in table[seed].items()}
    return ref_model, port_model


def _assert_weights(got: dict, want_params: dict, atol=WEIGHT_ATOL):
    want = params_from_jax(jax.tree.map(np.asarray, want_params), device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                   err_msg=k)


def _assert_history(got, want, replicas=None):
    assert len(got) == len(want)
    for h, w in zip(got, want):
        g, r = np.asarray(h["loss"]), np.asarray(w["loss"])
        if replicas is not None:
            assert g.shape == (replicas,) and r.shape[0] >= replicas
            r = r[:replicas]
        np.testing.assert_allclose(g, r, rtol=LOSS_RTOL)


@time_limited
def test_ensemble_matches_reference(models):
    ref_model, port_model = models
    x, y = _toy()
    want_tr = ref.EnsembleTrainer(ref_model, num_models=3, **KWARGS)
    want = want_tr.train(ref.Dataset.from_arrays(features=x, label=y), shuffle=True)
    tr = dk.EnsembleTrainer(port_model, num_models=3, device="cpu", **KWARGS)
    got = tr.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    assert len(got) == len(want) == 3
    _assert_history(tr.history, want_tr.history, replicas=3)
    for g, w in zip(got, want):
        _assert_weights(g.variables, w.variables["params"])
    assert not torch.equal(got[0].variables["Dense_0.weight"], got[1].variables["Dense_0.weight"])
    assert tr.dropped_batches == want_tr.dropped_batches == [0, 0, 0]
    np.testing.assert_allclose(tr.get_averaged_history()["loss"],
                               want_tr.get_averaged_history()["loss"], rtol=LOSS_RTOL)


@time_limited
def test_averaging_matches_reference(models):
    ref_model, port_model = models
    x, y = _toy()
    want_tr = ref.AveragingTrainer(ref_model, num_workers=2, **KWARGS)
    want = want_tr.train(ref.Dataset.from_arrays(features=x, label=y), shuffle=True)
    tr = dk.AveragingTrainer(port_model, num_workers=2, device="cpu", **KWARGS)
    got = tr.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    assert tr.num_models == tr.num_workers == 2
    _assert_history(tr.history, want_tr.history, replicas=2)
    _assert_weights(got.variables, want.variables["params"])
    # The average is the mean of the replicas an ensemble of the same seed trains.
    members = dk.EnsembleTrainer(port_model, num_models=2, device="cpu", **KWARGS).train(
        dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    for k, v in got.variables.items():
        mean = (members[0].variables[k] + members[1].variables[k]) / 2
        np.testing.assert_allclose(v.numpy(), mean.numpy(), atol=1e-7, rtol=0, err_msg=k)


@time_limited
def test_sync_trainer_matches_reference(models):
    ref_model, port_model = models
    x, y = _toy()
    want_tr = ref.SynchronousDistributedTrainer(ref_model, num_workers=1, **KWARGS)
    want = want_tr.train(ref.Dataset.from_arrays(features=x, label=y), shuffle=True)
    tr = dk.SynchronousDistributedTrainer(port_model, num_workers=1, device="cpu", **KWARGS)
    got = tr.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    assert len(tr.history) == 2 * 256 // 16
    _assert_history(tr.history, want_tr.history)
    _assert_weights(got.variables, want.variables["params"])


@time_limited
def test_sync_trainer_shard_sequence_alone_matches_reference(models):
    """shard_sequence=True on one device and an un-annotated model: the
    reference takes its data-parallel branch, which ignores it, and so does
    the port (the XLA sequence split itself runs on sp meshes in
    tests/test_torch_xla_sp.py)."""
    ref_model, port_model = models
    x, y = _toy()
    kwargs = {**KWARGS, "shard_sequence": True}
    want_tr = ref.SynchronousDistributedTrainer(ref_model, num_workers=1, **kwargs)
    want = want_tr.train(ref.Dataset.from_arrays(features=x, label=y), shuffle=True)
    tr = dk.SynchronousDistributedTrainer(port_model, num_workers=1, device="cpu", **kwargs)
    got = tr.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    assert len(tr.history) == 2 * 256 // 16
    _assert_history(tr.history, want_tr.history)
    _assert_weights(got.variables, want.variables["params"])


@time_limited
def test_ensemble_predictor_matches_reference(models):
    """The reference's test_ensemble_predictor_averages shape (3 models,
    adam, batch 16, 4 epochs; predicted in batches of 128, the last one
    padded): the reference's trained models bridged across, the averaged
    softmax of both predictors to 1e-6; and the port's own ensemble's
    average sums to 1 and classifies the toy task."""
    from distkeras_tpu.inference.predictors import EnsemblePredictor as RefEnsemblePredictor

    ref_model, port_model = models
    x, y = _toy(200)
    kwargs = dict(worker_optimizer="adam", learning_rate=0.01, num_models=3, batch_size=16,
                  num_epoch=4)
    trained = ref.EnsembleTrainer(ref_model, **kwargs).train(
        ref.Dataset.from_arrays(features=x, label=y))
    want = RefEnsemblePredictor(trained, batch_size=128).predict(
        ref.Dataset.from_arrays(features=x))["prediction"]
    bridged = [dk.TrainedModel(port_model, params_from_jax(
        jax.tree.map(np.asarray, m.variables["params"]), device="cpu")) for m in trained]
    got = dk.EnsemblePredictor(bridged, batch_size=128, device="cpu").predict(
        dk.Dataset.from_arrays(features=x))["prediction"]
    assert np.asarray(got).shape == np.asarray(want).shape == (200, 2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6, rtol=0)
    own = dk.EnsembleTrainer(port_model, device="cpu", **kwargs).train(
        dk.Dataset.from_arrays(features=x, label=y))
    probs = np.asarray(dk.EnsemblePredictor(own, batch_size=128, device="cpu").predict(
        dk.Dataset.from_arrays(features=x))["prediction"])
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert float(np.mean(np.argmax(probs, -1) == y)) > 0.85


@time_limited
def test_uneven_partitions_report_the_reference_drop_count(models):
    """70 rows in 3 partitions of 23/23/24, batch 8: 2/2/3 batches, so the
    lock-step stops after 2 and replica 2 drops 1, as in the reference."""
    ref_model, port_model = models
    x, y = _toy(70)
    want = ref.EnsembleTrainer(ref_model, num_models=3, batch_size=8, num_epoch=1)
    want.train(ref.Dataset.from_arrays(features=x, label=y))
    tr = dk.EnsembleTrainer(port_model, num_models=3, batch_size=8, num_epoch=1, device="cpu")
    assert len(tr.train(dk.Dataset.from_arrays(features=x, label=y))) == 3
    assert len(tr.history) == len(want.history) == 2
    assert tr.dropped_batches == want.dropped_batches == [0, 0, 1]


@pytest.mark.parametrize("kwargs, match", [
    # tp, fsdp and sp are ported: on one rank their two-rank meshes are too big
    pytest.param({"mesh": {"dp": 1, "tp": 2}}, "needs 2 ranks", id="kwargs0-A10"),
    pytest.param({"mesh": {"dp": 1, "fsdp": 2}}, "needs 2 ranks", id="kwargs1-A10"),
    pytest.param({"mesh": {"dp": 1, "sp": 2}}, "needs 2 ranks", id="kwargs2-A10"),
    ({"num_workers": 2}, "requested 2 devices but only 1"),
    ({"mesh": {"dp": 2}}, "dp=2"),
])
def test_sync_trainer_refuses_multi_device(models, kwargs, match):
    _, port_model = models
    x, y = _toy(32)
    tr = dk.SynchronousDistributedTrainer(port_model, device="cpu", **kwargs)
    with pytest.raises(ValueError, match=match):
        tr.train(dk.Dataset.from_arrays(features=x, label=y))


def test_sync_trainer_refuses_a_multi_rank_process_group(models, monkeypatch):
    """Every rank of the process group trains: a mesh over fewer of its
    ranks (num_workers below the group's size) is refused. Multi-rank
    training itself runs in tests/test_torch_data_parallel.py."""
    _, port_model = models
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 2)
    x, y = _toy(32)
    with pytest.raises(ValueError, match="1 of the process group's 2 ranks"):
        dk.SynchronousDistributedTrainer(port_model, num_workers=1, device="cpu").train(
            dk.Dataset.from_arrays(features=x, label=y))


def test_sync_trainer_accepts_a_data_parallel_mesh_of_one(models):
    _, port_model = models
    x, y = _toy(32)
    tr = dk.SynchronousDistributedTrainer(port_model, mesh={"dp": 1, "tp": 1}, num_workers=1,
                                          batch_size=8, device="cpu")
    tr.train(dk.Dataset.from_arrays(features=x, label=y))
    assert len(tr.history) == 4


def test_constructor_defaults_match_reference(models):
    ref_model, port_model = models
    for name in ("EnsembleTrainer", "AveragingTrainer", "SynchronousDistributedTrainer"):
        got, want = getattr(dk, name)(port_model, device="cpu"), getattr(ref, name)(ref_model)
        for attr in ("batch_size", "num_epoch", "num_workers", "num_models", "features_col",
                     "label_col", "worker_optimizer", "checkpoint_interval_s", "zero1"):
            assert getattr(got, attr, None) == getattr(want, attr, None), (name, attr)
