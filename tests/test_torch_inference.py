"""Batch inference and evaluation, the slice as a whole, against the reference.

``bert_tiny_mlm`` with flash attention on, weights bridged from the
reference; the same seeded token ids and labels go through the reference's
``ModelPredictor`` / ``Trainer.evaluate`` and the port's. The reference runs
its Pallas kernels in interpret mode on the CPU, the port its plain versions.
Tolerances: float32 model, so logits to 2e-5 absolute and the mean loss to
1e-5 relative (the same arithmetic in another order); accuracy exactly
(argmax over logits that agree to 2e-5, with no near ties at this seed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.data.dataset import Dataset as RefDataset
from distkeras_tpu.data.feed import minibatches as ref_minibatches
from distkeras_tpu.inference.evaluators import AccuracyEvaluator as RefAccuracyEvaluator
from distkeras_tpu.inference.predictors import ModelPredictor as RefModelPredictor
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.models.core import TrainedModel as RefTrainedModel
from distkeras_tpu.training.trainers import Trainer as RefTrainer
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.feed import minibatches
from distkeras_tpu_torch.inference.evaluators import (
    AccuracyEvaluator,
    ConfusionMatrixEvaluator,
    PrecisionRecallEvaluator,
)
from distkeras_tpu_torch.inference.predictors import ModelPredictor
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.core import TrainedModel
from distkeras_tpu_torch.training.trainers import Trainer
from distkeras_tpu_torch.utils.bridge import params_from_jax

SEQ, VOCAB, ROWS = 32, 256, 10
ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def slice_pair():
    """(reference TrainedModel, port TrainedModel, token data) — one init."""
    ref_m = ref_bert.bert_tiny_mlm(seq_len=SEQ, vocab_size=VOCAB)
    ref_m = ref_bert._make(dataclasses.replace(
        ref_m.config, use_flash_attention=True, dtype=jnp.float32,
        dropout_rate=0.0), SEQ, ref_m.name)
    port_m = port_bert.bert_tiny_mlm(seq_len=SEQ, vocab_size=VOCAB)
    port_m = port_bert._make(dataclasses.replace(
        port_m.config, use_flash_attention=True, dtype=torch.float32,
        dropout_rate=0.0), SEQ, port_m.name)
    variables = ref_m.init(0)
    state = params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    rng = np.random.default_rng(5)
    cols = {
        "features": rng.integers(0, VOCAB, size=(ROWS, SEQ)).astype(np.int32),
        "label": rng.integers(0, VOCAB, size=(ROWS, SEQ)).astype(np.int32),
    }
    return RefTrainedModel(ref_m, variables), TrainedModel(port_m, state), cols


def test_model_predictor_matches_reference(slice_pair):
    ref_tm, port_tm, cols = slice_pair
    # batch 4 over 10 rows: the last batch is padded to 4 and trimmed.
    want = RefModelPredictor(ref_tm, batch_size=4).predict(RefDataset(cols))
    got = ModelPredictor(port_tm, batch_size=4, device="cpu").predict(Dataset(cols))
    assert got.columns == want.columns
    assert got["prediction"].shape == (ROWS, SEQ, VOCAB)
    np.testing.assert_allclose(got["prediction"], np.asarray(want["prediction"]),
                               atol=ATOL, rtol=0)
    # The evaluators score one class per row: one row per token position.
    def per_token(ds):
        return {"prediction_index": np.argmax(np.asarray(ds["prediction"]), -1).reshape(-1),
                "label": np.asarray(ds["label"]).reshape(-1)}

    acc = AccuracyEvaluator().evaluate(Dataset(per_token(got)))
    assert acc == RefAccuracyEvaluator().evaluate(RefDataset(per_token(want)))


@pytest.mark.parametrize("loss", ["fused_categorical_crossentropy",
                                  "sparse_categorical_crossentropy"])
def test_trainer_evaluate_matches_reference(slice_pair, loss):
    ref_tm, port_tm, cols = slice_pair
    want = RefTrainer(ref_tm.model, loss=loss).evaluate(ref_tm, RefDataset(cols), batch_size=4)
    got = Trainer(port_tm.model, loss=loss, device="cpu").evaluate(
        port_tm, Dataset(cols), batch_size=4)
    assert got.keys() == want.keys() == {"loss", "accuracy"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-7)
    # Random weights: the loss sits near ln(V).
    assert abs(got["loss"] - np.log(VOCAB)) < 1.0


def test_evaluators_match_reference():
    rng = np.random.default_rng(6)
    cols = {"prediction": rng.normal(size=(50, 3)).astype(np.float32),
            "label": rng.integers(0, 3, size=50)}
    ev = dict(prediction_col="prediction", label_col="label")
    from distkeras_tpu.inference import evaluators as ref_ev

    assert (AccuracyEvaluator(**ev).evaluate(Dataset(cols))
            == ref_ev.AccuracyEvaluator(**ev).evaluate(RefDataset(cols)))
    assert (PrecisionRecallEvaluator(**ev).evaluate(Dataset(cols))
            == ref_ev.PrecisionRecallEvaluator(**ev).evaluate(RefDataset(cols)))
    np.testing.assert_array_equal(
        ConfusionMatrixEvaluator(3, **ev).evaluate(Dataset(cols)),
        ref_ev.ConfusionMatrixEvaluator(3, **ev).evaluate(RefDataset(cols)))


@pytest.mark.parametrize("seed,drop,start", [(None, True, 0), (7, False, 0), (7, True, 5)])
def test_minibatches_match_reference(seed, drop, start):
    rng = np.random.default_rng(8)
    cols = {"features": rng.normal(size=(23, 3)).astype(np.float32),
            "label": np.arange(23)}
    want = list(ref_minibatches(RefDataset(cols), 5, num_epoch=2, seed=seed,
                                drop_remainder=drop, start_batch=start))
    got = list(minibatches(Dataset(cols), 5, num_epoch=2, seed=seed,
                           drop_remainder=drop, start_batch=start))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["features"], w["features"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_dataset_ops_match_reference(tmp_path):
    rng = np.random.default_rng(9)
    cols = {"features": rng.normal(size=(12, 2)).astype(np.float32),
            "label": rng.integers(0, 2, size=12)}
    port, ref = Dataset(cols), RefDataset(cols)
    for op in (lambda d: d.shuffle(3), lambda d: d.split(0.5, seed=1)[1],
               lambda d: d.partitions(3)[2], lambda d: d.repeat(2).take(15)):
        for name in cols:
            np.testing.assert_array_equal(op(port)[name], op(ref)[name])
    path = str(tmp_path / "d.npz")
    port.to_npz(path)
    np.testing.assert_array_equal(RefDataset.from_npz(path)["label"], cols["label"])
    assert port.describe() == ref.describe()
