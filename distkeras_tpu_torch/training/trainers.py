"""Trainers: counterpart of ``distkeras_tpu/training/trainers.py``.

This slice ports the :class:`Trainer` base: its constructor surface, the
wall-clock bookkeeping and :meth:`Trainer.evaluate`. The step history,
``SingleTrainer``, the replica trainers and the asynchronous
parameter-server family come with later slices, as do the telemetry hooks
(metric stream, registry, recompile auditor, weight publisher).
"""

from __future__ import annotations

import time

import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.feed import minibatches
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.training.step import make_eval_step
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["Trainer"]


class Trainer:
    """Base trainer: holds the model spec, loss, worker optimizer name,
    the device and wall-clock bookkeeping. ``device`` defaults to CUDA and
    raises without one; pass ``"cpu"`` to run on the host."""

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss: str = "categorical_crossentropy",
        metrics: tuple[str, ...] = ("accuracy",),
        learning_rate: float | None = None,
        seed: int = 0,
        loss_weights=None,
        device: str | torch.device | None = None,
    ):
        if not isinstance(keras_model, Model):
            raise TypeError("Trainer expects a distkeras_tpu_torch Model")
        self.model = keras_model
        self.device = resolve_device(device)
        self.loss_weights = loss_weights
        if loss_weights is not None:
            base, w = get_loss(loss), float(loss_weights)

            def _weighted(preds, targets):
                return base(preds, targets) * w

            loss = _weighted
        self.loss = loss
        self.worker_optimizer = worker_optimizer
        self.metrics = tuple(metrics)
        self.learning_rate = learning_rate
        self.seed = seed
        self._training_start: float | None = None
        self._training_stop: float | None = None

    # -- timing ---------------------------------------------------------------

    def record_training_start(self) -> None:
        self._training_start = time.time()
        self._training_stop = None

    def record_training_stop(self) -> None:
        self._training_stop = time.time()

    def get_training_time(self) -> float:
        if self._training_start is None:
            return 0.0
        stop = self._training_stop if self._training_stop is not None else time.time()
        return stop - self._training_start

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        raise NotImplementedError

    def evaluate(
        self,
        trained: TrainedModel,
        dataset: Dataset,
        batch_size: int = 1024,
        features_col: str | None = None,
        label_col: str | None = None,
    ) -> dict:
        """Mean eval metrics (loss + accuracy) over a dataset, batch by batch
        on the trainer's device."""
        eval_step = make_eval_step(self.model, self.loss)
        variables = {k: v.to(self.device) for k, v in trained.variables.items()}
        fcol = features_col or getattr(self, "features_col", "features")
        lcol = label_col or getattr(self, "label_col", "label")
        totals: dict[str, float] = {}
        count = 0
        for batch in minibatches(
            dataset, min(batch_size, dataset.num_rows), fcol, lcol,
            drop_remainder=False,
        ):
            dev_batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            m = eval_step(variables, dev_batch)
            n = batch["features"].shape[0]
            for k2, v2 in m.items():
                totals[k2] = totals.get(k2, 0.0) + float(v2) * n
            count += n
        return {k2: v2 / max(1, count) for k2, v2 in totals.items()}
