"""Trainers: counterpart of ``distkeras_tpu/training/trainers.py``.

Ported so far: the :class:`Trainer` base (constructor surface, wall-clock
bookkeeping, step history, :meth:`Trainer.evaluate`) and
:class:`SingleTrainer`, one step loop on one device. The replica trainers
(ensemble, averaging, synchronous), the asynchronous parameter-server family
and the telemetry hooks (metric stream, registry, recompile auditor, weight
publisher) come with later slices.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.feed import DeviceFeed, minibatches
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.ops.losses import get_loss, get_optimizer
from distkeras_tpu_torch.training.step import TrainState, make_eval_step, make_train_step
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["Trainer", "SingleTrainer"]


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
        self.history: list[dict] = []
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

    def get_history(self) -> list[dict]:
        return self.history

    def get_averaged_history(self) -> dict:
        """Mean of each metric over the recorded steps."""
        if not self.history:
            return {}
        return {k: float(np.mean([h[k] for h in self.history if k in h]))
                for k in self.history[0]}

    def _optimizer(self):
        return get_optimizer(self.worker_optimizer, self.learning_rate)

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


class SingleTrainer(Trainer):
    """Single-device trainer (reference ``SingleTrainer``): one step loop on
    the trainer's device, CUDA unless ``device="cpu"``."""

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss="categorical_crossentropy",
        metrics=("accuracy",),
        features_col: str = "features",
        label_col: str = "label",
        batch_size: int = 32,
        num_epoch: int = 1,
        learning_rate: float | None = None,
        seed: int = 0,
        grad_accum_steps: int = 1,
        remat: bool = False,
        aux_loss_weight: float = 0.01,
        validation_data: Dataset | None = None,
        loss_weights=None,
        device: str | torch.device | None = None,
    ):
        super().__init__(keras_model, worker_optimizer, loss, metrics,
                         learning_rate=learning_rate, seed=seed,
                         loss_weights=loss_weights, device=device)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.grad_accum_steps = int(grad_accum_steps)
        self.remat = bool(remat)
        self.aux_loss_weight = float(aux_loss_weight)
        # Optional held-out set: evaluated after every epoch into
        # validation_history (val_loss/val_accuracy).
        self.validation_data = validation_data
        self.validation_history: list[dict] = []

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        """Train for ``num_epoch`` epochs (rows reshuffled each epoch with
        ``seed + epoch`` when ``shuffle``) and return the trained model, its
        weights on the trainer's device. ``history`` holds each step's
        metrics as floats, read from the device once, after the last step."""
        self.record_training_start()
        step_fn = make_train_step(
            self.model, self.loss, self.metrics, remat=self.remat,
            aux_loss_weight=self.aux_loss_weight, grad_accum_steps=self.grad_accum_steps,
        )
        state = TrainState.create(self.model, self._optimizer(), self.seed, self.device)
        history: list[dict] = []
        self.validation_history = []
        for epoch in range(self.num_epoch):
            batches = minibatches(
                dataset, self.batch_size, self.features_col, self.label_col,
                num_epoch=1, seed=(self.seed + epoch) if shuffle else None,
            )
            for batch in DeviceFeed(batches, self.device, buffer_size=2):
                state, m = step_fn(state, batch)
                history.append(m)
            if self.validation_data is not None:
                val = self.evaluate(
                    TrainedModel(self.model, state.variables), self.validation_data,
                    features_col=self.features_col, label_col=self.label_col,
                )
                self.validation_history.append(
                    {"epoch": epoch, **{f"val_{k}": v for k, v in val.items()}})
        # One read from the device for all the steps' metrics.
        self.history = []
        if history:
            keys = list(history[0])
            rows = torch.stack([torch.stack([h[k] for k in keys]) for h in history]).tolist()
            self.history = [dict(zip(keys, row)) for row in rows]
        self.record_training_stop()
        return TrainedModel(self.model, {k: v.detach() for k, v in state.variables.items()})
