"""Batch inference: counterpart of ``distkeras_tpu/inference/predictors.py``
``ModelPredictor``. The ensemble predictor and mesh sharding come with later
slices."""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.core import TrainedModel
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["Predictor", "ModelPredictor"]


class Predictor:
    """Base class."""

    def predict(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Append a ``prediction`` column with the model's (softmax-free) outputs.

    The weights move to ``device`` once (CUDA unless ``"cpu"`` is asked
    for). Every batch runs at ``batch_size`` rows: the last one is padded
    with zero rows and trimmed, as the reference pads to its compiled
    shape."""

    def __init__(
        self,
        keras_model: TrainedModel,
        features_col: str = "features",
        output_col: str = "prediction",
        batch_size: int = 1024,
        device: str | torch.device | None = None,
    ):
        if not isinstance(keras_model, TrainedModel):
            raise TypeError(
                "ModelPredictor expects a TrainedModel (as returned by "
                "Trainer.train)"
            )
        self.trained = keras_model.to(resolve_device(device))
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)

    @torch.inference_mode()
    def predict(self, dataset: Dataset) -> Dataset:
        x = np.asarray(dataset[self.features_col])
        model, variables = self.trained.model, self.trained.variables
        device = self.trained.device
        outs = []
        bs = self.batch_size
        for lo in range(0, x.shape[0], bs):
            chunk = x[lo : lo + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            out = model.apply(variables, torch.from_numpy(chunk).to(device), train=False)[0]
            out = out.cpu().numpy()
            outs.append(out[: bs - pad] if pad else out)
        preds = np.concatenate(outs) if outs else np.zeros((0,))
        return dataset.with_column(self.output_col, preds)
