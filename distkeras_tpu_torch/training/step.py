"""Step functions: counterpart of ``distkeras_tpu/training/step.py``.

This slice ports the evaluation step. The train steps
(``make_train_step`` and the window variants) come with the training slice.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import accuracy as accuracy_metric

__all__ = ["make_eval_step"]


def make_eval_step(model: Model, loss: str | Callable | None = None):
    """Build ``eval_step(variables, batch) -> metrics_dict`` (no grad).

    ``batch`` holds ``features`` and ``label`` tensors on the weights'
    device; the metrics are 0-dim tensors on that device."""
    loss_fn = get_loss(loss) if loss is not None else None

    @torch.inference_mode()
    def eval_step(variables: dict, batch: dict) -> dict:
        outputs, _ = model.apply(variables, batch["features"], train=False)
        out = {"accuracy": accuracy_metric(outputs, batch["label"])}
        if loss_fn is not None:
            out["loss"] = loss_fn(outputs, batch["label"])
        return out

    return eval_step
