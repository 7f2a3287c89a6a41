"""Loss registry keyed by the Keras-style names the trainers accept.

Counterpart of ``distkeras_tpu/ops/losses.py``: the same names, each a
``(logits/preds, targets) -> scalar`` function over a whole batch. The
optimizer registry (``get_optimizer``) comes with the training slice.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.ops.fused_xent import fused_softmax_xent

__all__ = ["get_loss", "LOSSES"]

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def categorical_crossentropy(logits, targets):
    """Softmax CE against one-hot (or soft) targets. Targets with integer
    dtype, or one rank below the logits, are class indices. Computed in
    float32."""
    logits = logits.float()
    if targets.ndim == logits.ndim - 1 or not targets.is_floating_point():
        labels = targets.long().reshape(targets.shape[: logits.ndim - 1])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return -(targets.float() * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def binary_crossentropy(logits, targets):
    targets = targets.reshape(logits.shape).to(logits.dtype)
    return F.binary_cross_entropy_with_logits(logits, targets)


def mean_squared_error(preds, targets):
    return torch.mean((preds - targets.reshape(preds.shape)) ** 2)


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds - targets.reshape(preds.shape)))


def fused_categorical_crossentropy(logits, targets):
    """Fused softmax-CE (integer labels; large-vocab heads). One-hot targets
    fall back to :func:`categorical_crossentropy`, as in the reference."""
    if targets.ndim == logits.ndim:
        return categorical_crossentropy(logits, targets)
    return fused_softmax_xent(logits, targets)


LOSSES: dict[str, LossFn] = {
    "categorical_crossentropy": categorical_crossentropy,
    "fused_categorical_crossentropy": fused_categorical_crossentropy,
    "sparse_categorical_crossentropy": categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
}


def get_loss(loss: str | LossFn) -> LossFn:
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(f"unknown loss {loss!r}; known: {sorted(LOSSES)}") from None
