"""Batched metrics: counterpart of ``distkeras_tpu/ops/metrics.py``."""

from __future__ import annotations

import torch

__all__ = ["accuracy"]


def accuracy(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Classification accuracy.

    ``preds``: logits/probability vectors ([..., C]) or already-argmaxed
    indices; ``targets``: one-hot ([..., C]) or integer indices ([...]).
    Works for per-example ([B, C] vs [B]) and per-position ([B, S, C] vs
    [B, S]) outputs alike."""
    if preds.ndim > 1 and preds.shape[-1] > 1:
        pred_idx = torch.argmax(preds, dim=-1)
    else:
        # Single-unit head: models emit logits, so the decision boundary is 0.
        pred_idx = (preds.reshape(preds.shape[0], -1)[:, 0] > 0).float()
    if targets.shape == pred_idx.shape:
        true_idx = targets
    elif targets.ndim == pred_idx.ndim + 1 and targets.shape[-1] > 1:
        true_idx = torch.argmax(targets, dim=-1)  # one-hot
    else:
        true_idx = targets.reshape(pred_idx.shape)
    return (pred_idx == true_idx.to(pred_idx.dtype)).float().mean()
