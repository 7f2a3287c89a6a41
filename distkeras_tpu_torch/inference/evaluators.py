"""Evaluation: counterpart of ``distkeras_tpu/inference/evaluators.py`` (a copy;
it is numpy only), itself parity with ``distkeras/evaluators.py``.

The reference's ``AccuracyEvaluator.evaluate(df)`` compares a prediction
column against a label column over a Spark DataFrame. Here it's one
vectorized comparison over host columns.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset

__all__ = ["AccuracyEvaluator", "PrecisionRecallEvaluator", "ConfusionMatrixEvaluator"]


class AccuracyEvaluator:
    """Classification accuracy over a Dataset (reference §
    ``AccuracyEvaluator``): same ``prediction_col``/``label_col`` surface."""

    def __init__(self, prediction_col: str = "prediction_index", label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        preds = np.asarray(dataset[self.prediction_col])
        labels = np.asarray(dataset[self.label_col])
        if preds.ndim > 1 and preds.shape[-1] > 1:
            preds = np.argmax(preds, axis=-1)
        if labels.ndim > 1 and labels.shape[-1] > 1:
            labels = np.argmax(labels, axis=-1)
        preds = preds.reshape(-1).astype(np.int64)
        labels = labels.reshape(-1).astype(np.int64)
        if preds.shape[0] != labels.shape[0]:
            raise ValueError("prediction/label length mismatch")
        return float(np.mean(preds == labels))


def _indices(col: np.ndarray) -> np.ndarray:
    col = np.asarray(col)
    if col.ndim > 1 and col.shape[-1] > 1:
        col = np.argmax(col, axis=-1)
    return col.reshape(-1).astype(np.int64)


class PrecisionRecallEvaluator:
    """Per-class precision/recall/F1 (beyond-reference addition; the
    reference shipped accuracy only)."""

    def __init__(self, prediction_col: str = "prediction_index",
                 label_col: str = "label", positive_class: int = 1):
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.positive_class = int(positive_class)

    def evaluate(self, dataset: Dataset) -> dict:
        preds = _indices(dataset[self.prediction_col])
        labels = _indices(dataset[self.label_col])
        p = self.positive_class
        tp = int(np.sum((preds == p) & (labels == p)))
        fp = int(np.sum((preds == p) & (labels != p)))
        fn = int(np.sum((preds != p) & (labels == p)))
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return {"precision": precision, "recall": recall, "f1": f1,
                "tp": tp, "fp": fp, "fn": fn}


class ConfusionMatrixEvaluator:
    """num_classes × num_classes count matrix (rows = true, cols = pred)."""

    def __init__(self, num_classes: int, prediction_col: str = "prediction_index",
                 label_col: str = "label"):
        self.num_classes = int(num_classes)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> np.ndarray:
        preds = _indices(dataset[self.prediction_col])
        labels = _indices(dataset[self.label_col])
        m = np.zeros((self.num_classes, self.num_classes), np.int64)
        np.add.at(m, (labels, preds), 1)
        return m
