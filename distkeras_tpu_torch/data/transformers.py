"""Feature transformers: a numpy copy of ``distkeras_tpu/data/transformers.py``.

Each transformer keeps the reference's name and constructor surface, and its
``transform(dataset)`` applies one vectorized numpy op over whole columns.
All transformers are pure: they return a new :class:`Dataset`.

Reference components covered (SURVEY §2 inventory):
- ``OneHotTransformer``    (label scalar -> one-hot vector)
- ``MinMaxTransformer``    (linear rescale to [new_min, new_max])
- ``ReshapeTransformer``   (flat vector -> tensor shape, e.g. 784 -> 28x28x1)
- ``DenseTransformer``     (sparse vector -> dense; here: ensure ndarray/dtype)
- ``LabelIndexTransformer`` (prediction vector -> argmax label index)
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset

__all__ = [
    "Transformer",
    "TransformerPipeline",
    "OneHotTransformer",
    "MinMaxTransformer",
    "StandardScaleTransformer",
    "ReshapeTransformer",
    "DenseTransformer",
    "LabelIndexTransformer",
]


class Transformer:
    """Base class: a pure ``Dataset -> Dataset`` op.

    Mirrors reference ``distkeras/transformers.py`` § ``Transformer``.
    """

    def transform(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.transform(dataset)


class TransformerPipeline(Transformer):
    """Chain transformers: ``TransformerPipeline([a, b]).transform(ds)`` ==
    ``b.transform(a.transform(ds))`` (the manual chaining of the reference
    notebooks, packaged)."""

    def __init__(self, stages: list[Transformer]):
        self.stages = list(stages)

    def transform(self, dataset: Dataset) -> Dataset:
        for stage in self.stages:
            dataset = stage.transform(dataset)
        return dataset


class OneHotTransformer(Transformer):
    """Encode an integer label column as a one-hot float vector.

    Reference: ``distkeras/transformers.py`` § ``OneHotTransformer``.
    """

    def __init__(
        self,
        output_dim: int,
        input_col: str = "label",
        output_col: str = "label_encoded",
    ):
        self.output_dim = int(output_dim)
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        labels = np.asarray(dataset[self.input_col]).astype(np.int64).reshape(-1)
        if labels.size and (labels.min() < 0 or labels.max() >= self.output_dim):
            raise ValueError(
                f"label out of range [0, {self.output_dim}): "
                f"[{labels.min()}, {labels.max()}]"
            )
        onehot = np.zeros((labels.shape[0], self.output_dim), dtype=np.float32)
        onehot[np.arange(labels.shape[0]), labels] = 1.0
        return dataset.with_column(self.output_col, onehot)


class MinMaxTransformer(Transformer):
    """Rescale a feature column linearly into ``[new_min, new_max]``.

    Reference: ``distkeras/transformers.py`` § ``MinMaxTransformer``. Like the
    reference, the caller supplies the *data* range (``min``/``max``, e.g.
    0..255 for image bytes); rows are mapped as
    ``new_min + (x - min) * (new_max - new_min) / (max - min)``. If ``min`` /
    ``max`` are omitted they are fitted from the column.
    """

    def __init__(
        self,
        new_min: float = 0.0,
        new_max: float = 1.0,
        min: float | None = None,  # noqa: A002 - reference kwarg name
        max: float | None = None,  # noqa: A002 - reference kwarg name
        input_col: str = "features",
        output_col: str = "features_normalized",
        per_feature: bool = False,
    ):
        self.new_min = float(new_min)
        self.new_max = float(new_max)
        self.data_min = min
        self.data_max = max
        self.input_col = input_col
        self.output_col = output_col
        # Fitted mode only: normalize each trailing-dim feature by its own
        # min/max (tabular columns on very different scales) instead of the
        # global range.
        self.per_feature = bool(per_feature)

    def transform(self, dataset: Dataset) -> Dataset:
        x = np.asarray(dataset[self.input_col], dtype=np.float32)
        if self.per_feature and self.data_min is None and self.data_max is None:
            axes = tuple(range(x.ndim - 1))
            lo = x.min(axis=axes, keepdims=True)
            hi = x.max(axis=axes, keepdims=True)
            span = np.where(hi != lo, hi - lo, 1.0)
        else:
            lo = float(x.min()) if self.data_min is None else float(self.data_min)
            hi = float(x.max()) if self.data_max is None else float(self.data_max)
            span = hi - lo if hi != lo else 1.0
        scaled = self.new_min + (x - lo) * (self.new_max - self.new_min) / span
        return dataset.with_column(self.output_col, scaled.astype(np.float32))


class StandardScaleTransformer(Transformer):
    """Z-score normalization per trailing-dim feature: ``(x - mean) / std``
    (beyond-reference; the usual companion to MinMax for tabular data)."""

    def __init__(
        self,
        input_col: str = "features",
        output_col: str = "features_standardized",
        epsilon: float = 1e-8,
    ):
        self.input_col = input_col
        self.output_col = output_col
        self.epsilon = float(epsilon)

    def transform(self, dataset: Dataset) -> Dataset:
        x = np.asarray(dataset[self.input_col], dtype=np.float32)
        axes = tuple(range(x.ndim - 1))
        mu = x.mean(axis=axes, keepdims=True)
        sd = x.std(axis=axes, keepdims=True)
        out = (x - mu) / (sd + self.epsilon)
        return dataset.with_column(self.output_col, out.astype(np.float32))


class ReshapeTransformer(Transformer):
    """Reshape each row of a flat vector column into a tensor shape.

    Reference: ``distkeras/transformers.py`` § ``ReshapeTransformer``
    (e.g. 784 -> (28, 28, 1) for convolutional models).
    """

    def __init__(self, input_col: str, output_col: str, shape: tuple[int, ...]):
        self.input_col = input_col
        self.output_col = output_col
        self.shape = tuple(int(s) for s in shape)

    def transform(self, dataset: Dataset) -> Dataset:
        x = np.asarray(dataset[self.input_col])
        reshaped = x.reshape((x.shape[0], *self.shape))
        return dataset.with_column(self.output_col, reshaped)


class DenseTransformer(Transformer):
    """Densify a sparse feature column.

    Reference: ``distkeras/transformers.py`` § ``DenseTransformer`` converts
    Spark MLlib SparseVector columns to dense ones. The sparse type here is
    :class:`~distkeras_tpu_torch.data.sparse.SparseColumn` (CSR; built by
    ``SparseColumn.from_rows`` from the per-row ``(indices, values)`` +
    ``size`` form); this transformer makes it a contiguous float32
    ``[N, dim]`` ndarray. Dense inputs pass through with the same dtype and
    contiguity guarantee.
    """

    def __init__(self, input_col: str = "features", output_col: str = "features_dense"):
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        col = dataset[self.input_col]
        x = np.ascontiguousarray(np.asarray(col, dtype=np.float32))
        return dataset.with_column(self.output_col, x)


class LabelIndexTransformer(Transformer):
    """Map a prediction vector column to its argmax label index.

    Reference: ``distkeras/transformers.py`` § ``LabelIndexTransformer``
    (used after ``ModelPredictor`` to turn raw softmax outputs into a label
    column the evaluator can compare).
    """

    def __init__(
        self,
        output_dim: int | None = None,
        input_col: str = "prediction",
        output_col: str = "prediction_index",
        threshold: float | None = None,
    ):
        self.output_dim = output_dim  # kept for reference API parity; unused
        self.input_col = input_col
        self.output_col = output_col
        # Decision threshold for 1-d prediction columns. None = auto: 0.5 if
        # the column looks like probabilities (all values in [0, 1]), else 0
        # (logits — what ModelPredictor emits).
        self.threshold = threshold

    def transform(self, dataset: Dataset) -> Dataset:
        preds = np.asarray(dataset[self.input_col])
        if preds.ndim == 1:
            thr = self.threshold
            if thr is None:
                is_prob = preds.size == 0 or (preds.min() >= 0.0 and preds.max() <= 1.0)
                thr = 0.5 if is_prob else 0.0
            idx = (preds >= thr).astype(np.float32)
        else:
            idx = np.argmax(preds, axis=-1).astype(np.float32)
        return dataset.with_column(self.output_col, idx)
