"""The data layer: the columnar :class:`Dataset`, sparse columns, the
minibatch feed and the transformers (the reference's
``distkeras_tpu/data/__init__.py`` exports). The native data plane and the
streaming sources are :mod:`~distkeras_tpu_torch.data.native` and
:mod:`~distkeras_tpu_torch.data.streaming`."""

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.feed import DeviceFeed, minibatches
from distkeras_tpu_torch.data.sparse import SparseColumn
from distkeras_tpu_torch.data.transformers import (
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    Transformer,
)

__all__ = [
    "Dataset",
    "DeviceFeed",
    "minibatches",
    "Transformer",
    "OneHotTransformer",
    "MinMaxTransformer",
    "ReshapeTransformer",
    "DenseTransformer",
    "SparseColumn",
    "LabelIndexTransformer",
]
