"""MLP model family: the MNIST MLP and the ATLAS-Higgs classifier.

Counterpart of ``distkeras_tpu/models/mlp.py``, with the same module names
(``Dense_0``, ``Dense_1``, ...) and parameter layout, so the reference's
weights carry across through :mod:`distkeras_tpu_torch.utils.bridge`. The
hidden layers compute in ``compute_dtype`` (bfloat16 by default) from
float32 weights, as flax's ``nn.Dense(dtype=...)`` does; the output layer
computes in float32, so the logits are float32.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.bert import Dense, dropout
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = ["MLP", "mnist_mlp", "higgs_mlp"]


class MLP(nn.Module):
    """``in_dim -> features... -> num_classes`` with ReLU (and dropout in
    train mode after each hidden layer). Input ``[B, ...]`` is flattened."""

    def __init__(self, in_dim: int, features: Sequence[int], num_classes: int,
                 dropout_rate: float = 0.0, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = compute_dtype
        dims = [int(in_dim), *features]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"Dense_{i}", Dense(a, b, compute_dtype))
        self.add_module(f"Dense_{len(features)}", Dense(dims[-1], num_classes, torch.float32))
        self.num_hidden = len(features)

    def init_weights(self, generator) -> None:
        """flax's initialisers: lecun-normal kernels, zero biases."""
        for module in self.children():
            module.init_weights(generator)

    def forward(self, x, train: bool = False, rng: int | None = None):
        x = x.reshape(x.shape[0], -1).to(self.compute_dtype)
        p = self.dropout_rate if train else 0.0
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            x = dropout(x, p, None if rng is None else fold_in(rng, i))
        return getattr(self, f"Dense_{self.num_hidden}")(x)  # float32 logits


def _mlp_flops(in_dim: int, features: Sequence[int], num_classes: int) -> float:
    dims = [in_dim, *features, num_classes]
    return float(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))


def mnist_mlp(hidden: Sequence[int] = (500, 300), num_classes: int = 10,
              dropout: float = 0.0) -> Model:
    """The MNIST MLP of the reference's ``examples/mnist.py``."""
    hidden = tuple(hidden)
    return Model(lambda: MLP(784, hidden, num_classes, dropout_rate=dropout),
                 name="mnist_mlp", input_shape=(784,), output_dim=num_classes,
                 flops_per_example=_mlp_flops(784, hidden, num_classes))


def higgs_mlp(input_dim: int = 28, hidden: Sequence[int] = (500, 500, 500),
              num_classes: int = 2) -> Model:
    """ATLAS-Higgs tabular classifier (the reference's
    ``examples/workflow.ipynb``)."""
    hidden = tuple(hidden)
    return Model(lambda: MLP(input_dim, hidden, num_classes),
                 name="higgs_mlp", input_shape=(input_dim,), output_dim=num_classes,
                 flops_per_example=_mlp_flops(input_dim, hidden, num_classes))
