"""Convolutional model family (MNIST / CIFAR-10 scale).

Counterpart of ``distkeras_tpu/models/cnn.py:20-81``: 3x3 'SAME'
convolutions with ReLU and 2x2 max pooling, then dense layers, bfloat16
compute from float32 weights and float32 logits. Module names follow
flax's (``Conv_0``, ..., ``Dense_0``, ...). The input stays NHWC, as in the
reference; the convolutions run NCHW inside, and the features are flattened
in NHWC order, so the first ``Dense`` kernel carries across from the
reference without a permutation.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.bert import Dense, dropout
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = ["CNN", "Conv", "cifar10_cnn", "mnist_cnn"]


class Conv(nn.Conv2d):
    """flax ``nn.Conv(width, (3, 3), dtype=...)``: 'SAME' padding, float32
    weights, the convolution in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__(in_channels, out_channels, kernel_size=3, padding=1)
        self.compute_dtype = dtype

    def init_weights(self, generator) -> None:
        """lecun-normal over fan_in = in x kh x kw, zero bias."""
        fan_in = self.weight[0].numel()
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), padding=1)


class CNN(nn.Module):
    """Input ``[B, H, W, C]`` (NHWC) -> float32 logits ``[B, num_classes]``."""

    def __init__(self, input_shape: tuple[int, int, int], conv_features: Sequence[int],
                 dense_features: Sequence[int], num_classes: int, dropout_rate: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = compute_dtype
        h, w, c = input_shape
        for i, width in enumerate(conv_features):
            self.add_module(f"Conv_{i}", Conv(c, width, compute_dtype))
            h, w, c = h // 2, w // 2, width
        dims = [h * w * c, *dense_features]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"Dense_{i}", Dense(a, b, compute_dtype))
        self.add_module(f"Dense_{len(dense_features)}",
                        Dense(dims[-1], num_classes, torch.float32))
        self.num_conv, self.num_hidden = len(conv_features), len(dense_features)

    def init_weights(self, generator) -> None:
        for module in self.children():
            module.init_weights(generator)

    def forward(self, x, train: bool = False, rng: int | None = None):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i in range(self.num_conv):
            x = F.max_pool2d(F.relu(getattr(self, f"Conv_{i}")(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        p = self.dropout_rate if train else 0.0
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            x = dropout(x, p, None if rng is None else fold_in(rng, i))
        return getattr(self, f"Dense_{self.num_hidden}")(x)  # float32 logits


def cifar10_cnn(num_classes: int = 10) -> Model:
    """BASELINE config #2's CIFAR-10 CNN."""
    flops = 2.0 * (
        3 * 3 * 3 * 64 * 32 * 32
        + 3 * 3 * 64 * 128 * 16 * 16
        + 3 * 3 * 128 * 256 * 8 * 8
        + 4 * 4 * 256 * 256
        + 256 * num_classes
    )
    return Model(lambda: CNN((32, 32, 3), (64, 128, 256), (256,), num_classes,
                             dropout_rate=0.1),
                 name="cifar10_cnn", input_shape=(32, 32, 3), output_dim=num_classes,
                 flops_per_example=flops)


def mnist_cnn(num_classes: int = 10) -> Model:
    flops = 2.0 * (
        3 * 3 * 1 * 32 * 28 * 28
        + 3 * 3 * 32 * 64 * 14 * 14
        + 7 * 7 * 64 * 128
        + 128 * num_classes
    )
    return Model(lambda: CNN((28, 28, 1), (32, 64), (128,), num_classes),
                 name="mnist_cnn", input_shape=(28, 28, 1), output_dim=num_classes,
                 flops_per_example=flops)
