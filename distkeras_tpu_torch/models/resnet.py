"""ResNet family (ResNet-18/50): counterpart of ``distkeras_tpu/models/resnet.py``.

BASELINE config #4 is "ResNet-50 / ImageNet via AEASGD". The module names
and parameter layout follow the reference's flax tree (``conv_init``,
``bn_init``, ``BottleneckBlock_<k>`` / ``BasicBlock_<k>`` numbered across
the stages, inside each ``Conv_<i>``, ``BatchNorm_<i>``, ``proj``,
``proj_bn``, and ``head``), so the weights carry across through
:mod:`distkeras_tpu_torch.utils.bridge`, BatchNorm's running statistics as
the ``mean``/``var`` buffers (the reference's ``batch_stats``). The
numerics are the reference's:

- the input is NHWC, as there; the convolutions see it as an NCHW view of
  the same memory, which is ``channels_last``, and their weights are made
  ``channels_last`` on the card, so cuDNN runs NHWC kernels;
- convolutions run in ``dtype`` (bfloat16 by default) from float32 weights
  with flax's ``padding="SAME"``, which pads the far side more when the
  total is odd (the 7x7 stride-2 stem on 224 pads 2 and 3; a 3x3 stride-2
  convolution on 56 pads 0 and 1): the padding is explicit, then the
  convolution runs unpadded; max pooling pads with -inf the same way;
- BatchNorm computes its statistics and its output in float32 (float64
  for a float64 input; epsilon 1e-5), the variance as E[x^2] - E[x]^2 clipped at 0, and in train mode
  updates the running statistics as flax does, ``0.9 * running + 0.1 *
  batch`` with the biased batch variance (``nn.BatchNorm2d`` would use the
  unbiased one); the last BatchNorm of each block starts with a zero scale;
- the residual add and everything after the stem's BatchNorm run in
  float32, and the head is a float32 ``Dense``.

In train mode the forward returns ``(logits, new_stats)``, the updated
running statistics under their ``state_dict`` names, which
:meth:`Model.apply` hands back as the new model state.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.bert import Dense
from distkeras_tpu_torch.models.core import Model

__all__ = ["BasicBlock", "BatchNorm", "BottleneckBlock", "ResNet", "resnet18", "resnet50"]

_MOMENTUM = 0.9
_EPSILON = 1e-5


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial axis: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    h_lo, h_hi = _same_pads(x.shape[2], kernel, stride)
    w_lo, w_hi = _same_pads(x.shape[3], kernel, stride)
    if h_lo == h_hi == w_lo == w_hi == 0:
        return x
    return F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=value)


class Conv(nn.Conv2d):
    """flax ``nn.Conv(out, (k, k), (s, s), use_bias=False, dtype=dtype)``:
    ``"SAME"`` padding, float32 weights, the convolution in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 dtype: torch.dtype):
        super().__init__(in_channels, out_channels, kernel, stride=stride, bias=False)
        self.compute_dtype = dtype

    def init_weights(self, generator) -> None:
        """lecun-normal over fan_in = in x kh x kw (flax's default)."""
        std = (1.0 / self.weight[0].numel()) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)

    def forward(self, x):
        dt = self.compute_dtype
        x = _pad_same(x.to(dt), self.kernel_size[0], self.stride[0])
        weight = self.weight.to(dt)
        if weight.is_cuda:
            weight = weight.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, weight, None, self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    the channel axis of an NCHW-shaped tensor: parameters ``weight`` (flax's
    ``scale``) and ``bias``, buffers ``mean`` and ``var``. ``forward(x,
    updates)`` normalises with the batch's statistics and writes the new
    running ones into ``updates`` (train mode), or with the running ones
    when ``updates`` is None."""

    def __init__(self, features: int, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))
        self.zero_scale = zero_scale
        self.path = ""  # this module's name in the model, set by ResNet

    def init_weights(self, generator) -> None:
        if self.zero_scale:
            nn.init.zeros_(self.weight)
        else:
            nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.mean)
        nn.init.ones_(self.var)

    def forward(self, x, updates: dict | None):
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if updates is None:
            mean, var = self.mean, self.var
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                updates[f"{self.path}.mean"] = _MOMENTUM * self.mean + (1 - _MOMENTUM) * mean
                updates[f"{self.path}.var"] = _MOMENTUM * self.var + (1 - _MOMENTUM) * var
        mul = torch.rsqrt(var + _EPSILON) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class _Block(nn.Module):
    """The residual tail both blocks share: a ``proj`` convolution and
    ``proj_bn`` on the shortcut when the shape changes (more channels or a
    stride), then ``relu(shortcut + y)`` in float32."""

    def _shortcut(self, in_channels: int, out_channels: int, stride: int, dtype) -> None:
        self.has_proj = in_channels != out_channels or stride != 1
        if self.has_proj:
            self.proj = Conv(in_channels, out_channels, 1, stride, dtype)
            self.proj_bn = BatchNorm(out_channels)

    def _residual(self, x, y, updates):
        if self.has_proj:
            x = self.proj_bn(self.proj(x), updates)
        return F.relu(x.to(y.dtype) + y)


class BottleneckBlock(_Block):
    """1x1, 3x3 (strided), 1x1 to ``4 x features`` channels."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_channels = features * 4
        self.Conv_0 = Conv(in_channels, features, 1, 1, dtype)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, stride, dtype)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = Conv(features, self.out_channels, 1, 1, dtype)
        self.BatchNorm_2 = BatchNorm(self.out_channels, zero_scale=True)
        self._shortcut(in_channels, self.out_channels, stride, dtype)

    def forward(self, x, updates):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), updates))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), updates))
        y = self.BatchNorm_2(self.Conv_2(y), updates)
        return self._residual(x, y, updates)


class BasicBlock(_Block):
    """3x3 (strided), 3x3 at ``features`` channels."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_channels = features
        self.Conv_0 = Conv(in_channels, features, 3, stride, dtype)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(features, zero_scale=True)
        self._shortcut(in_channels, features, stride, dtype)

    def forward(self, x, updates):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), updates))
        y = self.BatchNorm_1(self.Conv_1(y), updates)
        return self._residual(x, y, updates)


class ResNet(nn.Module):
    """Input ``[B, H, W, 3]`` (NHWC) -> float32 logits ``[B, num_classes]``;
    in train mode ``(logits, new_stats)``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type, num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv_init = Conv(3, width, 7, 2, dtype)
        self.bn_init = BatchNorm(width)
        self.block_names = []
        channels = width
        for i, num_blocks in enumerate(stage_sizes):
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(channels, width * 2**i, stride, dtype)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block)
                self.block_names.append(name)
                channels = block.out_channels
        self.head = Dense(channels, num_classes, torch.float32)
        for name, module in self.named_modules():
            if isinstance(module, BatchNorm):
                module.path = name

    def init_weights(self, generator) -> None:
        for module in self.modules():
            if module is not self and hasattr(module, "init_weights"):
                module.init_weights(generator)

    def forward(self, x, train: bool = False, rng: int | None = None):
        updates = {} if train else None
        x = self.bn_init(self.conv_init(x.permute(0, 3, 1, 2)), updates)
        x = F.max_pool2d(_pad_same(F.relu(x), 3, 2, -torch.inf), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, updates)
        logits = self.head(x.mean(dim=(2, 3)))
        return (logits, updates) if train else logits


# Forward FLOPs per 224x224x3 example (multiply-adds x 2).
_RESNET50_FLOPS = 4.1e9 * 2
_RESNET18_FLOPS = 1.8e9 * 2


def _resnet(name, stage_sizes, block_cls, flops, num_classes, image_size, dtype) -> Model:
    return Model(lambda: ResNet(stage_sizes, block_cls, num_classes, dtype=dtype),
                 name=name, input_shape=(image_size, image_size, 3), output_dim=num_classes,
                 flops_per_example=flops * (image_size / 224.0) ** 2)


def resnet50(num_classes: int = 1000, image_size: int = 224,
             dtype: torch.dtype = torch.bfloat16) -> Model:
    """BASELINE config #4's ResNet-50 (bottleneck blocks 3, 4, 6, 3)."""
    return _resnet("resnet50", (3, 4, 6, 3), BottleneckBlock, _RESNET50_FLOPS,
                   num_classes, image_size, dtype)


def resnet18(num_classes: int = 1000, image_size: int = 224,
             dtype: torch.dtype = torch.bfloat16) -> Model:
    """ResNet-18 (basic blocks 2, 2, 2, 2)."""
    return _resnet("resnet18", (2, 2, 2, 2), BasicBlock, _RESNET18_FLOPS,
                   num_classes, image_size, dtype)
