"""Device milliseconds a step in the kernels that are neither matrix
products, nor the hand kernels, nor the optimizer's, nor NCCL's
(LayerNorm, casts, dropout, GELU, residuals, softmax-free reductions, the
gradient buffers' copies), over the traced stretch."""

from perfbench.trace import class_us


def read(t: dict) -> float | None:
    us = class_us(t["device"]).get("other", 0.0) - t["optimizer_us"]
    return us / t["stretch_steps"] / 1e3 if us > 0 else None
