"""Device milliseconds a step in matrix-product kernels (cuBLAS and CUTLASS:
the layers' projections and MLP through ``F.linear``, the tied head), over
the traced stretch."""

from perfbench.trace import class_us


def read(t: dict) -> float | None:
    us = class_us(t["device"]).get("gemm", 0.0)
    return us / t["stretch_steps"] / 1e3 if us else None
