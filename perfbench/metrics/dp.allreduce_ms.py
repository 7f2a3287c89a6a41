"""Device milliseconds a step in NCCL's kernels (the data-parallel step's
gradient all-reduce), over the traced stretch. Nothing on one card."""

from perfbench.trace import class_us


def read(t: dict) -> float | None:
    us = class_us(t["device"]).get("nccl", 0.0)
    return us / t["stretch_steps"] / 1e3 if us else None
