"""Median host milliseconds of the port's ``optimizer_step`` range (the
optimizer's step and ``zero_grad``, one a step), over the traced stretch."""

import statistics

from perfbench.program import host_us


def read(t: dict) -> float | None:
    us = host_us(t, "optimizer_step")
    return statistics.median(us) / 1e3 if us else None
