"""Device milliseconds a step of the activities launched inside the port's
``forward`` range (the model with its head), over the traced stretch."""

from perfbench.program import device_ms_per_step


def read(t: dict) -> float | None:
    return device_ms_per_step(t, "forward")
