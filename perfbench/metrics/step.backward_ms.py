"""Device milliseconds a step of the activities launched inside the port's
``backward`` range (K2, K3, K5, K6 and the gradients' elementwise work,
from the autograd engine's thread too), over the traced stretch."""

from perfbench.program import device_ms_per_step


def read(t: dict) -> float | None:
    return device_ms_per_step(t, "backward")
