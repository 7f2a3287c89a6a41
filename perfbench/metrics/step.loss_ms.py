"""Device milliseconds a step of the activities launched inside the port's
``loss`` and ``step_metrics`` ranges (K4 and accuracy's argmax over the
float32 logits), over the traced stretch."""

from perfbench.program import device_ms_per_step


def read(t: dict) -> float | None:
    return device_ms_per_step(t, "loss", "step_metrics")
