"""Device milliseconds a step in the kernels the optimizer's step launched
(under torch.optim's ``Optimizer.step#`` host range), over the traced
stretch."""


def read(t: dict) -> float | None:
    us = t["optimizer_us"]
    return us / t["stretch_steps"] / 1e3 if us else None
