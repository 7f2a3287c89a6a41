"""K1-K3's share of their roofline: their summed bound a step
(``counts.py``, once a layer) over their summed device time a step, in
percent. Nothing where no flash kernel ran."""

from perfbench.trace import class_us


def read(t: dict) -> float | None:
    us = class_us(t["device"]).get("flash", 0.0)
    if not us:
        return None
    return 100.0 * t["bounds"]["flash"] * t["stretch_steps"] / (us / 1e6)
