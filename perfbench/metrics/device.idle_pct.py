"""The card's idle share over the traced stretch: 1 less the union of its
activities' intervals over the stretch's time, in percent."""

from perfbench.trace import busy_us


def read(t: dict) -> float | None:
    if not t["device"]:
        return None
    return 100.0 * (1.0 - busy_us(t["device"]) / 1e6 / t["stretch_s"])
