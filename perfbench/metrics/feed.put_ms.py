"""Mean host milliseconds a step in the port's ``feed_put`` range (a batch's
pinning copy and its enqueue on the feed's side stream), over the traced
stretch."""

from perfbench.program import host_us


def read(t: dict) -> float | None:
    us = host_us(t, "feed_put")
    return sum(us) / t["stretch_steps"] / 1e3 if us else None
