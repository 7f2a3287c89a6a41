"""Mean host milliseconds a step in the port's ``feed_take`` range (the
consuming stream's wait on a batch's copy and the batch's hand-off to it),
over the traced stretch. With ``feed.put_ms`` it splits ``feed.wait_ms``:
what is left is the source's own time."""

from perfbench.program import host_us


def read(t: dict) -> float | None:
    us = host_us(t, "feed_take")
    return sum(us) / t["stretch_steps"] / 1e3 if us else None
