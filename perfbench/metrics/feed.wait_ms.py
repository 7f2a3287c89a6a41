"""Mean host milliseconds a window's step waited in the data feed's
``next()`` (the benchmark's own span around it)."""

import statistics


def read(t: dict) -> float | None:
    return statistics.fmean(t["feed_s"]) * 1e3 if t["feed_s"] else None
