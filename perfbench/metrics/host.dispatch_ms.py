"""Median host milliseconds of one call of the training step in the window
(the benchmark's own span around it). The step does not wait for the
device, so this is what it costs the host to enqueue a step."""

import statistics


def read(t: dict) -> float | None:
    return statistics.median(t["dispatch_s"]) * 1e3 if t["dispatch_s"] else None
