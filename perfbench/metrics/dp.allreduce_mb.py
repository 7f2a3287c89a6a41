"""Megabytes (10^6 bytes) of the buffer the port's gradient all-reduce
reduces a step, by its own counter: ``all_reduce_mean_.bytes`` over
``.calls``, the flattened gradients and stacked metrics of one call (a step
makes one). This is the reduced buffer's size, not the traffic: a ring
all-reduce sends about 2(n-1)/n of it a rank. Nothing where the program
keeps no such counter or made no all-reduce."""

import sys


def read(t: dict) -> float | None:
    step = sys.modules.get("distkeras_tpu_torch.training.step")
    counted = getattr(step, "all_reduce_mean_", None)
    calls = getattr(counted, "calls", None)
    if not calls:
        return None
    return counted.bytes / calls / 1e6
