"""Reduction of a traced stretch of the window to what the per-layer readers
read.

The stretch is a run of whole steps under ``torch.profiler`` (CPU and CUDA
activity), bracketed by synchronizes. From it:

- every device activity's name and interval (kernels, copies, sets);
- the device time of the kernels launched inside the optimizer's step (the
  ``Optimizer.step#...`` range torch.optim records on the host);
- the host ranges the benchmark records around the calls it makes
  (``perfbench.*``) and the optimizer's, to name what the host was doing
  while the device sat idle.

Busy time is the union of the device activities' intervals, so that work
overlapping on two streams counts once.
"""

from __future__ import annotations

import re
from collections import defaultdict

SPAN_PREFIX = "perfbench."
NAME_CHARS = 160  # a device operation's name in the breakdown, cut to this
_OPTIMIZER = "Optimizer.step#"
_GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas|s1688|s16816|h16816", re.IGNORECASE)


def kernel_class(name: str) -> str:
    """The layer a device activity belongs to, by its name: ``flash``
    (K1-K3 and their generic route), ``xent`` (K4-K6), ``nccl``, ``gemm``
    (cuBLAS and CUTLASS products), ``copy`` (memcpy and memset) or
    ``other`` (the elementwise and reduction kernels)."""
    if "flash_" in name:
        return "flash"
    if "xent_" in name:
        return "xent"
    if "nccl" in name.lower():
        return "nccl"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copy"
    if _GEMM.search(name):
        return "gemm"
    return "other"


def reduce_profile(prof) -> dict:
    """The profile's device activities ``[(name, start_us, end_us)]``, the
    device microseconds of the optimizer's kernels, and the host ranges
    ``[(name, start_us, end_us)]``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    optimizer_us = 0.0
    for e in prof.events():
        if e.device_type == cuda:
            # A host range also shows on the device's timeline as an
            # annotation; it is no device activity.
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)
                    or e.name.startswith(_OPTIMIZER)):
                device.append((e.name, float(e.time_range.start), float(e.time_range.end)))
            continue
        if e.name.startswith(SPAN_PREFIX) or e.name.startswith(_OPTIMIZER):
            spans.append((e.name, float(e.time_range.start), float(e.time_range.end)))
        if e.kernels:
            parent = e
            while parent is not None and not parent.name.startswith(_OPTIMIZER):
                parent = parent.cpu_parent
            if parent is not None:
                optimizer_us += sum(k.duration for k in e.kernels)
    device.sort(key=lambda d: d[1])
    return {"device": device, "optimizer_us": optimizer_us, "spans": spans}


def busy_intervals(device: list) -> list[tuple[float, float]]:
    """The union of the activities' intervals, as disjoint sorted
    intervals."""
    out: list[list[float]] = []
    for _, start, end in sorted(device, key=lambda d: d[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy_us(device: list) -> float:
    return sum(b - a for a, b in busy_intervals(device))


def class_us(device: list) -> dict[str, float]:
    """Device microseconds by :func:`kernel_class`."""
    out: dict[str, float] = defaultdict(float)
    for name, start, end in device:
        out[kernel_class(name)] += end - start
    return dict(out)


def top_ops(device: list, n: int = 10) -> list[tuple[str, float]]:
    """The ``n`` device operations by name that took most time, in
    seconds."""
    by_name: dict[str, float] = defaultdict(float)
    for name, start, end in device:
        by_name[name[:NAME_CHARS]] += (end - start) / 1e6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def idle_gaps(device: list, spans: list, n: int = 10) -> list[tuple[str, float]]:
    """The ``n`` longest gaps between busy intervals, in seconds, each named
    by the innermost host range it began in (``host`` where the host was in
    none of them)."""
    busy = busy_intervals(device)
    gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in zip(busy, busy[1:])
            if b_start > a_end]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for start, end in gaps[:n]:
        inside = [s for s in spans if s[1] <= start < s[2]]
        name = max(inside, key=lambda s: s[1])[0] if inside else "host"
        out.append((name, (end - start) / 1e6))
    return out
