"""The port's own ranges in a traced stretch, for the per-layer metrics that
read them (``step.*``, ``optimizer.host_ms``, ``feed.put_ms``).

While ``torch.profiler`` records, each span of the port
(``distkeras_tpu_torch/telemetry/spans.py``) opens a ``record_function``
range named :data:`PREFIX` and the span's name: the training step's
``forward``, ``loss``, ``backward``, ``step_metrics``, ``grad_all_reduce``
and ``optimizer_step``, the feed's ``feed_put`` and ``feed_take``. From the
profile this reads, by range name:

- the host microseconds of each of its ranges;
- the device microseconds of the device activities launched inside it. An
  activity belongs to the innermost program range whose host interval holds
  the start of the host operation that launched it, on any thread: the
  autograd engine launches a CUDA backward from a thread of its own, while
  the range that waits for it is on the calling thread.

The device activities are those :func:`perfbench.trace.reduce_profile` keeps,
so what is attributed and what is not add up to the stretch's device time.
The host operation that launched an activity is the CUDA API call with its
correlation id: its start is the launch's own time, on the launching
thread. (Torch's own link of an activity to the operator above
that call, a host event's ``kernels``, was seen on the card to count some
activities more than once.)

The harness hands its readers the reduced trace ``t``, which keeps no program
range; :func:`ranges` finds the profile ``t`` was reduced from on the
caller's stack (a local of the harness's ``_read_trace``), keeps its result
in ``t`` for the next reader, and raises where it finds none, so that a
change to the harness fails the traced run and does not silence the
metrics. A profile with no program range (a program without them) reads as
None. This lookup goes once ``reduce_profile`` hands the ranges over in
``t`` itself.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict

from perfbench.trace import _OPTIMIZER, SPAN_PREFIX

PREFIX = "dk."  # the port's ``telemetry.spans.RANGE_PREFIX``


def _is_annotation(e) -> bool:
    """A host range as it shows on the device's timeline: no activity."""
    return (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)
            or e.name.startswith(_OPTIMIZER) or e.name.startswith(PREFIX))


def _innermost(spans: list) -> tuple[list, list]:
    """``(bounds, names)`` of ``[(name, start, end)]``: between
    ``bounds[i]`` and ``bounds[i + 1]`` the innermost of the spans is
    ``names[i]`` (None outside them all), the one that began last."""
    bounds = sorted({x for _, start, end in spans for x in (start, end)})
    names = []
    for b in bounds:
        inside = [s for s in spans if s[1] <= b < s[2]]
        names.append(max(inside, key=lambda s: (s[1], -s[2]))[0] if inside else None)
    return bounds, names


def _at(bounds: list, names: list, t: float):
    i = bisect.bisect_right(bounds, t) - 1
    return names[i] if i >= 0 else None


def reduce_events(events) -> dict | None:
    """The program's ranges in a profile's events: ``ranges`` ``[(name,
    start_us, end_us)]``, ``host_us`` (name -> each range's host µs),
    ``device_us`` (name -> device µs of the activities launched inside it),
    ``ops_us`` (the same by activity name), ``device_total_us`` and
    ``unattributed_us`` (the part launched inside no range); None where
    there is no program range.

    An activity was launched by the CUDA API call (``cuda*``, ``cu*``) that
    shares its correlation id, on the host's timeline."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, device, launched_at = [], [], {}
    for e in events:
        if e.device_type == cuda:
            if not _is_annotation(e):
                device.append(e)
        elif e.name.startswith(PREFIX):
            spans.append((e.name, float(e.time_range.start), float(e.time_range.end)))
        elif e.name.startswith("cu"):
            launched_at[e.id] = float(e.time_range.start)
    if not spans:
        return None
    spans.sort(key=lambda s: s[1])
    bounds, names = _innermost(spans)
    host_us: dict[str, list[float]] = defaultdict(list)
    for name, start, end in spans:
        host_us[name].append(end - start)
    device_us: dict[str, float] = defaultdict(float)
    ops_us: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
    total = 0.0
    for e in device:
        us = float(e.time_range.end) - float(e.time_range.start)
        total += us
        start = launched_at.get(e.id)
        name = _at(bounds, names, start) if start is not None else None
        if name is not None:
            device_us[name] += us
            ops_us[name][e.name] += us
    return {"ranges": spans, "host_us": dict(host_us), "device_us": dict(device_us),
            "ops_us": {k: dict(v) for k, v in ops_us.items()},
            "device_total_us": total, "unattributed_us": total - sum(device_us.values())}


def _profile_on_stack():
    """The ``torch.profiler.profile`` nearest up the caller's stack."""
    from torch.profiler import profile

    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, profile):
                return value
        frame = frame.f_back
    return None


def ranges(t: dict) -> dict | None:
    """:func:`reduce_events` of the profile ``t`` was reduced from, kept
    in ``t``; raises ``LookupError`` where no profile is on the stack."""
    if "program" not in t:
        prof = _profile_on_stack()
        if prof is None:
            raise LookupError("no torch.profiler.profile up the stack of a traced read: "
                              "the harness no longer holds the profile it reduced")
        t["program"] = reduce_events(prof.events())
    return t["program"]


def device_ms_per_step(t: dict, *names: str) -> float | None:
    """Device ms a step of the activities launched inside the program
    ranges ``names`` (without the prefix); None where there is no such
    range or no device activity."""
    r = ranges(t)
    if r is None or not r["device_total_us"] or not any(PREFIX + n in r["host_us"]
                                                         for n in names):
        return None
    return sum(r["device_us"].get(PREFIX + n, 0.0) for n in names) / t["stretch_steps"] / 1e3


def host_us(t: dict, name: str) -> list[float] | None:
    """Host µs of each range ``name`` (without the prefix); None where there
    is none."""
    r = ranges(t)
    return None if r is None else r["host_us"].get(PREFIX + name)
