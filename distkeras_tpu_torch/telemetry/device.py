"""Device-side observability: memory accounting and profiling.

Counterpart of the reference's ``distkeras_tpu/telemetry/device.py``. The
reference probes ``jax.Device.memory_stats()``; the port asks the CUDA
caching allocator (``torch.cuda.memory_allocated`` /
``max_memory_allocated``) and the CUDA runtime (``torch.cuda.mem_get_info`` for
the card's capacity) about one torch device.

**Memory accounting.** :func:`device_memory` never raises and returns a
typed :class:`DeviceMemory` whose ``available`` flag distinguishes "the
backend has no data" from "0 bytes in use": the CPU has no allocator
statistics, so a CPU device is the ``available=False`` sentinel with every
byte field None, never 0. :func:`publish_memory_gauges` pushes the same
probe into a :class:`~distkeras_tpu_torch.telemetry.registry.MetricsRegistry`
as per-device labeled gauges (``device_bytes_in_use`` /
``device_bytes_limit`` / ``device_peak_bytes_in_use`` /
``device_memory_headroom_bytes``), alongside the workload-side bytes the
caller already knows (params, KV pool), under the reference's names.

**Profiling.** :func:`profile_trace` wraps ``torch.profiler`` as a context
manager and writes a Chrome trace of the block into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

__all__ = [
    "DeviceMemory",
    "device_memory",
    "all_device_memory",
    "publish_memory_gauges",
    "profile_trace",
]


@dataclasses.dataclass(frozen=True)
class DeviceMemory:
    """One device's memory picture at probe time.

    ``available=False`` is the typed "no data" sentinel: the device has no
    allocator statistics (the CPU), or the probe raised, and every byte
    field is None — deliberately NOT 0, so a dashboard can never mistake a
    blind backend for an empty one.
    """

    device: str
    available: bool
    bytes_in_use: int | None = None
    bytes_limit: int | None = None
    peak_bytes_in_use: int | None = None

    @property
    def headroom_bytes(self) -> int | None:
        """``bytes_limit - bytes_in_use`` when both are known."""
        if self.bytes_in_use is None or self.bytes_limit is None:
            return None
        return self.bytes_limit - self.bytes_in_use

    def to_dict(self) -> dict:
        out = {"device": self.device, "available": self.available,
               "bytes_in_use": self.bytes_in_use,
               "bytes_limit": self.bytes_limit,
               "peak_bytes_in_use": self.peak_bytes_in_use}
        hr = self.headroom_bytes
        if hr is not None:
            out["headroom_bytes"] = hr
        return out


def _device_name(device) -> str:
    import torch

    dev = torch.device(device)
    return f"{dev.type}:{dev.index or 0}"


def device_memory(device) -> DeviceMemory:
    """Probe one torch device's memory; NEVER raises. A CUDA device reports
    the caching allocator's live and peak bytes and the card's capacity;
    anything else (or a probe that raises) yields the ``available=False``
    sentinel."""
    import torch

    try:
        name = _device_name(device)
    except Exception:
        return DeviceMemory(device=str(device), available=False)
    dev = torch.device(device)
    if dev.type != "cuda":
        return DeviceMemory(device=name, available=False)
    try:
        _free, total = torch.cuda.mem_get_info(dev)
        return DeviceMemory(
            device=name,
            available=True,
            bytes_in_use=int(torch.cuda.memory_allocated(dev)),
            bytes_limit=int(total),
            peak_bytes_in_use=int(torch.cuda.max_memory_allocated(dev)),
        )
    except Exception:
        return DeviceMemory(device=name, available=False)


def all_device_memory(devices=None) -> list[DeviceMemory]:
    """Probe every given device, or every visible CUDA device (the CPU
    sentinel when there is none)."""
    if devices is None:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)] or ["cpu"]
    return [device_memory(d) for d in devices]


def publish_memory_gauges(
    registry,
    devices=None,
    params_bytes: int | None = None,
    kv_pool_bytes: int | None = None,
    kv_pool_peak_bytes: int | None = None,
) -> list[DeviceMemory]:
    """Publish per-device memory gauges (and the caller's workload-side
    byte counts) into ``registry``; returns the probed list so callers
    can also render it (healthz, statusz).

    Per device: ``device_memory_stats_available{device=...}`` is ALWAYS
    set (1/0 — the scrapeable face of the typed sentinel); the byte
    gauges are set only when the device reports them, so an unavailable
    backend shows NO byte series rather than a flat 0."""
    mems = all_device_memory(devices)
    for mem in mems:
        registry.gauge(
            "device_memory_stats_available",
            help="1 when the backend publishes memory_stats() for this "
                 "device; 0 = no data (byte gauges absent, not zero)",
            device=mem.device).set(1.0 if mem.available else 0.0)
        if not mem.available:
            continue
        pairs = (
            ("device_bytes_in_use", "live device bytes in use",
             mem.bytes_in_use),
            ("device_bytes_limit", "device memory capacity",
             mem.bytes_limit),
            ("device_peak_bytes_in_use", "high-water device bytes",
             mem.peak_bytes_in_use),
            ("device_memory_headroom_bytes",
             "bytes_limit - bytes_in_use", mem.headroom_bytes),
        )
        for name, help_, val in pairs:
            if val is not None:
                registry.gauge(name, help=help_, device=mem.device).set(val)
    if params_bytes is not None:
        registry.gauge(
            "model_params_bytes",
            help="bytes of the live model parameters").set(params_bytes)
    if kv_pool_bytes is not None:
        registry.gauge(
            "kv_pool_reserved_bytes",
            help="bytes reserved by the KV block pool").set(kv_pool_bytes)
    if kv_pool_peak_bytes is not None:
        registry.gauge(
            "kv_pool_peak_bytes",
            help="high-water bytes of KV blocks in use").set(
                kv_pool_peak_bytes)
    return mems


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile everything inside the block with ``torch.profiler`` (CPU and,
    where there is a card, CUDA activity) and write a Chrome trace to
    ``log_dir/trace.json``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
