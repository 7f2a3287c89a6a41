"""Step timing, MFU, and structured metric records.

Counterpart of ``distkeras_tpu/tracing.py``:

- :class:`StepTimer` — per-step wall times with the derived metrics
  (samples/sec/chip, step-time variance, tail percentiles, MFU against
  :func:`device_peak_flops`, the card's published dense bf16 rate);
- :func:`compiled_step_flops` — the flops of one call of a step function,
  counted by ``torch.utils.flop_counter`` (the counterpart of XLA's cost
  model);
- :class:`MetricStream` — structured per-step metric records with pluggable
  sinks (in-memory, JSONL file, stdout).

Spans and the profiler capture live in :mod:`distkeras_tpu_torch.telemetry`.
``span`` / ``enable_tracing`` / ``disable_tracing`` / ``active_tracer`` /
``Tracer`` and ``trace`` (the ``torch.profiler`` capture,
:func:`distkeras_tpu_torch.telemetry.device.profile_trace`) stay importable
here as deprecated shims: a module ``__getattr__`` that warns and forwards.
"""

from __future__ import annotations

import copy
import json
import statistics
import time
import warnings
from typing import Any, Callable

from distkeras_tpu_torch.telemetry.registry import percentile, sanitize_metric_name

# Names that moved to distkeras_tpu_torch.telemetry; accessing them here
# still works but warns.
_TELEMETRY_SHIMS = frozenset(
    {"span", "enable_tracing", "disable_tracing", "active_tracer", "Tracer"})


def __getattr__(name: str):
    if name in _TELEMETRY_SHIMS:
        warnings.warn(
            f"distkeras_tpu_torch.tracing.{name} is deprecated; import it from "
            f"distkeras_tpu_torch.telemetry (it is a pure re-export)",
            DeprecationWarning, stacklevel=2)
        from distkeras_tpu_torch.telemetry import spans as _spans

        return getattr(_spans, name)
    if name in ("trace", "profile_trace"):
        warnings.warn(
            f"distkeras_tpu_torch.tracing.{name} is deprecated; use "
            "distkeras_tpu_torch.telemetry.device.profile_trace (the "
            "torch.profiler capture)",
            DeprecationWarning, stacklevel=2)
        from distkeras_tpu_torch.telemetry.device import profile_trace

        return profile_trace
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "StepTimer",
    "MetricStream",
    "device_peak_flops",
    "compiled_step_flops",
    # re-exported from distkeras_tpu_torch.telemetry (canonical home):
    "trace",
    "span",
    "enable_tracing",
    "disable_tracing",
    "active_tracer",
    "Tracer",
]


# Published dense (no sparsity) bf16 tensor-core rate per card, FLOP/s,
# matched against torch.cuda.get_device_name in this order.
_PEAK_FLOPS = (
    ("h100 pcie", 756.0e12),
    ("h100 nvl", 835.5e12),
    ("h100", 989.4e12),  # "NVIDIA H100 80GB HBM3": the SXM card
    ("h200", 989.4e12),
    ("gh200", 989.4e12),
    ("a100", 312.0e12),
)


def device_peak_flops(device=None) -> float | None:
    """The card's published dense bf16 rate in FLOP/s: ``device`` (default
    the current CUDA device) looked up by its name. None on the CPU, without
    a card and for a card not in the table."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, flops in _PEAK_FLOPS:
        if key in name:
            return flops
    return None


def compiled_step_flops(step_fn, *args) -> float | None:
    """Flops of ONE call of ``step_fn(*args)``, counted while it runs once
    on deep copies of ``args``: the caller's weights, optimizer and random
    generators are left as they were (the global CPU and CUDA generators
    are forked around the call).

    What is counted: every matrix product, convolution and attention
    product that ``torch.utils.flop_counter.FlopCounterMode`` sees (forward
    and backward), plus, for each launch of a hand-written kernel, which the
    counter cannot see, the matrix-product flops of the kernel's plain
    version: the flash forward (K1) ``4·BH·S_q·S_k·D``, its dQ (K2) and
    dK/dV (K3) ``4·BH·S_q·S_k·D`` each, the full square under a causal mask
    as the plain version computes it. Elementwise work (softmax, norms, the
    optimizer, the fused cross-entropy K4-K6) is not counted, where XLA's
    cost model counts it, so the count reads a little below the
    reference's. The hand-written kernels launch once more here, on the
    copies. Returns None when nothing was counted or the call failed."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from distkeras_tpu_torch.ops.launches import kernel_flops

    devices = list(range(torch.cuda.device_count())) if torch.cuda.is_available() else []
    try:
        copies = copy.deepcopy(args)
        with torch.random.fork_rng(devices=devices), kernel_flops() as kernels:
            counter = FlopCounterMode(display=False)
            with counter:
                step_fn(*copies)
            if devices:
                torch.cuda.synchronize()
        flops = float(counter.get_total_flops()) + kernels.flops
        return flops if flops > 0 else None
    except Exception:
        return None


class StepTimer:
    """Wall-clock per step; call ``tick()`` after each (blocked-on) step."""

    def __init__(self):
        self._times: list[float] = []
        self._last: float | None = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        self._times.append(dt)
        return dt

    @property
    def step_times(self) -> list[float]:
        return self._times

    def summary(
        self,
        batch_size: int | None = None,
        flops_per_example: float | None = None,
        num_chips: int = 1,
        skip_warmup: int = 1,
        flops_per_step: float | None = None,
    ) -> dict[str, float]:
        """``flops_per_step`` (e.g. from :func:`compiled_step_flops`) is the
        exact per-step cost and takes precedence; ``flops_per_example``
        falls back to the 3x-forward heuristic (fwd + bwd). ``mfu`` is the
        achieved rate over :func:`device_peak_flops` times ``num_chips``,
        present where the card's rate is known."""
        times = self._times[skip_warmup:] if len(self._times) > skip_warmup else self._times
        if not times:
            return {}
        mean = statistics.fmean(times)
        out = {
            "steps": float(len(times)),
            "step_time_mean_s": mean,
            "step_time_p50_s": statistics.median(times),
            # Tail percentiles: mean/p50 hide the stragglers; one slow step
            # per N stalls every device of a synchronous mesh.
            "step_time_p90_s": percentile(times, 90),
            "step_time_p99_s": percentile(times, 99),
            "step_time_var_s2": statistics.pvariance(times) if len(times) > 1 else 0.0,
            "step_time_min_s": min(times),
        }
        if batch_size:
            out["samples_per_sec"] = batch_size / mean
            out["samples_per_sec_per_chip"] = batch_size / mean / max(1, num_chips)
        step_flops = None
        if flops_per_step:
            step_flops = float(flops_per_step)
        elif batch_size and flops_per_example:
            # train step ≈ 3x forward FLOPs (fwd + bwd)
            step_flops = 3.0 * flops_per_example * batch_size
        if step_flops:
            achieved = step_flops / mean
            out["train_tflops_per_sec"] = achieved / 1e12
            peak = device_peak_flops()
            if peak:
                out["mfu"] = achieved / (peak * max(1, num_chips))
        return out


class MetricStream:
    """Structured metric records: ``emit(step, {...})`` fans out to sinks.

    ``registry``: optional :class:`~distkeras_tpu_torch.telemetry.registry.
    MetricsRegistry`; every numeric metric emitted also sets a
    ``stream_<key>`` gauge (latest value) and bumps
    ``stream_records_total``, so a scrape of the registry shows the live
    tail of the step series without replaying the JSONL.

    Close when done: ``to_jsonl`` owns an open file handle. Use as a
    context manager, or call :meth:`close` — emitting after close raises.
    """

    def __init__(self, sinks: list[Callable[[dict], None]] | None = None,
                 registry=None):
        self.records: list[dict] = []
        self._sinks = sinks or []
        self._files: list[Any] = []  # handles owned by this stream
        self._closed = False
        self._registry = registry

    @classmethod
    def to_jsonl(cls, path: str, registry=None) -> "MetricStream":
        f = open(path, "a")

        def sink(rec: dict):
            f.write(json.dumps(rec) + "\n")
            f.flush()

        stream = cls([sink], registry=registry)
        stream._files.append(f)
        return stream

    def close(self) -> None:
        """Flush and close owned file handles; idempotent."""
        if self._closed:
            return
        self._closed = True
        for f in self._files:
            try:
                f.close()
            except OSError:
                pass
        self._files.clear()

    def __enter__(self) -> "MetricStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def emit(self, step: int, metrics: dict[str, Any]) -> None:
        if self._closed:
            raise ValueError("emit() on a closed MetricStream")
        rec = {"step": int(step), "ts": time.time(), **_floats(metrics)}
        self.records.append(rec)
        for sink in self._sinks:
            sink(rec)
        if self._registry is not None:
            self._registry.counter(
                "stream_records_total", help="MetricStream records emitted"
            ).inc()
            for k, v in rec.items():
                if k in ("step", "ts") or not isinstance(v, (int, float)):
                    continue
                self._registry.gauge(
                    "stream_" + sanitize_metric_name(k),
                    help="latest stream value").set(v)

    def last(self) -> dict | None:
        return self.records[-1] if self.records else None


def _floats(metrics: dict) -> dict:
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = v
    return out


