"""The fleet telemetry plane and the SLO engine on the port, and the port's
device accounting.

``telemetry/registry.py`` (mergeable histograms, ``hist_state_delta``),
``telemetry/timeseries.py`` (``DeltaEncoder``, ``TimeSeriesStore``,
``FleetAggregator``) and ``serving/slo.py`` are host code copied from the
reference. Every case of the reference's own ``tests/test_timeseries_slo.py``
runs here once against each package: the file is read and executed with its
imports pointed at the package under test, and each of its ``test_*``
functions is a parametrised case.

``telemetry/device.py`` reads the CUDA allocator where the reference reads
``jax.Device.memory_stats()``: on the CPU it returns the typed "no data"
sentinel (``available=False``, every byte field None, never 0), publishes
``device_memory_stats_available`` 0 and no byte gauge.
"""

import os
import types

import pytest
import torch

from distkeras_tpu_torch.telemetry import device as port_device
from distkeras_tpu_torch.telemetry import registry as port_registry
from distkeras_tpu_torch.telemetry.registry import MetricsRegistry

REF_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_timeseries_slo.py")


def _load(pkg: str) -> types.ModuleType:
    src = open(REF_TESTS, encoding="utf-8").read()
    if pkg == "port":
        src = src.replace("from distkeras_tpu.telemetry import MetricsRegistry",
                          "from distkeras_tpu_torch.telemetry.registry import MetricsRegistry")
        src = src.replace("from distkeras_tpu.", "from distkeras_tpu_torch.")
        assert "distkeras_tpu." not in src.replace("distkeras_tpu_torch.", "")
    mod = types.ModuleType(f"_timeseries_slo_cases_{pkg}")
    mod.__file__ = REF_TESTS
    exec(compile(src, REF_TESTS, "exec"), mod.__dict__)
    return mod


MODS = {pkg: _load(pkg) for pkg in ("reference", "port")}
CASES = sorted(name for name in vars(MODS["reference"]) if name.startswith("test_"))


def test_port_cases_run_the_port_modules():
    port = MODS["port"]
    assert port.MetricsRegistry is MetricsRegistry
    assert port.SLOEngine.__module__ == "distkeras_tpu_torch.serving.slo"
    assert port.DeltaEncoder.__module__ == "distkeras_tpu_torch.telemetry.timeseries"
    assert len(CASES) >= 20


@pytest.mark.parametrize("pkg", ["reference", "port"])
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, pkg):
    getattr(MODS[pkg], case)()


def test_hist_state_delta_matches_reference():
    from distkeras_tpu.telemetry.registry import MetricsRegistry as RefRegistry
    from distkeras_tpu.telemetry.registry import hist_state_delta as ref_delta

    states = []
    for reg in (RefRegistry(), MetricsRegistry()):
        h = reg.histogram("m", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05):
            h.observe(v, exemplar="a")
        prev = h.state()
        for v in (0.5, 0.05, 2.0):
            h.observe(v, exemplar="b")
        states.append((prev, h.state()))
    (rp, rc), (pp, pc) = states
    assert port_registry.hist_state_delta(pc, pp) == ref_delta(rc, rp)
    assert port_registry.hist_state_delta(pc, None) == ref_delta(rc, None)
    # A reset source (counts went down) ships its full state.
    assert port_registry.hist_state_delta(pp, pc) == pp


def test_device_memory_sentinel_on_cpu():
    mem = port_device.device_memory("cpu")
    assert mem.available is False
    assert (mem.bytes_in_use, mem.bytes_limit, mem.peak_bytes_in_use) == (None, None, None)
    assert mem.headroom_bytes is None
    assert mem.to_dict() == {"device": "cpu:0", "available": False, "bytes_in_use": None,
                             "bytes_limit": None, "peak_bytes_in_use": None}
    assert port_device.device_memory("not a device").available is False
    reg = MetricsRegistry()
    mems = port_device.publish_memory_gauges(reg, devices=["cpu"], params_bytes=123,
                                             kv_pool_bytes=456)
    snap = reg.snapshot()
    assert [m.device for m in mems] == ["cpu:0"]
    assert not any(k.startswith("device_bytes") or k.startswith("device_peak")
                   or k.startswith("device_memory_headroom") for k in snap)
    assert snap["model_params_bytes"]["value"] == 123
    assert snap["kv_pool_reserved_bytes"]["value"] == 456
    gauge = reg.gauge("device_memory_stats_available", device="cpu:0")
    assert gauge.value == 0.0
    if not torch.cuda.is_available():
        assert [m.device for m in port_device.all_device_memory()] == ["cpu:0"]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """``run.py --profile-out``'s capture: a ``torch.profiler`` trace of the
    block lands in the directory as Chrome-trace JSON."""
    import json

    with port_device.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace.get("traceEvents")
