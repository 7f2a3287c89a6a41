"""The readers of the port's own ranges and counter (``perfbench/program.py``
and the metrics that use it): they leave what the accepted readers read as
it was, put a kernel down to the range the host was in, on any thread, and
read nothing where the program has no range and no counter."""

from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distkeras_tpu_torch.telemetry.spans import RANGE_PREFIX
from distkeras_tpu_torch.training import step as step_module
from perfbench import program, trace
from perfbench.harness import make_state, make_step
from perfbench.manifest import cell, reader
from perfbench.tests.tiny import tiny_spec
from perfbench.weights import make_weights

NEW = ["step.forward_ms", "step.loss_ms", "step.backward_ms", "optimizer.host_ms",
       "feed.put_ms", "dp.allreduce_mb", "feed.take_ms"]
RANGE_READERS = [n for n in NEW if n != "dp.allreduce_mb"]
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(name, start, end, device=CPU, id=0, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, time_range=types.SimpleNamespace(start=start, end=end),
        id=id, is_async=False, is_user_annotation=annotation, kernels=[], cpu_parent=None)


class _Events:
    """A profile's stand-in: ``events()`` as given."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _profiled_steps(steps: int = 2):
    """A profile of ``steps`` tiny bert steps on the CPU, program ranges
    on."""
    from distkeras_tpu_torch.data.feed import DeviceFeed
    from perfbench import traffic as traffic_gen
    from perfbench.harness import Source, build_model

    spec = tiny_spec()
    cfg, traffic = spec["config"], spec["traffic"]
    model = build_model(cfg, traffic)
    state = make_state(model, make_weights(cfg, 5, torch.device("cpu")), traffic, 5)
    step = make_step(model, cfg, None)
    pool = traffic_gen.make_pool(traffic, cfg, 5)
    feed = iter(DeviceFeed(Source(pool, traffic, 0, 5), "cpu"))
    state, _ = step(state, next(feed))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            state, _ = step(state, next(feed))
    return prof


def _t(prof, steps: int = 2) -> dict:
    return {**trace.reduce_profile(prof), "stretch_steps": steps, "window_steps": steps,
            "feed_s": [], "dispatch_s": []}


def _read(name: str, prof, t: dict):
    """The reader of ``name`` called as the harness calls it, with the
    profile in a frame up the stack."""
    assert prof is not None
    return reader(name)(t)


def test_the_prefix_is_the_programs():
    assert program.PREFIX == RANGE_PREFIX


def test_reduce_profile_reads_the_same_with_and_without_program_ranges():
    prof = _profiled_steps()
    assert any(e.name.startswith(RANGE_PREFIX) for e in prof.events())
    without = _Events([e for e in prof.events() if not e.name.startswith(RANGE_PREFIX)])
    assert trace.reduce_profile(prof) == trace.reduce_profile(without)


def test_reduce_profile_reads_the_same_with_program_annotations_on_the_device():
    kernels = [_event("gemm_kernel", 10, 20, CUDA, 11), _event("Memcpy HtoD", 25, 26, CUDA, 12)]
    host = [_event("aten::mm", 5, 8), _event("cudaLaunchKernel", 6, 7, id=11),
            _event("aten::copy_", 21, 22), _event("cudaMemcpyAsync", 21, 22, id=12)]
    ranges = [_event(RANGE_PREFIX + "forward", 0, 30),
              _event(RANGE_PREFIX + "forward", 9, 27, CUDA, 13, annotation=True)]
    with_ranges = trace.reduce_profile(_Events(host + kernels + ranges))
    assert with_ranges == trace.reduce_profile(_Events(host + kernels))
    assert [d[0] for d in with_ranges["device"]] == ["gemm_kernel", "Memcpy HtoD"]
    r = program.reduce_events(host + kernels + ranges)
    assert r["device_us"] == {RANGE_PREFIX + "forward": 11.0} and r["unattributed_us"] == 0


def test_a_kernel_launched_from_another_thread_belongs_to_the_range_the_host_was_in():
    events = [
        _event(RANGE_PREFIX + "forward", 0, 100),
        _event("cudaLaunchKernel", 12, 13, id=1),
        _event(RANGE_PREFIX + "backward", 100, 300),
        # The autograd engine's thread, inside the main thread's backward.
        _event("cuLaunchKernel", 152, 153, id=2),
        _event(RANGE_PREFIX + "grad_all_reduce", 200, 250),  # nested in backward
        _event("cudaLaunchKernelExC", 212, 213, id=3),
        _event("cudaLaunchKernel", 402, 403, id=4),  # inside no range
        _event("kernel_a", 30, 40, CUDA, 1),
        _event("kernel_b", 170, 190, CUDA, 2),
        _event("ncclKernel_AllReduce", 260, 290, CUDA, 3),
        _event("kernel_c", 420, 425, CUDA, 4),
        _event("kernel_d", 430, 431, CUDA, 5),  # its launch is not in the profile
        _event(RANGE_PREFIX + "backward", 160, 300, CUDA, 6, annotation=True),
    ]
    r = program.reduce_events(events)
    assert r["device_us"] == {RANGE_PREFIX + "forward": 10.0, RANGE_PREFIX + "backward": 20.0,
                              RANGE_PREFIX + "grad_all_reduce": 30.0}
    assert r["ops_us"][RANGE_PREFIX + "grad_all_reduce"] == {"ncclKernel_AllReduce": 30.0}
    assert r["unattributed_us"] == 6.0 and r["device_total_us"] == 66.0
    assert r["host_us"][RANGE_PREFIX + "backward"] == [200.0]
    t = {"program": r, "stretch_steps": 2}
    assert program.device_ms_per_step(t, "backward") == 20.0 / 2 / 1e3
    assert program.device_ms_per_step(t, "forward", "loss") == 10.0 / 2 / 1e3
    assert program.device_ms_per_step(t, "loss") is None


def test_the_new_readers_read_the_programs_ranges_and_counter(monkeypatch):
    prof = _profiled_steps()
    t = _t(prof)
    assert _read("optimizer.host_ms", prof, t) > 0
    assert _read("feed.put_ms", prof, t) > 0
    assert _read("feed.take_ms", prof, t) > 0
    # No device activity on the CPU: nothing for the device readers.
    for name in ("step.forward_ms", "step.loss_ms", "step.backward_ms"):
        assert _read(name, prof, t) is None
    # The buffer of one call, however many calls the process made.
    monkeypatch.setattr(step_module.all_reduce_mean_, "bytes", 4_000_000 * 7)
    monkeypatch.setattr(step_module.all_reduce_mean_, "calls", 7)
    assert _read("dp.allreduce_mb", prof, t) == pytest.approx(4.0)


def test_the_counter_reads_nothing_before_an_all_reduce(monkeypatch):
    monkeypatch.setattr(step_module.all_reduce_mean_, "bytes", 0)
    monkeypatch.setattr(step_module.all_reduce_mean_, "calls", 0)
    assert reader("dp.allreduce_mb")({}) is None


@pytest.mark.parametrize("name", RANGE_READERS)
def test_a_range_reader_fails_loudly_without_a_profile_on_the_stack(name):
    with pytest.raises(LookupError, match="profile"):
        reader(name)({"stretch_steps": 2})


def test_the_new_readers_read_nothing_without_ranges_or_counter(monkeypatch):
    monkeypatch.delattr(step_module.all_reduce_mean_, "bytes")
    monkeypatch.delattr(step_module.all_reduce_mean_, "calls")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    t = _t(prof)
    for name in NEW:
        assert _read(name, prof, t) is None, name


@pytest.mark.parametrize("workload", ["bert_base.train_s128_b256", "gpt2_small.train_s1024_b32",
                                      "bert_base.dp4_train_s128_b256"])
def test_every_cell_reports_the_new_metrics_it_lists(workload):
    names = [m["name"] for m in cell(workload)["per_layer"]]
    dp = workload.startswith("bert_base.dp4")
    want = [n for n in NEW if dp or n != "dp.allreduce_mb"]
    assert [n for n in names if n in NEW] == want


def test_phases_splits_a_stretch_by_program_range():
    from perfbench import phases

    prof = _profiled_steps()
    out = phases.stretch_phases(prof, 2)
    assert set(out["host_ms"]) == {RANGE_PREFIX + n for n in (
        "forward", "loss", "backward", "step_metrics", "optimizer_step", "feed_put",
        "feed_take")}
    assert out["device_total_ms"] == 0 and out["idle_gaps"] == []


def test_phases_reads_nothing_without_program_ranges():
    from perfbench import phases

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert phases.stretch_phases(prof, 2) == {}
