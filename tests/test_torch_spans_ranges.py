"""The port's spans on ``torch.profiler``'s timeline, and the all-reduce's
byte counter.

While the profiler records, a span opens a ``record_function`` range named
``RANGE_PREFIX`` + its name: the training step's phases and the feed's
copies show there in order. With no tracer and no profiler a span is the
shared no-op object and enters no range.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distkeras_tpu_torch.data.feed import DeviceFeed
from distkeras_tpu_torch.models.bert import bert_tiny_mlm
from distkeras_tpu_torch.ops import launches
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.parallel.island import IslandGroup
from distkeras_tpu_torch.telemetry import spans
from distkeras_tpu_torch.training.step import TrainState, all_reduce_mean_, make_train_step

SEQ, ROWS = 16, 4
PHASES = ["forward", "loss", "backward", "step_metrics"]


def _step_and_batch(accum: int = 1):
    model = bert_tiny_mlm(seq_len=SEQ)
    state = TrainState.create(model, get_optimizer("adamw", 1e-3), seed=0, device="cpu")
    step = make_train_step(model, "fused_categorical_crossentropy", grad_accum_steps=accum)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(8, 1024, (ROWS, SEQ))) for k in ("features", "label")}
    return step, state, batch


def _program_ranges(prof) -> list:
    """The profile's program ranges ``[(name, start, end)]`` by start."""
    out = [(e.name[len(spans.RANGE_PREFIX):], e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(spans.RANGE_PREFIX)]
    return sorted(out, key=lambda r: r[1])


@pytest.mark.parametrize("accum", [1, 2])
def test_a_profiled_step_shows_its_phases_in_order(accum):
    step, state, batch = _step_and_batch(accum)
    step(state, batch)  # first call outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    ranges = _program_ranges(prof)
    assert [name for name, _, _ in ranges] == PHASES * accum + ["optimizer_step"]
    for (_, _, end), (_, start, _) in zip(ranges, ranges[1:]):
        assert end <= start


def test_a_profiled_feed_shows_its_puts_and_takes():
    batches = [{"features": np.full((2, 3), i), "label": np.full((2,), i)} for i in range(3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(DeviceFeed(iter(batches), "cpu", buffer_size=2))
    assert [int(b["label"][0]) for b in got] == [0, 1, 2]
    names = [name for name, _, _ in _program_ranges(prof)]
    assert names == ["feed_put", "feed_put", "feed_take", "feed_put", "feed_take", "feed_take"]


def test_off_a_span_is_the_null_span_and_enters_no_range(monkeypatch):
    original = torch.autograd.profiler.record_function

    def refuse(name, *args, **kwargs):
        # torch.optim enters its own range unconditionally; a span must not.
        if name.startswith(spans.RANGE_PREFIX):
            raise AssertionError(f"a span entered {name!r} with the profiler off")
        return original(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert spans.active_tracer() is None
    assert spans.span("forward") is spans._NULL_SPAN
    step, state, batch = _step_and_batch()
    step(state, batch)
    assert state.step == 1


def test_a_span_lands_in_the_tracer_and_the_profile():
    tracer = spans.enable_tracing(spans.Tracer())
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("outer", k=1):
                with spans.span("inner"):
                    pass
    finally:
        spans.disable_tracing()
    recorded = [(ph, name) for ph, name, *_ in tracer.events()]
    assert recorded == [("B", "outer"), ("B", "inner"), ("E", "inner"), ("E", "outer")]
    (outer, o0, o1), (inner, i0, i1) = _program_ranges(prof)
    assert (outer, inner) == ("outer", "inner") and o0 <= i0 <= i1 <= o1
    # With the profiler stopped the tracer alone records.
    spans.enable_tracing(tracer)
    try:
        assert spans.span("after") is not spans._NULL_SPAN
    finally:
        spans.disable_tracing()


def test_the_all_reduce_counts_its_bytes_and_calls(monkeypatch):
    monkeypatch.setattr(all_reduce_mean_, "bytes", 0)
    monkeypatch.setattr(all_reduce_mean_, "calls", 0)
    group = IslandGroup(2)
    tensors = [[torch.ones(3, 5), torch.ones(7, dtype=torch.float64), torch.ones(2, 2)]
               for _ in range(2)]
    errors = []

    def replica(rank):
        try:
            for _ in range(2):
                all_reduce_mean_(tensors[rank], group.member(rank))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            group.abort()

    threads = [threading.Thread(target=replica, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    per_call = 15 * 4 + 7 * 8 + 4 * 4
    assert all_reduce_mean_.calls == 2 * 2  # two replicas, two calls each
    assert all_reduce_mean_.bytes == 2 * 2 * per_call
    assert all(torch.equal(t, torch.ones_like(t)) for ts in tensors for t in ts)


def test_count_launch_still_counts_launches_and_flops():
    def kernel():
        pass

    kernel.launches = 0
    with launches.kernel_flops() as tally:
        launches.count_launch(kernel, 10.0)
        launches.count_launch(kernel)
    assert kernel.launches == 2 and tally.flops == 10.0
    launches.count(kernel, launches=3)
    assert kernel.launches == 5
