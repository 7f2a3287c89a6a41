"""A run whose timed path is broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the CPU
at the tiny presets' size (:mod:`perfbench.tests.tiny`), the step built
broken, then judges it by the cell's own limits: a step that returns its
state unchanged; half of the batch left out and the mean taken over the
rest; on two data-parallel ranks, the exchange between them left out. A
sound run on two ranks in float32 matches the reference over the global
batch on every rank."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import compare
from perfbench.harness import make_step, run_rank
from perfbench.ranks import spawn
from perfbench.tests.tiny import tiny_spec


def unchanged_step(model, cfg, group):
    """A step that computes the loss and leaves the state as it was."""
    from distkeras_tpu_torch.ops.losses import get_loss

    loss_fn = get_loss(cfg["port"]["loss"])

    def step(state, batch):
        with torch.no_grad():
            out, _ = model.apply(state.variables, batch["features"], train=False)
            return state, {"loss": loss_fn(out, batch["label"])}

    return step


def half_batch_step(model, cfg, group):
    """The step on the first half of the batch's rows alone."""
    step = make_step(model, cfg, group)

    def half(state, batch):
        n = batch["features"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})

    return half


def no_exchange_step(model, cfg, group):
    """Each rank's step on its own rows, its gradients never exchanged."""
    return make_step(model, cfg, None)


def _judge(spec, reports):
    ref = next(r["reference"] for r in reports if "reference" in r)
    return compare.judge([r["program"] for r in reports], ref, spec["limits"])


@pytest.mark.parametrize("fault", [unchanged_step, half_batch_step],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["bert_base.train_s128_b256", "gpt2_small.train_s1024_b32"])
def test_a_broken_step_is_not_correct(cell, fault):
    spec = tiny_spec(cell)
    report = run_rank(spec, 2**31 + 9, 0.3, False, device="cpu", step_factory=fault)
    correct, checks, _ = _judge(spec, [report])
    assert not correct, checks
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]


def test_two_ranks_match_the_reference_and_fail_without_the_exchange():
    cell = "bert_base.dp4_train_s128_b256"
    sound = tiny_spec(cell, ranks=2, dtype="float32")
    reports = spawn(sound, [2**31 + 21], 0.3, False, 2, time.time(), 600, device="cpu",
                    backend="gloo")[0]
    for r in reports:
        ref = next(x["reference"] for x in reports if "reference" in x)
        values, where = compare.numbers(r["program"], ref)
        assert values["loss_gap"] < 1e-6 and values["grad_gap"] < 1e-4, (r["rank"], where)
    spec = tiny_spec(cell, ranks=2)
    reports = spawn(spec, [2**31 + 22], 0.3, False, 2, time.time(), 600, device="cpu",
                    backend="gloo", step_factory=no_exchange_step)[0]
    correct, checks, _ = _judge(spec, reports)
    assert not correct, checks
