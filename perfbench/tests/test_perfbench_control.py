"""The control comes out not correct: the plain reference put in the
program's place and computed in float8, the nearest precision below the
configurations' bfloat16 (``precision="fp8"``).

On the CPU at the tiny presets' size, on three seeds: the control fails at
least one of the cell's limits on every seed, and reads further off than
the bfloat16 program does there. On a card, at the cell's own size, the
same on three seeds, as the limits were set (``perfbench/calibrate.py``)."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare, manifest
from perfbench.calibrate import planted
from perfbench.harness import run_rank
from perfbench.tests.tiny import tiny_spec

ONE_CHIP = [w["name"] for w in manifest.load()["workloads"] if w["chips"] == 1]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


def _fails(values: dict, limits: dict) -> list[str]:
    return [k for k, v in values.items() if limits[k] is not None and v > limits[k]]


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_the_control_fails_at_a_test_size(cell):
    spec = tiny_spec(cell)
    dev = torch.device("cpu")
    for seed in SEEDS:
        reference = planted(spec, seed, dev)
        control, _ = compare.numbers(planted(spec, seed, dev, "fp8"), reference)
        assert _fails(control, spec["limits"]), (seed, control)
        run = run_rank(spec, seed, 0.0, False, device="cpu", window=False)
        program, _ = compare.numbers(run["program"], run["reference"])
        assert any(control[k] > 3 * program[k] for k in _fails(control, spec["limits"])), \
            (seed, control, program)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = manifest.cell(cell)
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        reference = planted(spec, seed, dev)
        control, _ = compare.numbers(planted(spec, seed, dev, "fp8"), reference)
        assert _fails(control, spec["limits"]), (seed, control)
