"""``run.py`` as the check runs it: no result without a card; on a card, one
short run of each one-card cell prints the contract's last line."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.manifest import ROOT, load

ONE_CHIP = [w["name"] for w in load()["workloads"] if w["chips"] == 1]


def _run(cell: str, seconds: int, trace: int):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 5), "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)


def test_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _run(ONE_CHIP[0], 1, 0)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "needs 1 CUDA card" in proc.stderr


def test_refuses_an_unknown_workload():
    proc = _run("no_such.cell", 1, 0)
    assert proc.returncode != 0 and "{" not in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CHIP)
@pytest.mark.parametrize("trace", [0, 1])
def test_one_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = _run(cell, 3, trace)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "kernels.flash_roofline" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "train_step_ms_p95", "setup_s"}
