"""The plain reference against the port's CPU path at the tiny presets'
sizes (``bert_tiny_mlm``, ``gpt_tiny``), in float32, where the two compute
the same mathematics and differ by rounding alone."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare
from perfbench.harness import build_model, run_rank
from perfbench.reference import bert_family
from perfbench.tests.tiny import tiny_spec
from perfbench.weights import make_weights

CELLS = ["bert_base.train_s128_b256", "gpt2_small.train_s1024_b32"]


@pytest.mark.parametrize("cell", CELLS)
def test_forward_matches_the_port(cell):
    spec = tiny_spec(cell, dtype="float32")
    cfg, traffic = spec["config"], spec["traffic"]
    model = build_model(cfg, traffic)
    weights = make_weights(cfg, 5, "cpu")
    ids = torch.randint(0, cfg["vocab_size"], (3, traffic["seq"]),
                        generator=torch.Generator().manual_seed(1))
    got, _ = model.apply(weights, ids, train=False)
    want = bert_family.make(cfg).forward(weights, ids, None)
    assert (got - want).abs().max().item() < 1e-4


@pytest.mark.parametrize("cell", CELLS)
def test_dropout_masks_match_the_port(cell):
    """A training forward of the port (dropout on) against the reference
    with the masks it draws by the model file's seed rule."""
    spec = tiny_spec(cell, dtype="float32")
    cfg, traffic = spec["config"], spec["traffic"]
    model = build_model(cfg, traffic)
    weights = make_weights(cfg, 6, "cpu")
    ids = torch.randint(0, cfg["vocab_size"], (4, traffic["seq"]),
                        generator=torch.Generator().manual_seed(2))
    rng = bert_family.forward_seed(123, 2, 1)
    got, _ = model.apply(weights, ids, train=True, rng=rng)
    masks = bert_family.dropout_masks(cfg, 4, traffic["seq"], rng, "cpu")
    want = bert_family.make(cfg).forward(weights, ids, masks)
    assert (got - want).abs().max().item() < 1e-4
    other = bert_family.dropout_masks(cfg, 4, traffic["seq"], rng + 1, "cpu")
    assert (got - bert_family.make(cfg).forward(weights, ids, other)).abs().max().item() > 1e-2


@pytest.mark.parametrize("cell", CELLS)
def test_three_training_steps_match_the_port(cell):
    """The harness's checked steps of the port in float32 (dropout, fused
    loss, AdamW) against the reference's: every number far inside the
    cell's limits."""
    spec = tiny_spec(cell, dtype="float32")
    report = run_rank(spec, 2**31 + 77, 0.0, False, device="cpu", window=False)
    values, where = compare.numbers(report["program"], report["reference"])
    assert values["loss_gap"] < 1e-6, where
    assert values["grad_gap"] < 1e-4, where
    assert values["change_gap"] < 1e-3, where


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in Path(bert_family.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in ("torch", "math", "__future__"), (path, name)
