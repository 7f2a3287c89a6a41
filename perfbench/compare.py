"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, from the same weights and rows.

Three numbers, each held to a limit of its cell
(``perfbench/limits/<cell>.json``):

- ``loss_gap``: the largest gap of a step's loss, relative to the
  reference's loss, over the checked steps;
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  first step's gradient as the program's optimizer got it and the
  reference's, relative to the larger of the reference's norm of that leaf
  and of the median leaf;
- ``change_gap``: the same of each leaf's change from the initial weights
  after the checked steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a key's bias under softmax, positions the rows never reach) move under
Adam by round-off alone; they are left out of both leaf numbers. A data-
parallel cell's numbers are the worst over its ranks.
"""

from __future__ import annotations

import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
# A leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the leaf numbers.
NEGLIGIBLE_GRAD = 1e-3


def _leaf_gap(got: dict, want: dict, kept: list) -> tuple[float, str]:
    floor = statistics.median(want.values())
    worst, leaf = 0.0, ""
    for k in kept:
        gap = abs(got[k] - want[k]) / max(want[k], floor)
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def numbers(program: dict, reference: dict) -> tuple[dict, dict]:
    """``({name: value}, {name: the worst step or leaf})`` of one rank's
    ``program`` readings (``losses``, ``grad_norms``, ``change_norms``)
    against the ``reference``'s."""
    losses = [abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"],
                                                   strict=True)]
    ref_grad = reference["grad_norms"]
    median = statistics.median(ref_grad.values())
    kept = [k for k, v in ref_grad.items() if v >= NEGLIGIBLE_GRAD * median]
    grad, grad_leaf = _leaf_gap(program["grad_norms"], ref_grad, kept)
    change, change_leaf = _leaf_gap(program["change_norms"], reference["change_norms"], kept)
    values = {"loss_gap": max(losses), "grad_gap": grad, "change_gap": change}
    where = {"loss_gap": f"step {losses.index(max(losses)) + 1}", "grad_gap": grad_leaf,
             "change_gap": change_leaf}
    return values, where


def judge(ranks: list[dict], reference: dict, limits: dict) -> tuple[bool, dict, dict]:
    """``(correct, {name: {"value", "limit"}}, {name: where})`` over every
    rank's readings."""
    worst: dict = {}
    where: dict = {}
    for r, program in enumerate(ranks):
        values, at = numbers(program, reference)
        for name, v in values.items():
            if name not in worst or v > worst[name]:
                worst[name] = v
                where[name] = f"rank {r}, {at[name]}" if len(ranks) > 1 else at[name]
    # A number whose limit is null has no reading that separates sound runs
    # from faulty ones at this cell; it is printed and not compared.
    checks = {name: {"value": worst[name], "limit": limits[name]} for name in NUMBERS}
    correct = all(c["limit"] is None or c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, where
