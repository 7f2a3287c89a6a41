"""Host tree arithmetic: the building blocks of every PS protocol's update.

Counterpart of ``distkeras_tpu/utils/pytree.py:34-110``. A tree here is the
port's flat ``dict[str, Tensor]`` (a ``state_dict``). Host trees are CPU
tensors, not numpy arrays: bfloat16 wire trees have to live on the host, and
numpy holds bfloat16 only through ``ml_dtypes``, which the port does not use.
Every function keeps the leaves' dtypes (bf16 + f32 widens to f32, as numpy
with ``ml_dtypes`` does) and builds new tensors: nothing is changed in place,
so a tree handed to the parameter server can never alias a worker's weights
that an optimizer is stepping.
"""

from __future__ import annotations

import math

import torch

__all__ = ["to_host", "add", "sub", "scale", "l2", "mean"]

Tree = dict[str, torch.Tensor]


def to_host(tree: Tree) -> Tree:
    """The tree as CPU tensors of the same dtypes: CPU leaves as they are
    (detached), CUDA leaves copied into pinned host memory on the current
    stream, which is then waited for. The one host-materialisation helper:
    the PS loop and the protocols must agree on it bit for bit."""
    out, copied = {}, False
    for k, v in tree.items():
        v = v.detach()
        if v.device.type == "cpu":
            out[k] = v
        else:
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            out[k] = host.copy_(v, non_blocking=True)
            copied = True
    if copied:
        torch.cuda.current_stream().synchronize()
    return out


def add(a: Tree, b: Tree) -> Tree:
    """``a + b`` leaf-wise."""
    return {k: torch.add(a[k], b[k]) for k in a}


def sub(a: Tree, b: Tree) -> Tree:
    """``a - b`` leaf-wise (weight deltas: ``w_after - w_before``)."""
    return {k: torch.sub(a[k], b[k]) for k in a}


def scale(a: Tree, s: float) -> Tree:
    """``s * a`` leaf-wise, in each leaf's dtype."""
    return {k: v * s for k, v in a.items()}


def l2(tree: Tree) -> float:
    """Whole-tree L2 norm ``sqrt(sum_leaves sum(x^2))`` as a host float,
    accumulated in float64 (bf16 wire trees widen exactly). The one norm the
    training-health layer uses for update mass, divergence and goodput."""
    total = 0.0
    for leaf in tree.values():
        if not isinstance(leaf, torch.Tensor):
            continue
        x = leaf.detach().to("cpu", torch.float64).reshape(-1)
        total += float(x @ x)
    return math.sqrt(total)


def mean(trees: list[Tree]) -> Tree:
    """Arithmetic mean of a list of trees (the reference's
    ``AveragingTrainer`` semantics)."""
    if not trees:
        raise ValueError("mean of an empty list of trees")
    acc = trees[0]
    for t in trees[1:]:
        acc = add(acc, t)
    return scale(acc, 1.0 / len(trees))
