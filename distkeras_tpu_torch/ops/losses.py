"""Loss and optimizer registries keyed by the Keras-style names the
trainers accept.

Counterpart of ``distkeras_tpu/ops/losses.py``: the same names. A loss is a
``(logits/preds, targets) -> scalar`` function over a whole batch; an
optimizer is a factory ``params -> torch.optim.Optimizer`` whose updates
follow the optax rule the reference maps the same name to.
"""

from __future__ import annotations

import functools
from collections.abc import Callable, Iterable

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.ops.fused_xent import fused_softmax_xent

__all__ = ["get_loss", "get_optimizer", "optimizer_spec", "LOSSES", "NesterovTrace"]

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def categorical_crossentropy(logits, targets):
    """Softmax CE against one-hot (or soft) targets. Targets with integer
    dtype, or one rank below the logits, are class indices. Computed in
    float32."""
    logits = logits.float()
    if targets.ndim == logits.ndim - 1 or not targets.is_floating_point():
        labels = targets.long().reshape(targets.shape[: logits.ndim - 1])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return -(targets.float() * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def binary_crossentropy(logits, targets):
    targets = targets.reshape(logits.shape).to(logits.dtype)
    return F.binary_cross_entropy_with_logits(logits, targets)


def mean_squared_error(preds, targets):
    return torch.mean((preds - targets.reshape(preds.shape)) ** 2)


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds - targets.reshape(preds.shape)))


def fused_categorical_crossentropy(logits, targets):
    """Fused softmax-CE (integer labels; large-vocab heads). One-hot targets
    fall back to :func:`categorical_crossentropy`, as in the reference."""
    if targets.ndim == logits.ndim:
        return categorical_crossentropy(logits, targets)
    return fused_softmax_xent(logits, targets)


LOSSES: dict[str, LossFn] = {
    "categorical_crossentropy": categorical_crossentropy,
    "fused_categorical_crossentropy": fused_categorical_crossentropy,
    "sparse_categorical_crossentropy": categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
}


def get_loss(loss: str | LossFn) -> LossFn:
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(f"unknown loss {loss!r}; known: {sorted(LOSSES)}") from None


OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad``: the squared-gradient sum starts at
    ``initial_accumulator_value`` (0.1), eps sits inside the root, and the
    update is 0 where the sum is 0. (``torch.optim.Adagrad`` starts the sum
    at 0 and adds eps outside the root.)"""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, {"lr": lr, "initial_accumulator_value":
                                  initial_accumulator_value, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                acc = state["sum"].addcmul_(p.grad, p.grad)
                inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.add_(inv * p.grad, alpha=-group["lr"])


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``: ``nu = decay·nu + (1 − decay)·g²`` from 0 and the
    update ``g / sqrt(nu + eps)``, eps inside the root. (``torch.optim.RMSprop``
    adds eps outside the root.)"""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay = group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"].mul_(decay).addcmul_(p.grad, p.grad, value=1 - decay)
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]), alpha=-group["lr"])


class NesterovTrace(torch.optim.Optimizer):
    """``optax.chain(base, optax.trace(decay, nesterov=True))``: EAMSGD's
    local optimizer. The trace follows the base optimizer's *update*, not
    the gradient: each step runs ``base`` (a factory ``params -> torch
    optimizer``) to get its update ``u``, then ``t = u + decay·t`` and the
    parameter moves by ``u + decay·t`` in its stead. ``u`` is read back as
    the base step's change of the weights, so it carries one rounding of
    the weights' magnitude more than optax's."""

    def __init__(self, params, base: "OptimizerFactory", decay: float = 0.9):
        params = list(params)
        super().__init__(params, {"decay": float(decay)})
        self.base = base(params)

    @torch.no_grad()
    def step(self, closure=None):
        items = [(p, group["decay"]) for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        before = [p.clone() for p, _ in items]
        self.base.step()
        for (p, decay), old in zip(items, before):
            u = p - old
            state = self.state[p]
            if not state:
                state["trace"] = torch.zeros_like(p)
            t = state["trace"].mul_(decay).add_(u)
            p.copy_(old + (u + decay * t))


# name -> (default learning rate, optimizer class, its other arguments)
_OPTIMIZERS = {
    # optax.sgd: p -= lr·g
    "sgd": (0.01, torch.optim.SGD, {}),
    # optax.sgd(momentum=0.9): t = g + 0.9·t, p -= lr·t; torch's buffer with
    # dampening 0 is the same trace
    "momentum": (0.01, torch.optim.SGD, {"momentum": 0.9}),
    # optax.adam: bias-corrected moments, eps 1e-8 outside the root, as torch
    "adam": (0.001, torch.optim.Adam, {"betas": (0.9, 0.999), "eps": 1e-8}),
    # optax.adamw: decoupled weight decay 1e-4 (torch's default is 1e-2)
    "adamw": (0.001, torch.optim.AdamW,
              {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}),
    "adagrad": (0.01, OptaxAdagrad, {}),
    # optax.adadelta: rho 0.9, eps 1e-6 inside both roots, as torch
    "adadelta": (1.0, torch.optim.Adadelta, {"rho": 0.9, "eps": 1e-6}),
    # optax.rmsprop: decay 0.9 (torch's default alpha is 0.99)
    "rmsprop": (0.001, OptaxRMSprop, {}),
}


def get_optimizer(optimizer: str | OptimizerFactory,
                  learning_rate: float | None = None) -> OptimizerFactory:
    """Map the reference's ``worker_optimizer`` strings to a factory
    ``params -> torch.optim.Optimizer`` with the reference's default learning
    rates (adagrad 0.01, adam 0.001, ...) and optax's update rules. Anything
    that is not a string is returned as it is."""
    if not isinstance(optimizer, str):
        return optimizer
    try:
        default_lr, cls, kwargs = _OPTIMIZERS[optimizer.lower()]
    except KeyError:
        raise ValueError(f"unknown optimizer {optimizer!r}") from None
    lr = default_lr if learning_rate is None else learning_rate
    return functools.partial(cls, lr=lr, **kwargs)


def optimizer_spec(factory: OptimizerFactory) -> tuple[type, dict]:
    """The optimizer class and keyword arguments of a factory that
    :func:`get_optimizer` (or a protocol, for ``NesterovTrace``) made, a
    ``functools.partial`` over the class: what
    ``torch.distributed.optim.ZeroRedundancyOptimizer`` builds each rank's
    shard of the optimizer from. Raises ``TypeError`` for any other
    callable, whose class cannot be read."""
    if isinstance(factory, functools.partial) and isinstance(factory.func, type) \
            and issubclass(factory.func, torch.optim.Optimizer) and not factory.args:
        return factory.func, dict(factory.keywords)
    raise TypeError(
        f"zero1 needs an optimizer given by name or as functools.partial(OptimizerClass, "
        f"**kwargs), not {factory!r}")
