"""Step functions: counterpart of ``distkeras_tpu/training/step.py``.

The reference's step is one pure function ``(TrainState, batch) -> (TrainState,
metrics)``, compiled by XLA, that donates its state so the weights are
updated where they lie. Here the step runs eagerly and updates the state in
place: the parameters are leaf tensors with ``requires_grad`` that the
state's ``torch.optim.Optimizer`` owns and changes where they lie, so no
second copy of the weights is made, which is what the reference's donation
buys. The step returns the same state object.

Metrics come back as 0-dim tensors on the weights' device; the step never
waits for the device (no ``.item()``), so the host can queue the next step
while this one runs.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
from torch.utils.checkpoint import checkpoint

from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.ops.losses import OptimizerFactory, get_loss
from distkeras_tpu_torch.ops.metrics import accuracy as accuracy_metric
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = [
    "TrainState",
    "apply_aux_loss",
    "make_cached_window_train_step",
    "make_eval_step",
    "make_train_step",
    "make_window_train_step",
]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def apply_aux_loss(task_loss, new_model_state: dict, weight: float):
    """Fold auxiliary losses the model reports under ``"aux_loss"`` (MoE
    load balancing, ...) into the objective and strip them from the carried
    state."""
    aux = new_model_state.pop("aux_loss", None)
    if aux is not None:
        task_loss = task_loss + weight * sum(torch.sum(leaf) for leaf in _leaves(aux))
    return task_loss, new_model_state


@dataclasses.dataclass
class TrainState:
    """Everything a training step needs.

    ``params``: name -> leaf tensor with ``requires_grad``, the trainable
    weights; ``model_state``: the non-trainable tensors (buffers);
    ``optimizer``: the ``torch.optim.Optimizer`` over ``params`` (its state
    is the reference's ``opt_state``); ``step``: steps taken; ``seed``: the
    run's seed, from which step ``i`` draws its dropout seed
    ``fold_in(seed, i)``."""

    params: dict[str, torch.Tensor]
    model_state: dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int = 0
    seed: int = 0

    @property
    def variables(self) -> dict[str, torch.Tensor]:
        return {**self.params, **self.model_state}

    @classmethod
    def create(cls, model: Model, optimizer: OptimizerFactory, seed: int = 0,
               device: str | torch.device | None = None) -> "TrainState":
        """Fresh weights from ``model.init(seed, device)`` and the optimizer
        ``optimizer(params)`` over them."""
        variables = model.init(seed, device=device)
        trainable = {name for name, _ in model.module.named_parameters()}
        params = {k: v.requires_grad_() for k, v in variables.items() if k in trainable}
        model_state = {k: v for k, v in variables.items() if k not in trainable}
        return cls(params, model_state, optimizer(list(params.values())), 0, int(seed))


def make_train_step(
    model: Model,
    loss: str | Callable,
    metrics: tuple[str, ...] = ("accuracy",),
    remat: bool = False,
    aux_loss_weight: float = 0.01,
    grad_accum_steps: int = 1,
):
    """Build ``step(state, batch) -> (state, metrics_dict)``.

    ``batch`` is ``{"features": [B, ...], "label": [B, ...]}`` on the
    weights' device. The optimizer is the state's: a torch optimizer holds
    its parameters, so unlike the reference this takes none. ``remat=True``
    runs the model under ``torch.utils.checkpoint`` (activations recomputed
    in the backward pass instead of held; the dropout masks are drawn again
    from the same seeds, so they match). ``grad_accum_steps=k`` splits the
    batch into k micro-batches, sums their gradients, divides by k and makes
    ONE optimizer update: a k times larger batch at 1/k of the activation
    memory.
    """
    loss_fn = get_loss(loss)
    accum = max(1, int(grad_accum_steps))

    def apply(variables, features, rng):
        if remat:
            return checkpoint(model.apply, variables, features, True, rng, use_reentrant=False)
        return model.apply(variables, features, True, rng)

    def forward(variables, features, labels, rng):
        outputs, new_model_state = apply(variables, features, rng)
        task_loss, new_model_state = apply_aux_loss(
            loss_fn(outputs, labels), new_model_state, aux_loss_weight)
        return task_loss, outputs.detach(), new_model_state

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        features, labels = batch["features"], batch["label"]
        step_seed = fold_in(state.seed, state.step)
        if accum == 1:
            loss_value, outputs, new_model_state = forward(
                state.variables, features, labels, step_seed)
            loss_value.backward()
            out = {"loss": loss_value.detach()}
            if "accuracy" in metrics:
                out["accuracy"] = accuracy_metric(outputs, labels)
        else:
            B = features.shape[0]
            if B % accum:
                raise ValueError(
                    f"batch size {B} not divisible by grad_accum_steps "
                    f"{accum} (samples would be silently dropped)"
                )
            micro = B // accum
            new_model_state = {}
            loss_sum = acc_sum = 0.0
            for i in range(accum):
                part = slice(i * micro, (i + 1) * micro)
                loss_value, outputs, ms = forward(
                    {**state.variables, **new_model_state}, features[part], labels[part],
                    fold_in(step_seed, i))
                loss_value.backward()  # gradients add up in .grad
                loss_sum = loss_sum + loss_value.detach()
                if "accuracy" in metrics:
                    acc_sum = acc_sum + accuracy_metric(outputs, labels[part])
                new_model_state = ms or new_model_state
            grads = [p.grad for p in state.params.values() if p.grad is not None]
            torch._foreach_div_(grads, accum)
            out = {"loss": loss_sum / accum}
            if "accuracy" in metrics:
                out["accuracy"] = acc_sum / accum
        # optax updates every parameter, an unused one with a zero gradient
        # (weight decay and momentum still move it); torch skips a None grad.
        for p in state.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if new_model_state:
            state.model_state = {k: v.detach() for k, v in new_model_state.items()}
        state.step += 1
        return state, out

    return step


def _stack(per_step: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_window_train_step(model: Model, loss: str | Callable,
                           metrics: tuple[str, ...] = ("accuracy",), **step_kwargs):
    """Build ``window(state, batches) -> (state, metrics)`` where ``batches``
    holds a whole communication window stacked on a leading axis
    (``{"features": [W, B, ...], "label": [W, B, ...]}``): W steps in order,
    metrics stacked ``[W]`` per key. The reference scans the W steps inside
    one compiled program; here they are a loop of eager steps."""
    base = make_train_step(model, loss, metrics, **step_kwargs)

    def window(state: TrainState, batches: dict) -> tuple[TrainState, dict]:
        per_step = []
        for w in range(batches["features"].shape[0]):
            state, m = base(state, {k: v[w] for k, v in batches.items()})
            per_step.append(m)
        return state, _stack(per_step)

    return window


def make_cached_window_train_step(model: Model, loss: str | Callable,
                                  metrics: tuple[str, ...] = ("accuracy",),
                                  **step_kwargs):
    """Window step over a device-resident dataset: ``window(state, xcol,
    ycol, idx)`` where ``xcol``/``ycol`` are the whole partition on the
    device and ``idx`` is ``[W, B]`` integer row indices on the device. Each
    step gathers its minibatch on the device with ``index_select``, so only
    the indices cross from the host."""
    base = make_train_step(model, loss, metrics, **step_kwargs)

    def window(state: TrainState, xcol, ycol, idx) -> tuple[TrainState, dict]:
        per_step = []
        for ix in idx:
            batch = {"features": xcol.index_select(0, ix), "label": ycol.index_select(0, ix)}
            state, m = base(state, batch)
            per_step.append(m)
        return state, _stack(per_step)

    return window


def make_eval_step(model: Model, loss: str | Callable | None = None):
    """Build ``eval_step(variables, batch) -> metrics_dict`` (no grad).

    ``batch`` holds ``features`` and ``label`` tensors on the weights'
    device; the metrics are 0-dim tensors on that device."""
    loss_fn = get_loss(loss) if loss is not None else None

    @torch.inference_mode()
    def eval_step(variables: dict, batch: dict) -> dict:
        outputs, _ = model.apply(variables, batch["features"], train=False)
        out = {"accuracy": accuracy_metric(outputs, batch["label"])}
        if loss_fn is not None:
            out["loss"] = loss_fn(outputs, batch["label"])
        return out

    return eval_step
