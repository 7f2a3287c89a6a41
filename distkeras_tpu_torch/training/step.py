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

Data parallelism (``process_group=``): each rank runs the step on its
share of the global batch, then the gradients are averaged over the group
by :func:`all_reduce_mean_`: one ``all_reduce`` of each dtype's ``.grad``
tensors, flattened, then a divide by the group's size (the reference's
XLA inserts the same all-reduce over its ``dp`` axis). There is no
``nn.Module`` for DDP to own, as the step is functional over
``state.params``. Every parameter has a gradient before the reduction (an
unused one a zero), so every rank reduces the same tensors in the same
order; under ``grad_accum_steps > 1`` the reduction waits for the last
micro-step. The metrics are averaged over the group too, so they are the
global batch's, and BatchNorm takes its moments over the group
(:func:`~distkeras_tpu_torch.models.core.cross_replica_batch_stats`).
How a step gathers its weights and reduces its gradients is a
:class:`DataParallel`'s: model parallelism
(:mod:`distkeras_tpu_torch.parallel.gspmd`) brings another, over the same
step body.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
from torch.utils.checkpoint import checkpoint

from distkeras_tpu_torch.models.core import Model, cross_replica_batch_stats
from distkeras_tpu_torch.ops.launches import count
from distkeras_tpu_torch.ops.losses import OptimizerFactory, get_loss
from distkeras_tpu_torch.ops.metrics import accuracy as accuracy_metric
from distkeras_tpu_torch.parallel.island import IslandMember
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = [
    "DataParallel",
    "TrainState",
    "all_reduce_mean_",
    "apply_aux_loss",
    "make_cached_window_train_step",
    "make_eval_step",
    "make_train_step",
    "make_window_train_step",
    "train_step",
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


def all_reduce_mean_(tensors: list[torch.Tensor], group) -> None:
    """Average ``tensors`` over the ranks of ``group``, in place: the
    tensors of each dtype are flattened into one buffer, summed with one
    ``all_reduce`` and divided by the group's size. Every rank must pass
    the same shapes in the same order. ``group`` may be an async island's
    :class:`~distkeras_tpu_torch.parallel.island.IslandMember`, whose
    replicas are threads of this process. Traced as the span
    ``grad_all_reduce``. Counted: each call adds the bytes of the flattened
    buffers it reduces (``numel * itemsize`` summed over ``tensors``) to
    ``all_reduce_mean_.bytes``, and one to ``all_reduce_mean_.calls``."""
    island = isinstance(group, IslandMember)
    world = group.size if island else torch.distributed.get_world_size(group)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    nbytes = 0
    with span("grad_all_reduce"):
        for bucket in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in bucket])
            nbytes += flat.numel() * flat.element_size()
            if island:
                flat = group.sum(flat)
            else:
                torch.distributed.all_reduce(flat, group=group)
            flat.div_(world)
            parts = flat.split([t.numel() for t in bucket])
            torch._foreach_copy_(bucket, [v.view_as(t) for t, v in zip(bucket, parts)])
    count(all_reduce_mean_, bytes=nbytes, calls=1)


all_reduce_mean_.bytes = 0
all_reduce_mean_.calls = 0


class DataParallel:
    """How a step over ``group`` (None: one rank alone) gets its weights and
    reduces its gradients. ``rank`` is the rank's place among the data
    shards (its dropout masks are its own); ``stats_group`` is the group
    BatchNorm takes its moments over."""

    def __init__(self, group=None):
        self.group = self.stats_group = group
        if isinstance(group, IslandMember):
            self.rank = group.rank
        else:
            self.rank = torch.distributed.get_rank(group) if group is not None else 0

    def variables(self, state: "TrainState"):
        """``(variables, params)``: what the forward applies, and the leaves
        among them whose ``.grad`` the backward fills."""
        return state.variables, state.params

    def reduce(self, state: "TrainState", params: dict, out: dict) -> dict:
        """Bring every rank's gradients (``params``' ``.grad``, none None)
        into ``state.params``' ``.grad`` and the metrics ``out`` to the
        global batch's; returns the metrics."""
        if self.group is None:
            return out
        # One reduction: the metrics join the float32 gradients' buffer.
        keys = list(out)
        stacked = torch.stack([out[k].float() for k in keys])
        all_reduce_mean_([p.grad for p in params.values()] + [stacked], self.group)
        return dict(zip(keys, stacked.unbind()))


@dataclasses.dataclass
class TrainState:
    """Everything a training step needs.

    ``params``: name -> leaf tensor with ``requires_grad``, the trainable
    weights; ``model_state``: the non-trainable tensors (buffers);
    ``optimizer``: the ``torch.optim.Optimizer`` over ``params`` (its state
    is the reference's ``opt_state``); ``step``: steps taken; ``seed``: the
    run's seed, from which step ``i`` draws its dropout seed
    ``fold_in(seed, i)``. ``shardings`` (name -> ``NamedSharding``): set
    when the tensors are this rank's shards of the weights
    (:func:`~distkeras_tpu_torch.parallel.gspmd.sharded_train_state`), None
    when they are whole."""

    params: dict[str, torch.Tensor]
    model_state: dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int = 0
    seed: int = 0
    shardings: dict | None = None

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
    process_group=None,
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
    memory. With ``process_group`` (a ``torch.distributed`` group) the step
    is this rank's part of a data-parallel step over the group: ``batch`` is
    this rank's rows, and the gradients, the metrics and BatchNorm's batch
    moments are the whole group's (see the module's docstring).
    """
    return train_step(model, loss, DataParallel(process_group), metrics, remat,
                      aux_loss_weight, grad_accum_steps)


def train_step(model: Model, loss: str | Callable, parallel: DataParallel,
               metrics: tuple[str, ...] = ("accuracy",), remat: bool = False,
               aux_loss_weight: float = 0.01, grad_accum_steps: int = 1):
    """:func:`make_train_step`'s step, its weights and reductions those of
    ``parallel``.

    Traced as spans (:mod:`~distkeras_tpu_torch.telemetry.spans`), in this
    order: ``forward`` (the model with its head), ``loss`` (the loss and the
    auxiliary losses), ``backward`` (the backward pass and the zero-filling
    of missing gradients; under ``remat`` the recomputed forward too),
    ``step_metrics`` (the loss and accuracy metrics), ``grad_all_reduce``
    (data parallel, in :func:`all_reduce_mean_`) and ``optimizer_step``
    (the optimizer's step and ``zero_grad``). Under ``grad_accum_steps > 1``
    each micro-step opens its own ``forward``, ``loss``, ``backward`` and
    ``step_metrics``."""
    loss_fn = get_loss(loss)
    accum = max(1, int(grad_accum_steps))
    # Rank r > 0 draws its dropout masks from its own seeds: the same seed
    # on every rank would repeat rank 0's masks over each share of the batch.
    rank = parallel.rank

    def run(variables, features, rng):
        # Entered inside the checkpointed function, so that a recomputed
        # forward takes its BatchNorm moments over the group as well.
        with cross_replica_batch_stats(parallel.stats_group):
            return model.apply(variables, features, True, rng)

    def apply(variables, features, rng):
        if remat:
            return checkpoint(run, variables, features, rng, use_reentrant=False)
        return run(variables, features, rng)

    def forward(variables, features, labels, rng):
        with span("forward"):
            outputs, new_model_state = apply(variables, features, rng)
        with span("loss"):
            task_loss, new_model_state = apply_aux_loss(
                loss_fn(outputs, labels), new_model_state, aux_loss_weight)
        return task_loss, outputs.detach(), new_model_state

    def backward(loss_value, params: dict, last: bool):
        with span("backward"):
            loss_value.backward()  # under accumulation, gradients add up in .grad
            if not last:
                return
            if accum > 1:
                torch._foreach_div_([p.grad for p in params.values() if p.grad is not None],
                                    accum)
            # optax updates every parameter, an unused one with a zero
            # gradient (weight decay and momentum still move it); torch
            # skips a None grad.
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        features, labels = batch["features"], batch["label"]
        step_seed = fold_in(state.seed, state.step)
        if rank:
            step_seed = fold_in(step_seed, rank)
        variables, params = parallel.variables(state)
        if accum == 1:
            loss_value, outputs, new_model_state = forward(
                variables, features, labels, step_seed)
            backward(loss_value, params, True)
            with span("step_metrics"):
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
                    {**variables, **new_model_state}, features[part], labels[part],
                    fold_in(step_seed, i))
                backward(loss_value, params, i == accum - 1)
                with span("step_metrics"):
                    loss_sum = loss_sum + loss_value.detach()
                    if "accuracy" in metrics:
                        acc_sum = acc_sum + accuracy_metric(outputs, labels[part])
                new_model_state = ms or new_model_state
            out = {"loss": loss_sum / accum}
            if "accuracy" in metrics:
                out["accuracy"] = acc_sum / accum
        out = parallel.reduce(state, params, out)
        with span("optimizer_step"):
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
