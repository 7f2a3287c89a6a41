"""Model-parallel training: counterpart of ``distkeras_tpu/parallel/gspmd.py``.

The reference lays each weight out by its logical axes and lets XLA insert
every collective. Here each rank holds its own part of each weight as a
plain tensor (the part :meth:`NamedSharding.index` names), and the
collectives are explicit:

- ``tp``: the bert family computes on its local shards
  (:func:`distkeras_tpu_torch.models.bert.with_tp_mesh`, Megatron's
  layout: the activation sums and the logits' gather are in the model);
- ``fsdp``: a leaf split over ``fsdp`` is gathered whole once a step before
  the forward, and its whole gradient is reduce-scattered back to this
  rank's part (a sum over the ranks' rows, then the mean);
- ``sp``: a model with ``BertConfig.ring_mesh``
  (:func:`distkeras_tpu_torch.models.bert.with_ring_mesh`) takes this rank's
  columns of the batch (:func:`batch_sharding` with ``seq_dim``) and runs
  its attention across the sp ranks; under ``shard_sequence`` a model
  without one takes its columns as well and gathers the columns its
  attention needs over sp (:func:`distkeras_tpu_torch.models.bert.with_seq_mesh`,
  the reference's XLA sequence split); a leaf split over ``sp``
  (``pos_embed``'s sequence dimension, by the ``("seq", "sp")`` rule) is
  gathered whole once a step, as an fsdp leaf is, since a rank's tokens
  need rows outside its part (all of them striped, or past the trained
  length), and its gradient is reduce-scattered back;
- ``ep``: an MoE model (``BertConfig.moe_experts``) computes on its ep
  shard of the experts (:func:`distkeras_tpu_torch.models.bert.with_ep_mesh`,
  the sums over ep in the layer: :mod:`distkeras_tpu_torch.ops.moe`); the
  expert leaves stay split, as tp leaves do, and the ep ranks take the
  same rows, so no gradient is averaged over ep. On a mesh with ``tp`` as
  well an expert leaf is split along two dimensions over two axes
  (``w_in`` ``[E/ep, D, M/tp]``): :func:`gather_whole`, the checkpoints and
  the publisher gather it over the joint ``(ep, tp)`` group, which
  :func:`sharded_train_state` builds on every rank. The routing takes the
  whole batch: its data group is :class:`Sharded`'s ``stats_group`` (dp and
  fsdp, BatchNorm's too), its sequence split the model's ``ring_mesh`` or
  ``seq_mesh``;
- the reduction axes (``dp``, ``fsdp`` and ``sp``): the other gradients
  and the metrics are averaged over the ranks that hold other rows or
  other columns. Every sp rank holds ``B·S/p`` tokens, so the mean of the
  ranks' mean losses is the global batch's mean, and the mean of their
  gradients is its gradient: a rank's gradient already holds what the
  other ranks' losses send back through its K and V (the ring's,
  Ulysses' and the gather's backward), so the sum over the ranks of their gradients is the
  gradient of the sum of their losses.

The step body is :func:`~distkeras_tpu_torch.training.step.make_train_step`'s
(:class:`Sharded` is its gather and reduction). The weights are drawn whole
from the seed and then placed, so a sharded init is the unsharded one.
An annotated model's leaves follow its logical axes
(:func:`~distkeras_tpu_torch.parallel.sharding.infer_variable_shardings`);
on an ``fsdp`` mesh every trainable leaf those leave whole (every one of an
un-annotated model's) takes :func:`fsdp_sharding_for`. The reference's
rules name no ``fsdp`` axis, so there an annotated model's weights stay
replicated on an ``fsdp`` mesh; the numbers are the same either way.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable

import numpy as np
import torch

from distkeras_tpu_torch.models.bert import (
    with_ep_mesh,
    with_ring_mesh,
    with_seq_mesh,
    with_tp_mesh,
)
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.ops.ring_flash import stripe_shard, stripe_unshard
from distkeras_tpu_torch.parallel.distributed import axis_ring, process_index, sp_all_gather
from distkeras_tpu_torch.parallel.mesh import Mesh, NamedSharding, _spec_axes, shard_batch_spec
from distkeras_tpu_torch.parallel.sharding import infer_variable_shardings, replicated
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.training.step import (
    DataParallel,
    TrainState,
    all_reduce_mean_,
    train_step,
)
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = [
    "Sharded",
    "batch_part",
    "batch_sharding",
    "fsdp_sharding_for",
    "gather_sequence",
    "gather_whole",
    "local_state_tree",
    "make_sharded_train_step",
    "place_sharded",
    "shard_batch",
    "sharded_train_state",
    "whole_state_tree",
    "zero1_optimizer",
]


def place_sharded(tree: dict, shardings, device: str | torch.device | None = None) -> dict:
    """This rank's part of every leaf of ``tree`` (name -> tensor or array),
    on ``device`` (CUDA unless ``"cpu"`` is asked for): ``shardings`` is a
    name -> :class:`NamedSharding` dict, one sharding for every leaf, or
    None to keep every leaf whole. No rank keeps more than its part."""
    dev = resolve_device(device)
    rank = process_index()
    out = {}
    for name, leaf in tree.items():
        t = torch.as_tensor(np.asarray(leaf) if not isinstance(leaf, torch.Tensor) else leaf)
        sharding = shardings.get(name) if isinstance(shardings, dict) else shardings
        if sharding is not None:
            t = t[sharding.index(t.shape, rank)]
        out[name] = t.to(dev).clone(memory_format=torch.contiguous_format)
    return out


def batch_sharding(mesh: Mesh, batch_rank: int = 2, seq_dim: int | None = 1) -> NamedSharding:
    """The sharding of a ``[B, ...]`` batch: ``B`` over the data axes (dp
    and, when present, fsdp), and ``seq_dim`` over ``sp`` when the mesh has
    that axis and the batch that dimension."""
    spec: list = [None] * batch_rank
    batch_spec = shard_batch_spec(mesh)
    if batch_spec:
        spec[0] = batch_spec[0]
    if seq_dim is not None and "sp" in mesh.axis_names and seq_dim < batch_rank:
        spec[seq_dim] = "sp"
    return NamedSharding(mesh, tuple(spec))


def batch_part(mesh: Mesh, x, rank: int, seq_dim: int | None = None, stripe: bool = False):
    """``rank``'s part of a global batch array ``x`` (numpy or torch): its
    rows over the data axes and, with ``seq_dim``, its columns over ``sp``.
    ``stripe``: the columns of the striped token layout
    (:func:`~distkeras_tpu_torch.ops.ring_flash.stripe_shard` before the
    contiguous split), as ``sp_impl="ring_stripe"`` takes them."""
    if stripe and seq_dim is not None and x.ndim > seq_dim:
        x = stripe_shard(x, mesh.shape.get("sp", 1), seq_dim)
    return x[batch_sharding(mesh, max(1, x.ndim), seq_dim).index(x.shape, rank)]


def shard_batch(mesh: Mesh, batch: dict, seq_dim: int | None = None,
                device: str | torch.device | None = None, stripe: bool = False) -> dict:
    """This rank's part (:func:`batch_part`) of every array of ``batch``, on
    ``device``."""
    rank = process_index()
    return {k: place_sharded({k: batch_part(mesh, np.asarray(v), rank, seq_dim, stripe)},
                             None, device)[k]
            for k, v in batch.items()}


def gather_sequence(x: torch.Tensor, mesh: Mesh, seq_dim: int = 1,
                    stripe: bool = False) -> torch.Tensor:
    """The inverse of :func:`shard_batch`'s column split for one tensor:
    the sp ranks' ``x`` (logits ``[B, S/p, V]``, say) gathered along
    ``seq_dim`` in natural token order (``stripe``: from the striped
    layout), without grad. Every sp rank calls this."""
    if mesh.shape.get("sp", 1) == 1:
        return x.detach()
    ring = axis_ring(mesh, "sp")
    (whole,) = sp_all_gather([x.detach()], ring, seq_dim)
    return stripe_unshard(whole, ring.size, seq_dim) if stripe else whole


def fsdp_sharding_for(mesh: Mesh, shape: tuple[int, ...], dtype=None,
                      axis: str = "fsdp") -> NamedSharding:
    """Largest-divisible-dimension sharding of an un-annotated tensor over
    ``axis`` (the first such dimension on a tie); replicated without the
    axis, without a dimension that divides, or under 2^14 elements, where
    the gather would cost more than the memory saved."""
    if axis not in mesh.axis_names:
        return replicated(mesh)
    n = mesh.shape[axis]
    if math.prod(shape or (1,)) < (1 << 14):
        return replicated(mesh)
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % n == 0:
            spec = [None] * len(shape)
            spec[d] = axis
            return NamedSharding(mesh, tuple(spec))
    return replicated(mesh)


def _annotated(model: Model) -> bool:
    return getattr(model, "param_axes", None) is not None


def variable_shardings(model: Model, mesh: Mesh, variables: dict) -> dict:
    """Each variable's sharding (see the module's docstring); buffers are
    replicated."""
    out = infer_variable_shardings(mesh, variables, getattr(model, "param_axes", None))
    if mesh.shape.get("fsdp", 1) > 1:
        trainable = {name for name, _ in model.module.named_parameters()}
        out = {k: fsdp_sharding_for(mesh, tuple(variables[k].shape))
               if k in trainable and s.is_replicated else s for k, s in out.items()}
    return out


def zero1_optimizer(optimizer, group):
    """The factory ``optimizer`` as a ``ZeroRedundancyOptimizer`` over
    ``group``: each rank keeps its share of the optimizer's state."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from distkeras_tpu_torch.ops.losses import optimizer_spec

    cls, kwargs = optimizer_spec(optimizer)
    return functools.partial(ZeroRedundancyOptimizer, optimizer_class=cls,
                             process_group=group, **kwargs)


def sharded_train_state(model: Model, optimizer, mesh: Mesh, seed: int = 0,
                        zero1: bool = False, device: str | torch.device | None = None):
    """``(TrainState, shardings)``: the weights drawn whole from ``seed``
    (``model.init``) and placed (:func:`place_sharded`), so that gathered
    they equal the unsharded init; the optimizer (a factory) over this
    rank's parts, sharded over ``dp`` with ``zero1`` (on one ``dp`` rank
    there is nothing to shard). Every rank of the mesh calls this."""
    variables = model.init(seed, device=device)
    shardings = variable_shardings(model, mesh, variables)
    local = place_sharded(variables, shardings, device)
    del variables
    trainable = {name for name, _ in model.module.named_parameters()}
    params = {k: v.requires_grad_() for k, v in local.items() if k in trainable}
    model_state = {k: v for k, v in local.items() if k not in trainable}
    for axis in mesh.axis_names:  # every rank builds the groups together
        mesh.group(axis)
    for axes in dict.fromkeys(_leaf_axes(s) for s in shardings.values()):
        if len(axes) > 1:  # a leaf split over several axes gathers over them
            mesh.group(axes)
    if zero1 and mesh.shape.get("dp", 1) > 1 and mesh.group("dp") is not None:
        optimizer = zero1_optimizer(optimizer, mesh.group("dp"))
    state = TrainState(params, model_state, optimizer(list(params.values())), 0, int(seed),
                       shardings=shardings)
    return state, shardings


def _splits(sharding: NamedSharding) -> tuple[tuple[int, tuple[str, ...]], ...]:
    """``((dim, axes), ...)``: each dimension a leaf is split along and the
    axes it is split over (an axis of size 1 splits nothing); ``()`` for a
    replicated leaf."""
    out = []
    for d, entry in enumerate(sharding.spec):
        axes = tuple(a for a in _spec_axes(entry) if sharding.mesh.shape[a] > 1)
        if axes:
            out.append((d, axes))
    return tuple(out)


def _leaf_axes(sharding: NamedSharding) -> tuple[str, ...]:
    """Every axis a leaf is split over, in the order of its dimensions
    (``("ep", "tp")`` for an MoE ``w_in`` on a tp x ep mesh)."""
    return tuple(a for _, axes in _splits(sharding) for a in axes)


def _by_group(names, tensors: dict, shardings: dict):
    """The split leaves of ``names`` grouped by (axes, dtype), in order."""
    groups: dict[tuple[tuple[str, ...], torch.dtype], list] = {}
    for name in names:
        axes = _leaf_axes(shardings[name])
        if axes:
            groups.setdefault((axes, tensors[name].dtype), []).append(name)
    return groups


def _members(group) -> list[int]:
    """The global ranks of ``group``, in group-rank order."""
    return [torch.distributed.get_global_rank(group, r)
            for r in range(torch.distributed.get_world_size(group))]


@torch.no_grad()
def gather_whole(tensors: dict, shardings: dict, span_name: str = "gather_whole") -> dict:
    """Every leaf of ``tensors`` (this rank's parts) whole, without grad:
    each split leaf gathered over its axes (one axis, or the joint group of
    several, as an MoE expert weight on a tp x ep mesh is split along two
    dimensions), one ``all_gather`` for each set of axes and dtype. Every
    rank of the mesh calls this, with the same names in the same order."""
    out = dict(tensors)
    for (axes, _), leaves in _by_group(tensors, tensors, shardings).items():
        mesh = shardings[leaves[0]].mesh
        group = mesh.group(axes)
        n = math.prod(mesh.shape[a] for a in axes)
        flat = torch.cat([tensors[name].reshape(-1) for name in leaves])
        parts = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
        with span(span_name):
            torch.distributed.all_gather_into_tensor(parts, flat, group=group)
        parts = parts.view(n, -1)
        for r, member in enumerate(_members(group)):
            offset = 0
            for name in leaves:
                local = tensors[name]
                if r == 0:
                    shape = list(local.shape)
                    for d, split in _splits(shardings[name]):
                        shape[d] *= math.prod(mesh.shape[a] for a in split)
                    out[name] = torch.empty(shape, dtype=local.dtype, device=local.device)
                whole = out[name]
                whole[shardings[name].index(whole.shape, member)] = parts[
                    r, offset:offset + local.numel()].view(local.shape)
                offset += local.numel()
    return out


# The axes whose split leaves a step gathers whole (the tp leaves stay split:
# the model computes on them), and the axes its reduction averages over.
_GATHERED = ("fsdp", "sp")
_REDUCED = ("dp", "fsdp", "sp")


class Sharded(DataParallel):
    """The gather and reduction of a model-parallel step over ``mesh``
    (see the module's docstring). ``rank`` is the rank's place among the
    data and sequence shards, which its dropout seed folds in: the ranks
    of one tp group take the same rows and columns and draw the same
    dropout masks."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        coord = mesh.coords(process_index())
        data = coord.get("dp", 0) * mesh.shape.get("fsdp", 1) + coord.get("fsdp", 0)
        self.rank = data * mesh.shape.get("sp", 1) + coord.get("sp", 0)
        data = tuple(a for a in ("dp", "fsdp") if mesh.shape.get(a, 1) > 1)
        self.stats_group = self._group(data)
        self.reduced = tuple(a for a in _REDUCED if mesh.shape.get(a, 1) > 1)

    def _group(self, axes: tuple[str, ...]):
        return self.mesh.group(axes if len(axes) > 1 else axes[0]) if axes else None

    def _gathered(self, state) -> dict[str, str]:
        """name -> axis of each leaf the step gathers whole."""
        out = {}
        for k in state.params:
            axes = _leaf_axes(state.shardings[k])
            if any(a in _GATHERED for a in axes):
                if len(axes) > 1:
                    raise NotImplementedError(
                        f"{k} split as {state.shardings[k].spec}: a leaf the step gathers "
                        f"whole is split over one axis")
                out[k] = axes[0]
        return out

    def variables(self, state: TrainState):
        gathered = self._gathered(state)
        if not gathered:
            return state.variables, state.params
        whole = {}
        for axis in _GATHERED:
            names = [k for k, a in gathered.items() if a == axis]
            if names:
                whole.update(gather_whole({k: state.params[k].detach() for k in names},
                                          state.shardings, f"{axis}_gather"))
        params = {k: whole[k].requires_grad_() if k in whole else p
                  for k, p in state.params.items()}
        return {**params, **state.model_state}, params

    def reduce(self, state: TrainState, params: dict, out: dict) -> dict:
        mesh = self.mesh
        keys = list(out)
        stacked = torch.stack([out[k].float() for k in keys])
        gathered = self._gathered(state)
        for ((axis,), _), leaves in _by_group(gathered, state.params,
                                              state.shardings).items():
            group, n = mesh.group(axis), mesh.shape[axis]
            with span(f"{axis}_reduce_scatter"):
                flat = torch.cat([params[name].grad[state.shardings[name].index(
                    params[name].shape, m)].reshape(-1) for m in _members(group)
                    for name in leaves])
                mine = torch.empty(flat.numel() // n, dtype=flat.dtype, device=flat.device)
                torch.distributed.reduce_scatter_tensor(mine, flat, group=group)
                mine.div_(n)
            offset = 0
            for name in leaves:
                p = state.params[name]
                p.grad = mine[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
        # Each gradient averaged over the reduction axes its leaf is not
        # split over; the metrics over all of them, with the whole leaves.
        buckets: dict[tuple[str, ...], list] = {self.reduced: []}
        for k, p in state.params.items():
            rest = tuple(a for a in self.reduced if a != gathered.get(k))
            buckets.setdefault(rest, []).append(p.grad)
        buckets[self.reduced].append(stacked)
        for axes, tensors in buckets.items():
            if axes:
                all_reduce_mean_(tensors, self._group(axes))
        return dict(zip(keys, stacked.unbind()))


def make_sharded_train_step(model: Model, loss: str | Callable, mesh: Mesh,
                            metrics: tuple[str, ...] = ("accuracy",),
                            aux_loss_weight: float = 0.01, shard_sequence: bool = False):
    """``step(state, batch) -> (state, metrics)`` over a
    :func:`sharded_train_state`: :func:`make_train_step`'s body, this
    rank's rows of the global batch in ``batch``, the gradients and metrics
    those of the global batch. An annotated model on a tp mesh computes on
    its tp shards; a model with ``ring_mesh`` runs its attention over this
    mesh's sp axis, on this rank's columns in ``batch``; with
    ``shard_sequence`` an annotated model without ``ring_mesh`` on an sp
    mesh takes this rank's columns too and gathers what its attention needs
    over sp (``BertConfig.seq_mesh``, the reference's XLA sequence split);
    an MoE model on an ep mesh computes on its ep shard of the experts."""
    cfg = getattr(model, "config", None)
    if mesh.shape.get("tp", 1) > 1 and _annotated(model):
        model = with_tp_mesh(model, mesh)
    if mesh.shape.get("ep", 1) > 1 and getattr(cfg, "moe_experts", 0) > 0:
        model = with_ep_mesh(model, mesh)
    if getattr(cfg, "ring_mesh", None) is not None:
        model = with_ring_mesh(model, mesh)
    elif shard_sequence and mesh.shape.get("sp", 1) > 1 and _annotated(model):
        model = with_seq_mesh(model, mesh)
    return train_step(model, loss, Sharded(mesh), metrics, aux_loss_weight=aux_loss_weight)


def whole_state_tree(state: TrainState) -> dict | None:
    """The checkpoint tree of a sharded ``state`` with every leaf whole:
    the weights and each optimizer tensor of a weight's shape gathered like
    the weight. Every rank calls this. Under zero1 (a
    ``ZeroRedundancyOptimizer`` over ``dp``, its state consolidated to the
    first rank of each dp group) only those first ranks hold a whole
    optimizer state of their parts: they gather it over the model axes
    (whose groups never span dp) and the other ranks return None."""
    from distkeras_tpu_torch.checkpoint import _state_tree

    if getattr(state.optimizer, "rank", 0) != 0 and hasattr(
            state.optimizer, "consolidate_state_dict"):
        return None
    tree = _state_tree(state)
    tree["params"] = gather_whole(tree["params"], state.shardings)
    names = list(state.params)
    moments, shardings = {}, {}
    for i, entry in sorted(tree["opt_state"].items(), key=lambda kv: int(kv[0])):
        p = state.params[names[int(i)]]
        for k, v in entry.items():
            if v.shape == p.shape and v.ndim:
                moments[(i, k)] = v
                shardings[(i, k)] = state.shardings[names[int(i)]]
    for (i, k), v in gather_whole(moments, shardings).items():
        tree["opt_state"][i][k] = v
    return tree


def local_state_tree(tree: dict, state: TrainState) -> dict:
    """The inverse of :func:`whole_state_tree` for this rank: each whole
    leaf of a saved ``tree`` cut to the part ``state`` holds."""
    rank = process_index()
    names = list(state.params)
    out = dict(tree)
    out["params"] = {k: v[state.shardings[k].index(v.shape, rank)]
                     for k, v in tree["params"].items()}
    opt = {}
    for i, entry in tree.get("opt_state", {}).items():
        sharding = state.shardings[names[int(i)]]
        whole = tree["params"][names[int(i)]].shape
        opt[i] = {k: v[sharding.index(v.shape, rank)] if v.shape == whole and v.ndim else v
                  for k, v in entry.items()}
    out["opt_state"] = opt
    return out
