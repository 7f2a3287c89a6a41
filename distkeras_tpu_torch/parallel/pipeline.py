"""Pipeline parallelism over a ``pp`` mesh axis: counterpart of
``distkeras_tpu/parallel/pipeline.py`` (GPipe, and Megatron-style
interleaved virtual stages).

**Schedule** (the reference's, tick for tick). With ``V = virtual_stages``
chunks per rank, the ``L = V·P`` logical stages are laid out round-robin:
the rank at pp index ``d`` holds logical stages ``{d, P+d, …, (V-1)·P+d}``
(:func:`rank_stages`; in the reference's stacked layout position ``d·V + v``
holds logical stage ``v·P + d``, :func:`stack_stage_params`). At tick ``t``
rank ``d`` applies chunk ``v(τ) = (τ//P) mod V`` to microbatch
``m(τ) = (τ//(V·P))·P + τ%P``, ``τ = t − d``, when ``τ ≥ 0`` and
``m < M``; rank 0 ingests microbatch ``m`` at its chunk 0, and rank
``P−1`` at its chunk ``V−1`` emits it. The step takes
:func:`schedule_ticks` ticks. A rank holds only its own V chunks (a list,
chunk ``v`` being logical stage ``v·P + d``), as plain tensors.

**Hops.** Activations go ``d → d+1``, and ``P−1 → 0`` between chunks when
``V > 1``, one tick later; the backward sends cotangents the other way.
The reference rotates every device's state every tick (a lock-step
``ppermute``, zeros on idle ticks). Here a hop happens only where it
carries a real activation: rank ``d`` sends at tick ``t`` exactly when its
application there is real and not an emit, and that is exactly when its
next rank's application at ``t + 1`` is real and not an ingest, so both
ends compute the same predicate. Each tick every rank first computes, then
posts all its hops of the tick (:func:`~distkeras_tpu_torch.parallel.distributed.pp_exchange`,
one ``batch_isend_irecv``) and waits for them. **No deadlock:** a rank's
sends at tick ``t`` depend only on receives of ticks before ``t``, so once
every rank has finished tick ``t − 1``, every send of tick ``t`` is posted
and every receive of tick ``t`` is matched; by induction every tick ends.
Between two ranks at most one message per direction moves per tick, and
both post the ticks in the same order, so sends and receives pair in order.

**Backward.** :func:`pipeline_apply` is one ``torch.autograd.Function``.
Its forward records each stage application under autograd (the chunk's
weights and the arriving activation as leaves); its backward walks the
ticks in reverse (the reference's scan time-reversal): at each real
application the cotangent of its output (the caller's for an emitted
microbatch, else the one the next rank sent) goes back through that
application's graph, its weight gradients add up, and its input's
cotangent hops to the previous rank (or, at an ingest, becomes the
microbatch's gradient). The hops of the reversed ticks follow the same
predicates and the same argument. A ``stage_fn`` wrapped in
``torch.utils.checkpoint(..., use_reentrant=False)`` (the trainer's
``remat``) keeps only its inputs and recomputes in the backward.

**Outputs.** The reference ``psum``s the last stage's outputs after the
scan so that every device holds them. ``broadcast=True`` (the default)
does the same with one broadcast from the rank at pp index ``P−1``; its
backward takes that rank's cotangent once (each rank's cotangent is the
same when every rank computes the same loss), not the sum over ranks.
``broadcast=False`` leaves the outputs on rank ``P−1`` alone (zeros
elsewhere): the other ranks then start the backward with any cotangent,
which is not read. Dropout: the stage function receives an integer seed
unique per (tick, rank, dp slice), ``fold_in(fold_in(rng, t), d)`` then
the dp index, the reference's key structure.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from distkeras_tpu_torch.ops.moe import is_expert_leaf
from distkeras_tpu_torch.parallel.distributed import (
    axis_ring,
    pp_exchange,
    pp_join,
    process_index,
)
from distkeras_tpu_torch.parallel.mesh import Mesh, NamedSharding
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = [
    "pipeline_apply",
    "pipeline_shardings",
    "rank_stages",
    "schedule_ticks",
    "stack_stage_params",
    "is_expert_leaf",
    "stage_param_specs",
]

def stage_param_specs(stacked, ep_size: int = 1):
    """Per-leaf partition specs of stacked stage params (reference
    ``stage_param_specs``): the stage axis over ``pp`` everywhere, and with
    ``ep_size > 1`` the expert dimension of the MoE expert weights
    (:func:`is_expert_leaf`) over ``ep`` as well, ``("pp", "ep")``."""

    def spec(path, _leaf):
        return ("pp", "ep") if ep_size > 1 and is_expert_leaf(path) else ("pp",)

    return pytree.tree_map_with_path(spec, stacked)


def schedule_ticks(num_microbatches: int, num_devices: int, virtual_stages: int = 1) -> int:
    """Ticks of the interleaved schedule: microbatch ``M-1`` injects at
    ``((M-1)//P)·V·P + (M-1)%P`` and takes ``V·P`` ticks to drain."""
    M, P, V = num_microbatches, num_devices, virtual_stages
    return ((M - 1) // P) * V * P + (M - 1) % P + V * P


def rank_stages(num_devices: int, virtual_stages: int, index: int) -> list[int]:
    """The logical stages the rank at pp index ``index`` holds, chunk by
    chunk: chunk ``v`` is logical stage ``v·P + index``."""
    return [v * num_devices + index for v in range(virtual_stages)]


def stack_stage_params(stage_params_list, virtual_stages: int = 1):
    """Stack per-stage parameter trees (logical order) on a leading stage
    axis in the round-robin layout: position ``d·V + v`` holds logical stage
    ``v·P + d`` (:func:`rank_stages` of ``d``), so a contiguous split over
    ``pp`` hands rank ``d`` its V chunks."""
    L = len(stage_params_list)
    if L % virtual_stages:
        raise ValueError(f"{L} stages not divisible by virtual_stages={virtual_stages}")
    P = L // virtual_stages
    order = [s for d in range(P) for s in rank_stages(P, virtual_stages, d)]
    stages = [stage_params_list[i] for i in order]
    return pytree.tree_map(lambda *xs: torch.stack(xs), stages[0], *stages[1:])


def _io_spec(mesh: Mesh) -> tuple:
    """Microbatch spec ``[M, B, ...]``: the batch axis over ``dp`` when the
    mesh has one above 1 (each dp slice runs its own pipe), else replicated."""
    if "dp" in mesh.axis_names and mesh.shape["dp"] > 1:
        return (None, "dp")
    return ()


def pipeline_shardings(mesh: Mesh) -> tuple[NamedSharding, NamedSharding]:
    """(stacked params sharding, microbatch sharding) for :func:`pipeline_apply`."""
    return NamedSharding(mesh, ("pp",)), NamedSharding(mesh, _io_spec(mesh))


def axis_rank(mesh: Mesh, axis: str, index: int) -> int:
    """The global rank at ``index`` along ``axis`` from this rank."""
    where = list(np.argwhere(mesh.devices == process_index())[0])
    where[mesh.axis_names.index(axis)] = index
    return int(mesh.devices[tuple(where)])


def dp_folds(mesh: Mesh) -> list[int]:
    """What a pipeline folds into its dropout seeds besides the tick or
    microbatch and the stage: this rank's dp index, when the microbatches
    are split over a dp axis above 1 (the reference's varying axes)."""
    if "dp" not in _io_spec(mesh):
        return []
    return [mesh.coords(process_index())["dp"]]


def staged_collective(fn, t: torch.Tensor, group) -> torch.Tensor:
    """``fn(t)`` (an in-place collective on ``t``) on ``t``, through host
    memory under gloo when ``t`` is a CUDA tensor; returns the result."""
    if t.is_cuda and torch.distributed.get_backend(group) == "gloo":
        host = t.cpu()
        fn(host)
        return host.to(t.device)
    fn(t)
    return t


class _Ticks:
    """The interleaved schedule's tick algebra (reference ``_pipeline_local``)."""

    def __init__(self, M: int, P: int, V: int):
        self.M, self.P, self.V = M, P, V

    def app(self, t: int, d: int):
        """``(v, m)`` rank ``d`` applies at tick ``t``, or None (idle)."""
        P, V = self.P, self.V
        tau = t - d
        if tau < 0:
            return None
        m = (tau // (V * P)) * P + tau % P
        return ((tau // P) % V, m) if m < self.M else None

    def ingest(self, t: int, d: int) -> bool:
        a = self.app(t, d)
        return a is not None and d == 0 and a[0] == 0

    def emit(self, t: int, d: int) -> bool:
        a = self.app(t, d)
        return a is not None and d == self.P - 1 and a[0] == self.V - 1

    def sends(self, t: int, d: int) -> bool:
        """Whether rank ``d``'s output at tick ``t`` hops to the next rank."""
        return self.app(t, d) is not None and not self.emit(t, d)


class _Run:
    """One :func:`pipeline_apply` on this rank: the forward tick loop, and
    the reversed one for the backward."""

    def __init__(self, stage_fn, chunks, mesh, axis_name, virtual_stages, rng, with_aux,
                 broadcast, M):
        self.stage_fn, self.rng, self.with_aux, self.broadcast = stage_fn, rng, with_aux, broadcast
        self.ring = axis_ring(mesh, axis_name)
        self.P, self.d = self.ring.size, self.ring.index
        self.ticks = _Ticks(M, self.P, virtual_stages)
        self.folds = dp_folds(mesh)
        self.dp_group = mesh.group("dp") if self.folds else None
        self.last_rank = axis_rank(mesh, axis_name, self.P - 1) if self.P > 1 else None
        flat = [pytree.tree_flatten(c) for c in chunks]
        self.specs = [spec for _, spec in flat]
        self.sizes = [len(leaves) for leaves, _ in flat]
        self.apps: dict[int, tuple] = {}

    def _seed(self, t: int):
        if self.rng is None:
            return None
        seed = fold_in(fold_in(self.rng, t), self.d)
        for i in self.folds:
            seed = fold_in(seed, i)
        return seed

    def _chunk(self, leaves, v):
        start = sum(self.sizes[:v])
        return pytree.tree_unflatten(list(leaves[start:start + self.sizes[v]]), self.specs[v])

    def _apply(self, chunk, x, t):
        seed = self._seed(t)
        out = self.stage_fn(chunk, x) if seed is None else self.stage_fn(chunk, x, seed)
        return out if self.with_aux else (out, None)

    def forward(self, microbatches, leaves, record: bool):
        """The tick loop; returns ``(outputs [M, B, ...], aux sum)``. With
        ``record`` each application keeps its graph for :meth:`backward`."""
        ticks, d, P = self.ticks, self.d, self.P
        like = microbatches[0]
        pp_join(self.ring, like.device)
        out = torch.zeros_like(microbatches)
        aux = torch.zeros((), dtype=torch.float32, device=microbatches.device)
        if record:
            leaves = [p.detach().requires_grad_() for p in leaves]
            self.leaves = leaves
        chunks = [self._chunk(leaves, v) for v in range(len(self.sizes))]
        state = None
        for t in range(schedule_ticks(ticks.M, P, ticks.V)):
            a = ticks.app(t, d)
            y = None
            if a is not None:
                v, m = a
                x = microbatches[m] if ticks.ingest(t, d) else state
                if record:
                    x = x.detach().requires_grad_()
                    with torch.enable_grad():
                        y, a_aux = self._apply(chunks[v], x, t)
                    self.apps[t] = (x, y, a_aux)
                else:
                    y, a_aux = self._apply(chunks[v], x, t)
                if a_aux is not None:
                    aux = aux + a_aux.detach().float()
                if ticks.emit(t, d):
                    out[m] = y.detach()
            to_next = y.detach() if ticks.sends(t, d) else None
            want = like if ticks.sends(t, (d - 1) % P) else None
            state, _ = pp_exchange(self.ring, to_next=to_next, from_prev=want)
        if self.broadcast and P > 1:
            dist = torch.distributed
            out = staged_collective(
                lambda b: dist.broadcast(b, self.last_rank, group=self.ring.group), out,
                self.ring.group)
        if self.with_aux:
            if P > 1:
                aux = staged_collective(
                    lambda b: torch.distributed.all_reduce(b, group=self.ring.group), aux,
                    self.ring.group)
            if self.dp_group is not None:
                aux = staged_collective(
                    lambda b: torch.distributed.all_reduce(b, group=self.dp_group), aux,
                    self.dp_group) / torch.distributed.get_world_size(self.dp_group)
        return out, aux

    def backward(self, g_out, g_aux):
        """The reversed ticks: ``(microbatches' gradient, each leaf's)``."""
        ticks, d, P = self.ticks, self.d, self.P
        like = g_out[0]
        g_mb = torch.zeros_like(g_out)
        g_leaves = [None] * len(self.leaves)
        g_aux_each = None
        if self.with_aux:
            g_aux_each = g_aux.float()
            if self.dp_group is not None:
                g_aux_each = g_aux_each / torch.distributed.get_world_size(self.dp_group)
        cot = None
        for t in reversed(range(schedule_ticks(ticks.M, P, ticks.V))):
            a = ticks.app(t, d)
            gx = None
            if a is not None:
                v, m = a
                x, y, a_aux = self.apps.pop(t)
                gy = g_out[m] if ticks.emit(t, d) else cot
                start = sum(self.sizes[:v])
                inputs = [x, *self.leaves[start:start + self.sizes[v]]]
                outs, cots = [y], [gy.to(y.dtype)]
                if a_aux is not None:
                    outs.append(a_aux)
                    cots.append(g_aux_each.to(a_aux.dtype))
                grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
                gx = grads[0] if grads[0] is not None else torch.zeros_like(x)
                for i, g in enumerate(grads[1:], start):
                    if g is not None:
                        g_leaves[i] = g if g_leaves[i] is None else g_leaves[i] + g
                if ticks.ingest(t, d):
                    g_mb[m] = gx
            to_prev = gx if a is not None and not ticks.ingest(t, d) else None
            nxt = (d + 1) % P
            want = like if ticks.app(t, nxt) is not None and not ticks.ingest(t, nxt) else None
            _, cot = pp_exchange(self.ring, to_prev=to_prev, from_next=want)
        g_leaves = [torch.zeros_like(p) if g is None else g
                    for p, g in zip(self.leaves, g_leaves)]
        self.leaves = None
        return g_mb, g_leaves


class _PipelineFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, microbatches, *leaves):
        ctx.run = run
        return run.forward(microbatches, leaves, record=True)

    @staticmethod
    def backward(ctx, g_out, g_aux):
        g_mb, g_leaves = ctx.run.backward(g_out, g_aux)
        ctx.run = None
        return (None, g_mb, *g_leaves)


def pipeline_apply(
    stage_fn,
    stage_params,
    microbatches: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "pp",
    virtual_stages: int = 1,
    rng: int | None = None,
    with_aux: bool = False,
    broadcast: bool = True,
):
    """Run an ``L = V·P``-stage pipeline over ``mesh[axis_name]`` (size ``P``).

    - ``stage_fn(chunk, x) -> y`` with ``y.shape == x.shape``
      (``stage_fn(chunk, x, seed)`` when ``rng`` is given: an integer seed
      unique per (tick, rank, dp slice), for dropout);
    - ``stage_params``: this rank's chunks, a list of ``V`` parameter trees
      (dicts and lists of tensors), chunk ``v`` being logical stage
      ``v·P + d`` (:func:`rank_stages`);
    - ``microbatches``: ``[M, B, ...]``, this dp slice's rows (read on
      the rank at pp index 0; elsewhere only its shape, dtype and device);
    - ``with_aux``: ``stage_fn`` returns ``(y, aux_scalar)``; the scalars of
      every real application are summed over stages and microbatches and
      averaged over dp slices, and returned beside the outputs;
    - ``broadcast``: see the module's docstring.

    Returns ``[M, B, ...]``, the last stage's outputs (and the aux sum
    under ``with_aux``). Differentiable in ``microbatches`` and in every
    tensor of ``stage_params``. Every rank of the mesh calls it together.
    """
    ring_size = mesh.shape[axis_name] if axis_name in mesh.axis_names else None
    if ring_size is None:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis_name!r}")
    if microbatches.shape[0] < 1:
        raise ValueError("need at least one microbatch")
    expected = virtual_stages * ring_size
    lead = len(stage_params) * ring_size
    if lead != expected:
        raise ValueError(
            f"stacked params have {lead} stages but mesh {axis_name}="
            f"{ring_size} x virtual_stages={virtual_stages} "
            f"needs {expected} — pass the same virtual_stages to "
            f"stack_stage_params and pipeline_apply"
        )
    run = _Run(stage_fn, list(stage_params), mesh, axis_name, virtual_stages, rng, with_aux,
               broadcast, microbatches.shape[0])
    leaves = [leaf for c in stage_params for leaf in pytree.tree_leaves(c)]
    if torch.is_grad_enabled() and (microbatches.requires_grad
                                    or any(p.requires_grad for p in leaves)):
        out, aux = _PipelineFn.apply(run, microbatches, *leaves)
    else:
        with torch.no_grad():
            out, aux = run.forward(microbatches, leaves, record=False)
    return (out, aux) if with_aux else out
