"""The 1F1B pipeline schedule with a hand-rolled backward: counterpart of
``distkeras_tpu/parallel/pipeline_1f1b.py``.

**Schedule** (the reference's). Non-interleaved 1F1B over ``P`` ranks of the
``pp`` axis: the rank at pp index ``d`` runs the forward (F) of microbatch
``m`` at tick ``2m + d`` and its backward (B) at tick ``2m + 2P − 1 − d``;
the two never fall on one tick (their parities differ), and the step takes
:func:`ticks_1f1b` ticks. Activations hop ``d → d+1`` after an F,
cotangents (float32) hop ``d → d−1`` after a B, each received the tick
before the rank uses it. A hop is posted only where it carries something
(the reference's fill and drain elide the dead ones; here idle ticks carry
nothing either), and both ends of a hop derive it from the same tick
algebra. Each tick a rank computes, then posts the tick's hops in one
``batch_isend_irecv``
(:func:`~distkeras_tpu_torch.parallel.distributed.pp_exchange`) and waits:
a send of tick ``t`` depends only on receives before ``t``, so the same
induction as :mod:`~distkeras_tpu_torch.parallel.pipeline`'s makes every
tick end, and no pair of ranks exchanges more than one message per
direction per tick.

**Memory.** A rank keeps the stage *inputs* of the microbatches whose B
has not run (at most ``P``, a ring indexed ``m mod P``) and recomputes the
stage under ``torch.enable_grad()`` at the B tick, then backpropagates the
arriving cotangent through it. The last rank skips its F stage math (its B
recomputes it) and fuses head and loss into its B tick: ``last_fn`` is the
last stage, head and loss of one microbatch, seeded with cotangent 1. The
input cotangents of rank 0 (``cot_out``, ``[M, B, ...]`` float32) go back
to the caller for the embedding's backward.

**Dropout.** With ``rng`` every stage application receives an integer seed
folded from (microbatch, stage, dp slice), the reference's ``key_for``:
``fold_in(fold_in(rng, m), d)`` then the dp index. So the recompute at the
B tick draws the forward's masks.

**MoE** (``stage_aux_seed``, reference ``_1f1b_local``'s MoE mode): the
stage function returns ``(y, aux)`` and the last one ``(loss, aux)`` (or
``(loss, aux, metric)`` under ``with_aux``), ``aux`` a stage's summed
load-balancing loss. Each B tick backpropagates the aux output seeded with
``stage_aux_seed`` beside the activation's cotangent (the caller folds its
weight and ``1/M`` there), so the router's balance trains through the same
recompute; the raw aux of every B tick is summed for the metric. An F tick
counts none. With expert-parallel stages (a sum over an ``ep`` group
inside the stage function) every ep rank of a pp index takes the same
ticks, so those sums pair up.

**Data parallelism.** On a mesh with ``dp > 1`` each dp slice runs its own
pipe on its rows; loss, aux and gradients are averaged over dp, and
``cot_out`` is divided by the dp size (the mean-loss convention of the
reference's ``pmean``). ``reduce=False`` returns every quantity as this rank
accumulated it (the loss and head gradients on the last rank, ``cot_out``
on rank 0, nothing averaged): for a caller that folds these reductions into
its own (``PipelineTrainer`` sums the head's and the embedding's
gradients in one reduction).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from distkeras_tpu_torch.parallel.distributed import axis_ring, pp_exchange, pp_join
from distkeras_tpu_torch.parallel.mesh import Mesh
from distkeras_tpu_torch.parallel.pipeline import (
    dp_folds,
    staged_collective,
    stack_stage_params,
)
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = ["pipeline_1f1b_value_and_grad", "stack_stage_params", "ticks_1f1b"]


def ticks_1f1b(num_microbatches: int, num_devices: int) -> int:
    """Ticks of a step: the last backward is rank 0's of microbatch ``M-1``
    at ``2(M-1) + 2P - 1``."""
    return 2 * num_microbatches + 2 * num_devices - 2


def _f_at(t: int, d: int, M: int):
    """The microbatch rank ``d`` runs forward at tick ``t``, or None."""
    k = t - d
    return k // 2 if k >= 0 and k % 2 == 0 and k // 2 < M else None


def _b_at(t: int, d: int, M: int, P: int):
    """The microbatch rank ``d`` runs backward at tick ``t``, or None."""
    k = t - (2 * P - 1 - d)
    return k // 2 if k >= 0 and k % 2 == 0 and k // 2 < M else None


def _add(acc: list, grads) -> None:
    for i, g in enumerate(grads):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


def _all_reduce(t: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
    t = staged_collective(lambda b: torch.distributed.all_reduce(b, group=group), t, group)
    return t / torch.distributed.get_world_size(group) if mean else t


def pipeline_1f1b_value_and_grad(
    stage_fn,
    last_fn,
    stage_params,
    head_params,
    microbatches: torch.Tensor,
    labels: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "pp",
    rng: int | None = None,
    with_aux: bool = False,
    stage_aux_seed: float | None = None,
    reduce: bool = True,
):
    """One 1F1B train-step evaluation over ``mesh[axis_name]``.

    - ``stage_fn(chunk, x) -> y`` (``stage_fn(chunk, x, seed)`` with
      ``rng``), ``y.shape == x.shape``: run by ranks ``0 .. P-2``;
    - ``last_fn(chunk, head, x, labels_mb) -> loss`` (``(loss, aux)`` under
      ``with_aux``; a ``seed`` argument after the labels with ``rng``): the
      last stage with head and loss of one microbatch;
    - ``stage_aux_seed`` (MoE): ``stage_fn`` returns ``(y, moe_aux)`` and
      ``last_fn`` ``(loss, moe_aux[, aux])``; see the module's docstring;
    - ``stage_params``: this rank's chunk, a list of one parameter tree
      (1F1B is not interleaved); ``head_params``: the head's tree;
    - ``microbatches`` ``[M, B, ...]`` and ``labels`` ``[M, ...]``: this dp
      slice's rows (read on the ranks at pp index 0 and ``P-1``).

    Returns ``(loss_sum[, aux_sum][, moe_aux_sum], stage_grads,
    head_grads, cot_out)``: the summed microbatch losses (divide by ``M``
    for the mean), the aux channels summed likewise, the gradients of
    ``stage_params`` (a list of one tree) and of ``head_params`` (float32),
    and the input cotangents (float32 ``[M, B, ...]``). With ``reduce``
    (default) every rank holds the reduced values (``moe_aux_sum`` summed
    over the stages and averaged over dp); see the module's docstring for
    ``reduce=False``.
    """
    moe = stage_aux_seed is not None
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis_name!r}")
    P = mesh.shape[axis_name]
    lead = len(stage_params) * P
    if lead != P:
        raise ValueError(
            f"stacked params have {lead} stages but mesh {axis_name}="
            f"{P} (1F1B is non-interleaved: V=1)"
        )
    ring = axis_ring(mesh, axis_name)
    pp_join(ring, microbatches.device)
    d, M = ring.index, microbatches.shape[0]
    folds = dp_folds(mesh)
    last = P - 1

    def run_stage(chunk, x, seed):
        out = stage_fn(chunk, x) if seed is None else stage_fn(chunk, x, seed)
        return out if moe else (out, None)

    def seed_for(m):
        if rng is None:
            return None
        seed = fold_in(fold_in(rng, m), d)
        for i in folds:
            seed = fold_in(seed, i)
        return seed

    params, spec = pytree.tree_flatten(stage_params[0])
    head, head_spec = pytree.tree_flatten(head_params)
    like = microbatches[0]
    like_cot = torch.empty(like.shape, dtype=torch.float32, device=like.device)
    ring_buf: list = [None] * P
    g_params, g_head = [None] * len(params), [None] * len(head)
    loss = torch.zeros((), dtype=torch.float32, device=like.device)
    aux, moe_aux = torch.zeros_like(loss), torch.zeros_like(loss)
    cot_out = torch.zeros(microbatches.shape, dtype=torch.float32, device=like.device) \
        if d == 0 else None
    act_in = cot_in = None
    for t in range(ticks_1f1b(M, P)):
        send_act = send_cot = None
        m = _f_at(t, d, M)
        if m is not None:
            x = microbatches[m] if d == 0 else act_in
            ring_buf[m % P] = x
            if d != last:
                chunk = pytree.tree_unflatten(params, spec)
                with torch.no_grad():
                    send_act = run_stage(chunk, x, seed_for(m))[0]
        m = _b_at(t, d, M, P)
        if m is not None:
            x = ring_buf[m % P].detach().requires_grad_()
            ring_buf[m % P] = None
            leaves = [p.detach().requires_grad_() for p in params]
            chunk = pytree.tree_unflatten(leaves, spec)
            seed = seed_for(m)
            with torch.enable_grad():
                if d == last:
                    head_leaves = [h.detach().requires_grad_() for h in head]
                    hp = pytree.tree_unflatten(head_leaves, head_spec)
                    args = (chunk, hp, x, labels[m]) + (() if seed is None else (seed,))
                    out = last_fn(*args)
                    out = list(out) if isinstance(out, tuple) else [out]
                    loss_m = out.pop(0)
                    saux_m = out.pop(0) if moe else None
                    aux_m = out.pop(0) if with_aux else None
                    roots, seeds = [loss_m], [torch.ones_like(loss_m)]
                    if moe:
                        roots.append(saux_m)
                        seeds.append(torch.full_like(saux_m, stage_aux_seed))
                        moe_aux = moe_aux + saux_m.detach().float()
                    grads = torch.autograd.grad(roots, [*leaves, *head_leaves, x], seeds,
                                                allow_unused=True)
                    _add(g_head, [None if g is None else g.float()
                                  for g in grads[len(leaves):-1]])
                    loss = loss + loss_m.detach().float()
                    if aux_m is not None:
                        aux = aux + aux_m.detach().float()
                else:
                    y, saux_m = run_stage(chunk, x, seed)
                    roots, seeds = [y], [cot_in.to(y.dtype)]
                    if moe:
                        roots.append(saux_m)
                        seeds.append(torch.full_like(saux_m, stage_aux_seed))
                        moe_aux = moe_aux + saux_m.detach().float()
                    grads = torch.autograd.grad(roots, [*leaves, x], seeds, allow_unused=True)
            _add(g_params, grads[:len(leaves)])
            gx = grads[-1] if grads[-1] is not None else torch.zeros_like(x)
            if d == 0:
                cot_out[m] = gx.float()
            else:
                send_cot = gx.float()
        want_act = like if d > 0 and _f_at(t, d - 1, M) is not None else None
        want_cot = like_cot if d < last and _b_at(t, d + 1, M, P) is not None else None
        act_in, cot_in = pp_exchange(ring, to_next=send_act, to_prev=send_cot,
                                     from_prev=want_act, from_next=want_cot)
    g_params = [torch.zeros_like(p) if g is None else g for p, g in zip(params, g_params)]
    g_head = [torch.zeros(h.shape, dtype=torch.float32, device=h.device) if g is None else g
              for h, g in zip(head, g_head)]
    if reduce:
        dp = mesh.group("dp") if folds else None
        if P > 1:
            flat = torch.cat([loss[None], aux[None], moe_aux[None],
                              *(g.reshape(-1) for g in g_head)])
            flat = _all_reduce(flat, ring.group)
            loss, aux, moe_aux = flat[0], flat[1], flat[2]
            g_head = [v.view_as(h) for v, h in zip(flat[3:].split([h.numel() for h in g_head]),
                                                   g_head)]
            src = torch.zeros(microbatches.shape, dtype=torch.float32, device=like.device) \
                if cot_out is None else cot_out
            cot_out = _all_reduce(src, ring.group)
        if dp is not None:
            n = torch.distributed.get_world_size(dp)
            loss, aux = _all_reduce(loss, dp, True), _all_reduce(aux, dp, True)
            moe_aux = _all_reduce(moe_aux, dp, True)
            g_head = [_all_reduce(g, dp, True) for g in g_head]
            g_params = [_all_reduce(g, dp, True) for g in g_params]
            cot_out = cot_out / n
    out = (loss,) + ((aux,) if with_aux else ()) + ((moe_aux,) if moe else ())
    return out + ([pytree.tree_unflatten(g_params, spec)],
                  pytree.tree_unflatten(g_head, head_spec), cot_out)
