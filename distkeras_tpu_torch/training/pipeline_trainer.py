"""Pipeline-parallel trainer: counterpart of
``distkeras_tpu/training/pipeline_trainer.py``.

A bert-family model's encoder trunk (``layer_0 .. layer_{L-1}``) is split
into ``pp`` stages of equal depth (``virtual_stages`` chunks a rank, the
round-robin layout of :mod:`~distkeras_tpu_torch.parallel.pipeline`), each
rank holding only its own layers and the replicated rest (``token_embed``,
``pos_embed``, ``ln_final``, ``mlm_bias``); each step runs the
microbatches through the pipe, with the embedding before it on the first
stage (dropout off there, as in the reference) and the tied-embedding MLM
head and the loss after it on the last. ``schedule="gpipe"`` runs
:func:`~distkeras_tpu_torch.parallel.pipeline.pipeline_apply` and takes the
backward from autograd through it (``remat`` recomputes each stage
application in the backward); ``schedule="1f1b"`` runs the hand-rolled
:func:`~distkeras_tpu_torch.parallel.pipeline_1f1b.pipeline_1f1b_value_and_grad`
with head and loss fused into the last stage's backward ticks. With a
``dp`` axis each dp slice runs its own pipe on its rows.

Where the loss runs: on the rank at pp index ``P−1`` only, which alone
launches the fused cross-entropy kernels (``loss="fused_categorical_crossentropy"``);
the loss and accuracy go to every rank inside the step's one gradient
reduction. The head is the reference's ``_head_logits``: ``ln_final`` in
float32, then ``x.f32 @ emb.f32ᵀ + mlm_bias`` (not the model forward's
head, which multiplies in ``cfg.dtype``). The replicated leaves' gradient
has two uses, the embedding on the first stage and the head on the last:
each step sums it over ``pp`` once and averages it over ``dp`` (one
``all_reduce`` over every rank, the step's metrics in the same buffer);
the stage weights' gradients are averaged over ``dp``. So every pp rank
steps identical replicated weights.

MoE trunks (``BertConfig.moe_experts``; reference ``pipeline_trainer.py:49-72,
:248-253, :295-307``): each stage returns its layers' summed load-balancing
loss beside its activation. Under gpipe ``pipeline_apply(with_aux=True)``
sums it over the stages and microbatches (and averages it over dp), and
the step adds ``aux_loss_weight`` times its microbatch mean to the loss;
under 1f1b the engine seeds each stage's aux with ``aux_loss_weight / M``
(``stage_aux_seed``). The history gains ``aux_loss``, that mean; ``loss``
stays the task loss. The routing of a stage runs on one microbatch of a
dp slice, as in the reference's pipe. With ``ep > 1`` (a mesh of
``dp × pp × ep``) each rank holds ``E/ep`` experts of its stage's layers
(``stage_param_specs``' ``("pp", "ep")``) and the stage runs the MoE block
in expert-parallel mode, its sums over the rank's ep group; the router and
every other leaf stay whole. The ep ranks of a pp index take the same
rows and the same ticks and draw the same dropout masks (no seed folds the
ep index), and every replicated leaf gets the same gradient on each of
them, so the replicated leaves' reduction runs over ``dp × pp`` alone.

What ``train()`` returns, and what checkpoints hold, are the whole weights
in the model's layout, gathered from the ranks (the expert leaves joined
along their expert dimension in ep order); a resume cuts the saved whole
state back to a rank's layers and experts.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.feed import DeviceFeed, minibatches
from distkeras_tpu_torch.models.bert import EncoderLayer
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import accuracy
from distkeras_tpu_torch.parallel.distributed import process_count, process_index
from distkeras_tpu_torch.parallel.mesh import Mesh, make_mesh
from distkeras_tpu_torch.parallel.pipeline import is_expert_leaf, pipeline_apply, rank_stages
from distkeras_tpu_torch.parallel.pipeline_1f1b import pipeline_1f1b_value_and_grad
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.training.step import TrainState, all_reduce_mean_
from distkeras_tpu_torch.training.trainers import Trainer, _read_history, _StepCheckpointer
from distkeras_tpu_torch.utils.pytree import to_host
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = ["PipelineTrainer"]

HEAD = ("token_embed.weight", "ln_final.weight", "ln_final.bias", "mlm_bias")


def _apply_stage_sublayers(layer_mod, stage_params, x, seed, per_stage, train, moe=False):
    """Apply one stage's encoder sublayers (``stage_params["sub_j"]``, each a
    layer's weights by their names inside the layer). The one body behind
    both schedules' stage functions. ``seed`` is set exactly when dropout
    is on; sublayer ``j`` folds ``j`` into it, so the 1F1B recompute draws
    the forward's masks. ``moe``: returns ``(x, the layers' summed aux
    loss)``."""
    aux = [] if moe else None
    for j in range(per_stage):
        rng = None if seed is None else fold_in(seed, j)
        x = torch.func.functional_call(layer_mod, stage_params[f"sub_{j}"], (x,),
                                       {"train": train, "rng": rng, "aux": aux})
    return (x, torch.stack(aux).sum()) if moe else x


def _layer_of(name: str) -> int | None:
    if name.startswith("layer_"):
        return int(name[len("layer_"):].split(".", 1)[0])
    return None


class PipelineTrainer(Trainer):
    """Train a bert-family model with its trunk pipelined over the ``pp``
    axis of a mesh of the process group's ranks (times an optional ``dp``).

    Run the same script on every rank after
    :func:`~distkeras_tpu_torch.parallel.distributed.initialize`. ``mesh``
    (a :class:`~distkeras_tpu_torch.parallel.mesh.Mesh` or a mapping of axis
    sizes) defaults to ``pp = num_stages`` (else every rank) and
    ``dp = world // pp``; ``num_layers`` must divide into
    ``pp × virtual_stages`` chunks and ``batch_size`` (the global batch)
    into ``num_microbatches × dp``. ``schedule`` is ``"gpipe"`` (with
    ``remat`` and ``virtual_stages``) or ``"1f1b"`` (``virtual_stages=1``).
    An MoE model trains with its aux loss, and with ``ep`` (or an ``ep``
    axis in ``mesh``) its experts split over ep (see the module's
    docstring). ``device`` as the other trainers': CUDA unless ``"cpu"``.
    """

    def __init__(
        self,
        keras_model: Model,
        worker_optimizer="adagrad",
        loss: str = "categorical_crossentropy",
        metrics=("accuracy",),
        num_stages: int | None = None,
        num_microbatches: int = 4,
        virtual_stages: int = 1,
        ep: int | None = None,
        remat: bool = False,
        schedule: str = "gpipe",
        batch_size: int = 32,
        features_col: str = "features",
        label_col: str = "label",
        num_epoch: int = 1,
        learning_rate: float | None = None,
        seed: int = 0,
        mesh=None,
        loss_weights=None,
        metric_stream=None,
        registry=None,
        auditor=None,
        aux_loss_weight: float = 0.01,
        checkpoint_dir: str | None = None,
        checkpoint_interval_s: float = 60.0,
        resume: bool = False,
        device: str | torch.device | None = None,
    ):
        super().__init__(keras_model, worker_optimizer, loss, metrics,
                         learning_rate=learning_rate, seed=seed,
                         loss_weights=loss_weights, metric_stream=metric_stream,
                         registry=registry, auditor=auditor, device=device)
        cfg = getattr(self.model, "config", None)
        if cfg is None or not hasattr(cfg, "num_layers"):
            raise ValueError(
                "PipelineTrainer needs a transformer-family model with a "
                ".config (distkeras_tpu_torch.models.bert zoo); got "
                f"{self.model.name!r}"
            )
        self.cfg = cfg
        if getattr(cfg, "ring_mesh", None) is not None:
            raise ValueError(
                "PipelineTrainer does not support sequence-parallel "
                "attention inside the pipelined trunk (cfg.ring_mesh is "
                "set); unset ring_mesh, or use the sync trainer for sp"
            )
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.num_stages = num_stages
        self.num_microbatches = int(num_microbatches)
        self.virtual_stages = int(virtual_stages)
        self.remat = bool(remat)
        self.schedule = schedule
        self.batch_size = int(batch_size)
        self.features_col = features_col
        self.label_col = label_col
        self.num_epoch = int(num_epoch)
        self.mesh = mesh
        self.ep = ep
        self.aux_loss_weight = float(aux_loss_weight)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval_s = float(checkpoint_interval_s)
        self.resume = bool(resume)
        self._dropout = getattr(cfg, "dropout_rate", 0.0) > 0.0
        self._moe = getattr(cfg, "moe_experts", 0) > 0

    # -- model surgery -------------------------------------------------------

    def _split_params(self, params: dict, num_stages: int, index: int = 0):
        """The chunks of the rank at pp index ``index`` (chunk ``v`` holds
        logical stage ``v·P + index``; its ``sub_j`` is layer
        ``s·per_stage + j``, keyed by the names inside the layer), and the
        replicated rest: ``({"stages": [chunk, ...], "rest": {...}},
        per_stage)``. The tensors are ``params``' own."""
        L = self.cfg.num_layers
        V = self.virtual_stages
        num_logical = num_stages * V
        if L % num_logical:
            raise ValueError(
                f"{L} layers not divisible into {num_stages} stages x "
                f"{V} virtual chunks"
            )
        per_stage = L // num_logical
        chunks = []
        for s in rank_stages(num_stages, V, index):
            chunk = {}
            for j in range(per_stage):
                prefix = f"layer_{s * per_stage + j}."
                chunk[f"sub_{j}"] = {k[len(prefix):]: v for k, v in params.items()
                                     if k.startswith(prefix)}
            chunks.append(chunk)
        rest = {k: v for k, v in params.items() if _layer_of(k) is None}
        return {"stages": chunks, "rest": rest}, per_stage

    def _merge_params(self, parts: list[dict], num_stages: int, per_stage: int) -> dict:
        """Back to the model's layout from every pp index's
        :meth:`_split_params` (``parts[d]``): inverts the round-robin layout."""
        merged = dict(parts[0]["rest"])
        for d, part in enumerate(parts):
            for s, chunk in zip(rank_stages(num_stages, self.virtual_stages, d), part["stages"]):
                for j in range(per_stage):
                    for k, v in chunk[f"sub_{j}"].items():
                        merged[f"layer_{s * per_stage + j}.{k}"] = v
        return merged

    @staticmethod
    def _head_logits(head: dict, x):
        """Tied-embedding MLM head: ``ln_final`` (float32) then
        ``x.f32 @ emb.f32ᵀ + mlm_bias``, shared by both schedules."""
        w = head["ln_final.weight"]
        x = F.layer_norm(x.float(), w.shape, w, head["ln_final.bias"], eps=1e-6)
        return torch.matmul(x, head["token_embed.weight"].float().t()) + head["mlm_bias"]

    def _embed(self, rest: dict, tokens):
        cfg = self.cfg
        x = F.embedding(tokens.long(), rest["token_embed.weight"]).to(cfg.dtype)
        return x + rest["pos_embed"][:, :tokens.shape[1]].to(cfg.dtype)

    def _stage_fn(self, per_stage: int, mesh: Mesh):
        # On "meta": functional_call swaps the weights in. Under ep the layer
        # runs its MoE block over the mesh's ep axis.
        if mesh.shape.get("ep", 1) > 1:
            with torch.device("meta"):
                layer_mod = EncoderLayer(dataclasses.replace(self.cfg, ep_mesh=mesh))
        else:
            layer_mod = self.model.module.layer_0
        train, moe = self._dropout, self._moe

        def stage_fn(chunk, x, seed=None):
            return _apply_stage_sublayers(layer_mod, chunk, x, seed, per_stage, train, moe)

        return stage_fn

    # -- the step --------------------------------------------------------------

    def _reduce(self, state, stage_names, rest_names, metrics, groups):
        """Every rank's gradients into the step's: the replicated leaves'
        summed over pp and averaged over dp with the metrics in the same
        buffer (over the ranks of one ep index: the ep ranks hold the same
        sums), the stage weights' averaged over dp. Returns the metrics."""
        world, dp_group, dp = groups
        for p in state.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if world is not None:
            rest = [state.params[n].grad for n in rest_names]
            flat = torch.cat([g.reshape(-1).float() for g in rest] + [metrics])
            with span("pp_grad_all_reduce"):
                torch.distributed.all_reduce(flat, group=world)
                flat.div_(dp)
            parts = flat.split([g.numel() for g in rest] + [metrics.numel()])
            torch._foreach_copy_(rest, [v.view_as(g) for g, v in zip(rest, parts)])
            metrics = parts[-1]
        if dp_group is not None:
            all_reduce_mean_([state.params[n].grad for n in stage_names], dp_group)
        return metrics

    def _make_step(self, mesh: Mesh, per_stage: int, index: int, groups):
        cfg = self.cfg
        P, M, V = mesh.shape["pp"], self.num_microbatches, self.virtual_stages
        first, last = index == 0, index == P - 1
        loss_fn = get_loss(self.loss)
        want_acc = "accuracy" in self.metrics
        moe, dp = self._moe, mesh.shape.get("dp", 1)
        keys = ["loss"] + (["aux_loss"] if moe else []) + (["accuracy"] if want_acc else [])
        stage_fn = self._stage_fn(per_stage, mesh)
        if self.remat and self.schedule == "gpipe":
            plain = stage_fn

            def stage_fn(chunk, x, *seed):
                return checkpoint(plain, chunk, x, *seed, use_reentrant=False)

        def last_fn(chunk, head, x, labels_mb, seed=None):
            y, stage_aux = stage_fn(chunk, x, seed) if moe else (stage_fn(chunk, x, seed), None)
            logits = self._head_logits(head, y)
            out = (loss_fn(logits, labels_mb) / M,) + ((stage_aux,) if moe else ())
            if want_acc:
                out += (accuracy(logits.detach(), labels_mb) / M,)
            return out if len(out) > 1 else out[0]

        def step(state: TrainState, batch: dict):
            tokens, labels = batch["features"], batch["label"]
            B, S = tokens.shape[0], tokens.shape[1]
            b = B // M
            split, _ = self._split_params(state.params, P, index)
            rest = split["rest"]
            seed = fold_in(state.seed, state.step) if self._dropout else None
            shape = (M, b, S, cfg.hidden_size)
            mb = (self._embed(rest, tokens).reshape(shape) if first
                  else torch.zeros(shape, dtype=cfg.dtype, device=tokens.device))
            names = list(state.params)
            stage_names = [n for n in names if _layer_of(n) is not None]
            rest_names = [n for n in names if _layer_of(n) is None]
            zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
            if self.schedule == "gpipe":
                res = pipeline_apply(stage_fn, split["stages"], mb, mesh, virtual_stages=V,
                                     rng=seed, with_aux=moe, broadcast=False)
                y, aux_sum = res if moe else (res, None)
                # pipeline_apply's aux is the dp mean and its backward hands
                # each dp slice 1/dp of the seed; the stage gradients are
                # averaged over dp after, so the seed is the weight per
                # microbatch times dp.
                aux_seed = self.aux_loss_weight * dp / M
                if last:
                    logits = self._head_logits(rest, y.reshape(B, S, -1))
                    loss = loss_fn(logits, labels)
                    (loss + aux_seed * aux_sum if moe else loss).backward()
                    out = [loss.detach().float()]
                    if moe:
                        out.append(aux_sum.detach() / M)
                    if want_acc:
                        out.append(accuracy(logits.detach(), labels))
                else:
                    roots, seeds = [y], [torch.zeros_like(y)]
                    if moe:
                        roots.append(aux_sum)
                        seeds.append(torch.full_like(aux_sum, aux_seed))
                    torch.autograd.backward(roots, seeds)
                    out = [zero] * len(keys)
            else:
                head = {k: rest[k] for k in HEAD}
                labels_mb = labels.reshape(M, b, *labels.shape[1:])
                res = pipeline_1f1b_value_and_grad(
                    stage_fn, last_fn, split["stages"], head, mb.detach(), labels_mb, mesh,
                    rng=seed, with_aux=want_acc, reduce=False,
                    stage_aux_seed=self.aux_loss_weight / M if moe else None)
                *out, stage_grads, head_grads, cot = res
                if moe:  # the engine's order: loss[, accuracy], moe aux
                    moe_aux = out.pop()
                    out.insert(1, moe_aux / M)
                for p, g in zip(pytree.tree_leaves(split["stages"][0]),
                                pytree.tree_leaves(stage_grads[0])):
                    p.grad = g
                if last:
                    for k in HEAD:
                        rest[k].grad = head_grads[k].to(rest[k].dtype)
                if first:
                    mb.backward(cot.to(mb.dtype))
            metrics = self._reduce(state, stage_names, rest_names, torch.stack(out), groups)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.step += 1
            return state, dict(zip(keys, metrics.unbind()))

        return step

    # -- the mesh, the rows, the whole weights --------------------------------

    def _pipeline_mesh(self) -> Mesh:
        world = process_count()
        mesh = self.mesh
        if mesh is None:
            pp = self.num_stages or world
            ep = self.ep or 1
            dp = world // (pp * ep)
            if dp < 1:
                raise ValueError(f"num_stages {pp} x ep {ep} > {world} attached devices")
            axes = {"pp": pp} if dp == 1 else {"dp": dp, "pp": pp}
            if ep > 1:
                axes["ep"] = ep
            mesh = make_mesh(axes, devices=list(range(dp * pp * ep)))
        elif not isinstance(mesh, Mesh):
            mesh = make_mesh(dict(mesh), devices=list(range(math.prod(dict(mesh).values()))))
        if "pp" not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no 'pp' axis")
        refused = {a: n for a, n in mesh.shape.items() if a not in ("dp", "pp", "ep") and n > 1}
        if refused:
            raise ValueError(f"PipelineTrainer trains over dp, pp and ep; mesh axes {refused} "
                             f"are not supported")
        num_stages = self.num_stages or mesh.shape["pp"]
        if num_stages != mesh.shape["pp"]:
            raise ValueError(f"num_stages {num_stages} != mesh pp axis {mesh.shape['pp']}")
        ep_size = mesh.shape.get("ep", 1)
        if self.ep is not None and self.ep != ep_size:
            raise ValueError(f"ep {self.ep} != mesh ep axis {ep_size}")
        if ep_size > 1:
            E = getattr(self.cfg, "moe_experts", 0)
            if not E:
                raise ValueError("ep > 1 needs an MoE config (moe_experts > 0)")
            if E % ep_size:
                raise ValueError(f"moe_experts {E} not divisible by ep axis {ep_size}")
        if mesh.size != world:
            raise ValueError(
                f"a mesh of {mesh.size} of the process group's {world} ranks: every rank "
                f"trains, so start {mesh.size} rank(s)")
        return mesh

    def _rows(self, mesh: Mesh, coords: dict):
        """This dp slice's rows of a global batch, microbatch by microbatch:
        microbatch ``m`` is rows ``[m·B/M, (m+1)·B/M)`` of the global batch,
        of which dp slice ``k`` takes the ``k``-th contiguous part (the
        reference's ``[M, B/M]`` microbatches with the second axis over dp)."""
        M, dp, k = self.num_microbatches, mesh.shape.get("dp", 1), coords.get("dp", 0)

        def part(v):
            B = v.shape[0]
            if B % M:
                raise ValueError(f"batch {B} not divisible into {M} microbatches")
            if (B // M) % dp:
                raise ValueError(f"microbatch {B // M} rows not divisible over dp={dp}")
            return v.reshape(M, dp, B // (M * dp), *v.shape[1:])[:, k].reshape(
                B // dp, *v.shape[1:])

        return part

    @staticmethod
    def _gather(obj, everyone: bool = True) -> list:
        """Every rank's ``obj`` (on rank 0 alone unless ``everyone``)."""
        dist = torch.distributed
        if process_count() == 1:
            return [obj]
        out = [None] * dist.get_world_size()
        if everyone:
            dist.all_gather_object(out, obj)
        else:
            dist.gather_object(obj, out if dist.get_rank() == 0 else None, dst=0)
        return out

    @staticmethod
    def _join(parts: list[dict], order: list[str]):
        """Every dp-first rank's ``{"ep", "params", "opt"}`` into the whole
        model's ``(params, opt)`` by name: an expert leaf (and each of its
        optimizer tensors of its shape) joined along its expert dimension in
        ep order, any other leaf from the first rank that holds it."""
        params, opt = {}, {}
        parts = sorted(parts, key=lambda p: p["ep"])
        for n in order:
            held = [p for p in parts if n in p["params"]]
            if not held:
                continue
            if len(held) == 1 or not is_expert_leaf(n):
                params[n] = held[0]["params"][n]
                if n in held[0]["opt"]:
                    opt[n] = held[0]["opt"][n]
                continue
            params[n] = torch.cat([p["params"][n] for p in held])
            if n in held[0]["opt"]:
                shape = held[0]["params"][n].shape
                opt[n] = {k: torch.cat([p["opt"][n][k] for p in held]) if v.shape == shape
                          else v for k, v in held[0]["opt"][n].items()}
        return params, opt

    def _layout(self, order: list[str], coords: dict, ep: int):
        """The checkpoint layout: ``(whole, local)``, the rank's state
        gathered into the whole model's (parameters in the model's order,
        optimizer state keyed by that order's index; :meth:`_join`) and a
        whole tree cut back to the rank's parameters and experts."""
        from distkeras_tpu_torch.checkpoint import _state_tree

        index = {n: i for i, n in enumerate(order)}
        e = coords.get("ep", 0)

        def mine(n, v, whole_shape):
            if ep > 1 and is_expert_leaf(n) and v.shape == whole_shape and v.ndim:
                k = v.shape[0] // ep
                return v[e * k:(e + 1) * k]
            return v

        def whole(state):
            tree = _state_tree(state)
            names = list(state.params)
            part = None
            if coords.get("dp", 0) == 0:
                part = {"ep": e, "params": to_host(tree["params"]),
                        "opt": {names[int(i)]: to_host(x) for i, x in tree["opt_state"].items()}}
            parts = [p for p in self._gather(part, everyone=False) if p is not None]
            if not parts:  # not the writer
                return None
            params, opt = self._join(parts, order)
            return {"params": params, "model_state": {},
                    "opt_state": {str(index[n]): x for n, x in opt.items()},
                    "step": tree["step"], "seed": tree["seed"]}

        def local(tree, state):
            opt = tree.get("opt_state", {})
            shapes = {n: tree["params"][n].shape for n in state.params}
            return {"params": {n: mine(n, tree["params"][n], shapes[n]) for n in state.params},
                    "model_state": {},
                    "opt_state": {str(i): {k: mine(n, v, shapes[n])
                                           for k, v in opt[str(index[n])].items()}
                                  for i, n in enumerate(state.params) if str(index[n]) in opt},
                    "step": tree["step"], "seed": tree["seed"]}

        return whole, local

    # -- training ------------------------------------------------------------

    def train(self, dataset: Dataset, shuffle: bool = False) -> TrainedModel:
        """Train ``num_epoch`` epochs of ``batch_size``-row global batches
        (reshuffled each epoch with ``seed`` when ``shuffle``), resuming from
        ``checkpoint_dir`` when asked; returns the whole trained weights on
        every rank."""
        self.record_training_start()
        mesh = self._pipeline_mesh()
        P, dp, ep = mesh.shape["pp"], mesh.shape.get("dp", 1), mesh.shape.get("ep", 1)
        coords = mesh.coords(process_index())
        index, e = coords["pp"], coords.get("ep", 0)
        variables = self.model.init(self.seed, device=self.device)
        order = list(variables)
        split, per_stage = self._split_params(variables, P, index)
        params = {}
        for n in order:
            layer = _layer_of(n)
            keep = layer is None or any(
                layer // per_stage == s for s in rank_stages(P, self.virtual_stages, index))
            if keep:
                v = variables[n]
                if ep > 1 and is_expert_leaf(n):  # this rank's experts
                    k = v.shape[0] // ep
                    v = v[e * k:(e + 1) * k].clone()
                params[n] = v.requires_grad_()
        del variables, split
        if self.schedule == "1f1b":
            if self.virtual_stages != 1:
                raise ValueError(
                    "schedule='1f1b' does not support: virtual_stages > 1 "
                    "(use the gpipe schedule, or remat for memory)"
                )
            extra = [m for m in self.metrics if m not in ("loss", "accuracy")]
            if extra:
                logging.getLogger(__name__).warning(
                    "schedule='1f1b' records loss and accuracy only; "
                    "requested metrics %s will be absent from the history", extra)
        state = TrainState(params, {}, self._optimizer()(list(params.values())), 0,
                           int(self.seed))
        several = process_count() > 1
        world = torch.distributed.group.WORLD if several else None
        # The replicated leaves' sum runs over dp x pp: the ep ranks of one
        # (dp, pp) place hold the same gradients.
        rest = world if ep == 1 else mesh.group(("dp", "pp")) if dp > 1 else mesh.group("pp")
        groups = (rest, mesh.group("dp") if several and dp > 1 else None, dp)
        step = self._audit(self._make_step(mesh, per_stage, index, groups),
                           f"pipeline_step_{self.schedule}")
        ck = _StepCheckpointer(self.checkpoint_dir, self.checkpoint_interval_s, self.resume,
                               like=state, group=world,
                               layout=self._layout(order, coords, ep) if several else None)
        if ck.state is not None:
            state = ck.state
        part = self._rows(mesh, coords)
        batches = ({k: part(v) for k, v in b.items()} for b in minibatches(
            dataset, self.batch_size, self.features_col, self.label_col,
            num_epoch=self.num_epoch, seed=self.seed if shuffle else None,
            start_batch=ck.start_step))
        history = []
        step_no = ck.start_step
        try:
            for batch in DeviceFeed(batches, self.device, buffer_size=2):
                with span("pipeline_step"):
                    state, m = step(state, batch)
                history.append(m)
                step_no += 1
                ck.maybe_save(step_no, state)
            ck.finalize(step_no, state)
        finally:
            ck.close()
        self.history = _read_history(history)
        self._emit_history()
        self.record_training_stop()
        mine = None
        if coords.get("dp", 0) == 0:
            mine = {"ep": e, "params": {k: v.detach().cpu() for k, v in state.params.items()},
                    "opt": {}}
        merged, _ = self._join([p for p in self._gather(mine) if p is not None], order)
        dev = self.device
        return TrainedModel(self.model, {n: merged[n].to(dev) for n in order})
