"""Batch inference: counterpart of ``distkeras_tpu/inference/predictors.py``:
``ModelPredictor``, with its ``mesh=`` (the batch split over the ranks of
a process group), and ``EnsemblePredictor``."""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.bert import with_ring_mesh
from distkeras_tpu_torch.models.core import TrainedModel, cross_replica_batch_stats
from distkeras_tpu_torch.parallel.distributed import process_index
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["Predictor", "ModelPredictor", "EnsemblePredictor"]


class Predictor:
    """Base class."""

    def predict(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Append a ``prediction`` column with the model's (softmax-free) outputs.

    The weights move to ``device`` once (CUDA unless ``"cpu"`` is asked
    for). Every batch runs at ``batch_size`` rows: the last one is padded
    with zero rows and trimmed, as the reference pads to its compiled
    shape.

    With ``mesh`` (a :class:`~distkeras_tpu_torch.parallel.mesh.Mesh` over
    the ranks of a process group; every rank calls :meth:`predict` on the
    same dataset), each batch is split over the mesh's ``dp`` axis, as the
    reference shards it: rank ``r`` runs rows ``[r·b, (r+1)·b)`` of the
    padded batch (``b = batch_size / dp``) and an ``all_gather`` puts the
    rows back in order, so every rank returns the whole prediction. A
    model with ``BertConfig.ring_mesh`` on a mesh with an ``sp`` axis above
    1 runs its attention over that axis (reference ``predictors.py:59-84``,
    through the model's own ``ring_mesh``, whose ``sp`` size must be the
    mesh's): a rank takes its columns of its rows over ``sp`` (striped
    under ``sp_impl="ring_stripe"``), and its logits are gathered over
    ``sp`` in natural token order, then over ``dp``. The mesh's other axes
    hold replicated weights, as the reference's predictor keeps them:
    their ranks run the same rows. An MoE model routes each batch whole,
    as the reference's XLA routes the sharded global batch: its rows over
    dp and its columns over sp in the reference's row-major order
    (:mod:`~distkeras_tpu_torch.ops.moe`)."""

    def __init__(
        self,
        keras_model: TrainedModel,
        features_col: str = "features",
        output_col: str = "prediction",
        batch_size: int = 1024,
        mesh=None,
        device: str | torch.device | None = None,
    ):
        if not isinstance(keras_model, TrainedModel):
            raise TypeError(
                "ModelPredictor expects a TrainedModel (as returned by "
                "Trainer.train)"
            )
        self.trained = keras_model.to(resolve_device(device))
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.mesh = mesh
        self._ring = None
        if mesh is not None:
            dp = mesh.shape.get("dp", 1)
            if self.batch_size % dp:
                raise ValueError(f"batch_size {self.batch_size} is not divisible by the "
                                 f"mesh's dp={dp}")
            cfg = getattr(self.trained.model, "config", None)
            sp = mesh.shape.get("sp", 1)
            if getattr(cfg, "ring_mesh", None) is not None and sp > 1:
                if cfg.ring_mesh.shape[cfg.ring_axis] != sp:
                    raise ValueError(
                        f"the model's ring_mesh has {cfg.ring_axis}="
                        f"{cfg.ring_mesh.shape[cfg.ring_axis]} but the mesh has sp={sp}")
                self._ring = (with_ring_mesh(self.trained.model, mesh),
                              cfg.sp_impl == "ring_stripe")

    @torch.inference_mode()
    def predict(self, dataset: Dataset) -> Dataset:
        x = np.asarray(dataset[self.features_col])
        model, variables = self.trained.model, self.trained.variables
        device = self.trained.device
        outs = []
        bs = self.batch_size
        group = None
        if self.mesh is not None and "dp" in self.mesh.axis_names:
            group = self.mesh.group("dp")
        if group is not None:
            dp = torch.distributed.get_world_size(group)
            share = bs // dp
            r = torch.distributed.get_rank(group)
            mine = slice(r * share, (r + 1) * share)
        for lo in range(0, x.shape[0], bs):
            chunk = x[lo : lo + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            if self._ring is not None:
                # An MoE layer routes the whole batch: its columns over sp
                # (the model's ring), its rows over dp.
                with cross_replica_batch_stats(group):
                    out = self._ring_rows(chunk, variables, device)
                if group is not None:
                    parts = [torch.empty_like(out) for _ in range(dp)]
                    torch.distributed.all_gather(parts, out, group=group)
                    out = torch.cat(parts)
            elif group is None:
                out = model.apply(variables, torch.from_numpy(chunk).to(device), train=False)[0]
            else:
                # An MoE model routes the whole batch across the ranks, as
                # the reference's XLA routes the sharded global batch.
                with cross_replica_batch_stats(group):
                    part = model.apply(variables, torch.from_numpy(chunk[mine]).to(device),
                                       train=False)[0].contiguous()
                parts = [torch.empty_like(part) for _ in range(dp)]
                torch.distributed.all_gather(parts, part, group=group)
                out = torch.cat(parts)
            out = out.cpu().numpy()
            outs.append(out[: bs - pad] if pad else out)
        preds = np.concatenate(outs) if outs else np.zeros((0,))
        return dataset.with_column(self.output_col, preds)

    def _ring_rows(self, chunk: np.ndarray, variables: dict, device) -> torch.Tensor:
        """The ring model's logits of this rank's rows of ``chunk`` ``[bs,
        S]``: its rows over dp and columns over sp through the model, the
        columns gathered back over sp (not yet the rows over dp)."""
        from distkeras_tpu_torch.parallel.gspmd import batch_part, gather_sequence

        model, stripe = self._ring
        mine = batch_part(self.mesh, chunk, process_index(), seq_dim=1, stripe=stripe)
        logits = model.apply(variables, torch.from_numpy(np.ascontiguousarray(mine)).to(device),
                             train=False)[0]
        return gather_sequence(logits.contiguous(), self.mesh, 1, stripe)


class EnsemblePredictor(Predictor):
    """Average the softmax of N trained models (what ``EnsembleTrainer``
    returns) in one pass over their stacked weights: each weight's N
    copies stacked on a leading axis and the model's apply mapped over it
    with ``torch.func.vmap`` (reference ``predictors.py:86-133``), not N
    predicts in turn. Batches run at ``batch_size`` rows, the last padded
    and trimmed, on ``device`` (CUDA unless ``"cpu"`` is asked for)."""

    def __init__(
        self,
        models: list[TrainedModel],
        features_col: str = "features",
        output_col: str = "prediction",
        batch_size: int = 1024,
        device: str | torch.device | None = None,
    ):
        if not models:
            raise ValueError("EnsemblePredictor needs at least one model")
        self.models = models
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self._spec = models[0].model
        self._stacked = {k: torch.stack([m.variables[k].to(self.device) for m in models])
                         for k in models[0].variables}

    @torch.inference_mode()
    def predict(self, dataset: Dataset) -> Dataset:
        spec = self._spec

        def one(variables, x):
            out, _ = spec.apply(variables, x, train=False)
            return torch.softmax(out, dim=-1)

        spec._thread_module()  # built here: a module's init draws no randoms under vmap
        mapped = torch.func.vmap(one, in_dims=(0, None))
        x = np.asarray(dataset[self.features_col])
        outs = []
        bs = self.batch_size
        for lo in range(0, x.shape[0], bs):
            chunk = x[lo : lo + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            out = mapped(self._stacked, torch.from_numpy(chunk).to(self.device)).mean(0)
            out = out.cpu().numpy()
            outs.append(out[: bs - pad] if pad else out)
        preds = np.concatenate(outs) if outs else np.zeros((0,))
        return dataset.with_column(self.output_col, preds)
