"""Batch inference: counterpart of ``distkeras_tpu/inference/predictors.py``
``ModelPredictor``, with its ``mesh=`` (the batch split over the ranks of
a process group). The ensemble predictor comes with a later slice."""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.core import TrainedModel, cross_replica_batch_stats
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["Predictor", "ModelPredictor"]


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
    rows back in order, so every rank returns the whole prediction. The
    mesh's other axes hold replicated weights, as the reference's
    predictor keeps them: their ranks run the same rows."""

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
        if mesh is not None:
            if self.batch_size % mesh.shape["dp"]:
                raise ValueError(f"batch_size {self.batch_size} is not divisible by the "
                                 f"mesh's dp={mesh.shape['dp']}")

    @torch.inference_mode()
    def predict(self, dataset: Dataset) -> Dataset:
        x = np.asarray(dataset[self.features_col])
        model, variables = self.trained.model, self.trained.variables
        device = self.trained.device
        outs = []
        bs = self.batch_size
        group = self.mesh.group("dp") if self.mesh is not None else None
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
            if group is None:
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
