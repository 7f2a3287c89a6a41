"""Model abstraction: an ``nn.Module`` specification plus explicit weights.

Counterpart of ``distkeras_tpu/models/core.py``. As there, a :class:`Model`
is a specification and the weights travel beside it: ``variables`` is a
flat ``state_dict`` (name -> tensor), and ``apply(variables, x)`` runs the
module with those weights through ``torch.func.functional_call``. The
module instance the specification holds lives on the ``meta`` device, so it
owns no memory of its own. ``functional_call`` swaps the weights into the
module for the length of the call, so each thread applies its own meta
instance: worker threads of the async trainers (and autograd's recompute
under remat) run the same :class:`Model` at once. :class:`TrainedModel` bundles the two for
inference. ``from_flax``/``from_keras`` are not ported.

:func:`cross_replica_batch_stats` names the process group over which a
model's BatchNorm takes its batch moments while a data-parallel step runs,
so that they are the global batch's, as XLA computes them in the reference;
an MoE layer's routing takes the global batch's seats from it as well.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from collections.abc import Callable

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["Model", "TrainedModel", "batch_stats_group", "cross_replica_batch_stats"]

Variables = dict[str, torch.Tensor]

_BATCH_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "distkeras_tpu_torch_batch_stats_group", default=None)


@contextlib.contextmanager
def cross_replica_batch_stats(group):
    """While this is entered, BatchNorm takes its train-mode moments over
    every rank of ``group`` (None: this rank's batch alone), and an MoE
    layer routes the ranks' rows as one batch
    (:mod:`~distkeras_tpu_torch.ops.moe`)."""
    token = _BATCH_STATS_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_STATS_GROUP.reset(token)


def batch_stats_group():
    """The process group BatchNorm reduces its moments over, or None."""
    return _BATCH_STATS_GROUP.get()


class Model:
    """A model specification.

    ``module_fn()`` builds the ``nn.Module``; a module may define
    ``init_weights(generator)`` to draw its initial weights.
    ``apply(variables, x, train, rng) -> (outputs, new_state)``, where
    ``rng`` is the integer seed of the step's dropout masks; further keyword
    inputs go to the module's forward. A module whose
    forward returns ``(outputs, new_state)`` reports updated buffers there
    (ResNet's BatchNorm statistics in train mode, under their
    ``state_dict`` names); for the others ``new_state`` is empty."""

    def __init__(
        self,
        module_fn: Callable[[], nn.Module],
        name: str = "model",
        input_shape: tuple[int, ...] | None = None,
        output_dim: int | None = None,
        flops_per_example: float | None = None,
    ):
        self.module_fn = module_fn
        self.name = name
        self.input_shape = input_shape
        self.output_dim = output_dim
        # Approximate forward-pass FLOPs per example.
        self.flops_per_example = flops_per_example
        with torch.device("meta"):
            self.module = module_fn()
        self._local = threading.local()
        self._local.module = self.module

    def _thread_module(self) -> nn.Module:
        module = getattr(self._local, "module", None)
        if module is None:
            with torch.device("meta"):
                module = self._local.module = self.module_fn()
        return module

    def init(self, seed: int = 0, device: str | torch.device | None = None) -> Variables:
        """Fresh weights drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (CUDA unless ``"cpu"`` is asked for)."""
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(int(seed))
        with torch.device("meta"):
            module = self.module_fn()
        module = module.to_empty(device=dev)
        with torch.no_grad():
            module.init_weights(generator)
        return {k: v.detach() for k, v in module.state_dict().items()}

    def apply(self, variables: Variables, x, train: bool = False, rng: int | None = None,
              **inputs):
        """``inputs``: further keyword inputs of the module's forward (the
        paged decode's ``positions`` and ``block_tables``, ``return_hidden``)."""
        out = torch.func.functional_call(self._thread_module(), variables, (x,),
                                         {"train": train, "rng": rng, **inputs})
        return out if isinstance(out, tuple) else (out, {})

    def count_params(self) -> int:
        return int(sum(p.numel() for p in self.module.parameters()))


class TrainedModel:
    """Weights + spec: what a trainer returns."""

    def __init__(self, model: Model, variables: Variables):
        self.model = model
        self.variables = variables

    @property
    def params(self) -> Variables:
        return self.variables

    @property
    def device(self) -> torch.device:
        return next(iter(self.variables.values())).device

    def to(self, device: str | torch.device) -> "TrainedModel":
        """The same model with its weights on ``device``."""
        dev = resolve_device(device)
        return TrainedModel(self.model, {k: v.to(dev) for k, v in self.variables.items()})

    @torch.inference_mode()
    def predict(self, x) -> np.ndarray:
        """Forward pass on the device the weights live on."""
        x = torch.as_tensor(np.asarray(x), device=self.device)
        return self.model.apply(self.variables, x, train=False)[0].float().cpu().numpy()

    def save_weights(self, path: str) -> None:
        """Write the weights as the reference's stamped weight file
        (``{"params": ..., "batch_stats": ...}``, each leaf in its dtype),
        atomically; either package loads it."""
        from distkeras_tpu_torch.checkpoint import save_weights_file
        from distkeras_tpu_torch.utils.bridge import params_to_jax

        save_weights_file(path, params_to_jax(self.variables, self.model.module))

    def load_weights(self, path: str) -> None:
        """Load a weight file written by either package onto the device the
        weights live on."""
        from distkeras_tpu_torch.checkpoint import load_weights_file
        from distkeras_tpu_torch.utils.bridge import params_from_jax

        self.variables = params_from_jax(load_weights_file(path), device=self.device)
