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
inference. :meth:`Model.from_module` wraps an existing ``nn.Module`` instance
(the counterpart of the reference's ``from_flax``) and
:meth:`Model.from_keras` a Keras 3 model on Keras's torch backend.

:func:`cross_replica_batch_stats` names the process group over which a
model's BatchNorm takes its batch moments while a data-parallel step runs,
so that they are the global batch's, as XLA computes them in the reference;
an MoE layer's routing takes the global batch's seats from it as well.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
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

    # -- wrapping an existing module ------------------------------------------

    @classmethod
    def from_module(
        cls,
        module: nn.Module,
        input_shape: tuple[int, ...],
        name: str | None = None,
        output_dim: int | None = None,
        train_mutable: bool = True,
        flops_per_example: float | None = None,
    ) -> "Model":
        """Wrap an ``nn.Module`` instance (counterpart of the reference's
        ``from_flax``). ``input_shape`` excludes the batch dimension.

        ``init()`` returns copies of the module's current weights (its
        ``state_dict``) on the device asked for; the seed is not used.
        ``apply`` runs ``module(x)`` through ``functional_call`` in train or
        eval mode; in train mode with ``rng`` the module's own random draws
        (``nn.Dropout``) come from a generator seeded with ``rng``. With
        ``train_mutable`` (the reference's ``("batch_stats",)``) a train
        step returns the module's buffers after the call (BatchNorm's
        running statistics) as the new state; the variables passed in are
        never changed."""
        return _ModuleModel(module, name=name or type(module).__name__,
                            input_shape=tuple(input_shape), output_dim=output_dim,
                            train_mutable=train_mutable,
                            flops_per_example=flops_per_example)

    # -- keras 3 integration --------------------------------------------------

    @classmethod
    def from_keras(cls, keras_model, name: str | None = None) -> "Model":
        """Adapt a Keras 3 model on Keras's **torch** backend, so that code
        that builds Keras ``Sequential``s hands them straight to a trainer
        (reference ``distkeras/trainers.py`` § ``Trainer.__init__``).

        The module is a small wrapper whose forward calls
        ``keras_model.stateless_call``: its parameters ``w.<i>`` are the
        model's trainable variables and its buffers ``keras_state.<i>`` the
        non-trainable ones, in Keras's order, so
        :mod:`~distkeras_tpu_torch.utils.bridge` carries them to and from
        the reference's ``{"params": {"w": [...]}, "keras_state": [...]}``.
        ``init()`` returns the Keras model's current weights (the seed is
        not used, as in the reference). Requires ``KERAS_BACKEND=torch``."""
        import keras

        if keras.backend.backend() != "torch":
            raise RuntimeError(
                "Model.from_keras requires the Keras torch backend "
                "(set KERAS_BACKEND=torch before importing keras)"
            )
        input_shape = tuple(keras_model.input_shape[1:]) if keras_model.input_shape else None
        return cls(lambda: _KerasModule(keras_model), name=name or keras_model.name,
                   input_shape=input_shape)


def _keras_tensor(variable) -> torch.Tensor:
    import keras

    return torch.as_tensor(np.asarray(keras.ops.convert_to_numpy(variable.value)))


class _TensorList(nn.Module):
    """Buffers named ``0``, ``1``, ... (a Keras model's non-trainable
    variables)."""

    def __init__(self, tensors):
        super().__init__()
        for i, t in enumerate(tensors):
            self.register_buffer(str(i), t)

    def values(self) -> list[torch.Tensor]:
        return list(self._buffers.values())


class _KerasModule(nn.Module):
    """A Keras 3 model (torch backend) as an ``nn.Module`` of its variables;
    the Keras model itself is held outside the module tree."""

    def __init__(self, keras_model):
        super().__init__()
        object.__setattr__(self, "_keras", keras_model)

        def empty(v):
            return torch.empty(tuple(v.shape), dtype=getattr(torch, str(v.dtype)))

        self.w = nn.ParameterList([nn.Parameter(empty(v))
                                   for v in keras_model.trainable_variables])
        self.keras_state = _TensorList([empty(v) for v in keras_model.non_trainable_variables])

    def init_weights(self, generator) -> None:
        """The Keras model's current weights (``generator`` is not used)."""
        for p, v in zip(self.w, self._keras.trainable_variables):
            p.copy_(_keras_tensor(v))
        for b, v in zip(self.keras_state.values(), self._keras.non_trainable_variables):
            b.copy_(_keras_tensor(v))

    def forward(self, x, train: bool = False, rng: int | None = None):
        out, state = self._keras.stateless_call(list(self.w), self.keras_state.values(), x,
                                                training=train)
        if not train:
            return out
        return out, {f"keras_state.{i}": t for i, t in enumerate(state)}


class _ModuleModel(Model):
    """:meth:`Model.from_module`'s model: an ``nn.Module`` instance, its
    weights kept on the host for ``init()``, a ``meta`` copy of it applied
    with the caller's weights."""

    def __init__(self, module: nn.Module, train_mutable: bool = True, **kwargs):
        self._weights = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
        meta = copy.deepcopy(module).to("meta")
        self.train_mutable = bool(train_mutable)
        super().__init__(lambda: copy.deepcopy(meta), **kwargs)

    def init(self, seed: int = 0, device: str | torch.device | None = None) -> Variables:
        dev = resolve_device(device)
        return {k: v.clone().to(dev) for k, v in self._weights.items()}

    def apply(self, variables: Variables, x, train: bool = False, rng: int | None = None,
              **inputs):
        module = self._thread_module()
        module.train(train)
        buffers = {name for name, _ in module.named_buffers()} if train else set()
        # BatchNorm updates its running statistics in place: on copies.
        variables = {k: (v.clone() if k in buffers else v) for k, v in variables.items()}
        with contextlib.ExitStack() as stack:
            if train and rng is not None:
                devices = ([torch.device(x.device).index or 0] if x.device.type == "cuda"
                           else [])
                stack.enter_context(torch.random.fork_rng(devices=devices))
                torch.manual_seed(int(rng))
            out = torch.func.functional_call(module, variables, (x,), inputs)
        if not (train and self.train_mutable):
            return out, {}
        return out, {k: variables[k] for k in buffers if k in variables}


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
