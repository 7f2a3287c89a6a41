"""Declarative trainer configuration: counterpart of ``distkeras_tpu/utils/config.py``.

A :class:`TrainerConfig` keeps the trainers' keyword names, serializes to
and from JSON with the reference's fields, and ``build()`` makes the
configured trainer of this package, refusing a keyword the trainer does
not take.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Any

__all__ = ["TrainerConfig"]

_TRAINER_NAMES = (
    "SingleTrainer",
    "EnsembleTrainer",
    "AveragingTrainer",
    "SynchronousDistributedTrainer",
    "PipelineTrainer",
    "DOWNPOUR",
    "ADAG",
    "AEASGD",
    "EAMSGD",
    "DynSGD",
)


@dataclasses.dataclass
class TrainerConfig:
    """Declarative trainer spec; field names mirror the trainer kwargs.
    ``extra`` carries any other keyword (``device="cpu"``, ...)."""

    trainer: str = "SingleTrainer"
    worker_optimizer: str = "adagrad"
    loss: str = "categorical_crossentropy"
    learning_rate: float | None = None
    features_col: str = "features"
    label_col: str = "label"
    batch_size: int = 32
    num_epoch: int = 1
    num_workers: int | None = None
    communication_window: int | None = None
    rho: float | None = None
    momentum: float | None = None
    parallelism_factor: int | None = None
    transport: str | None = None
    checkpoint_dir: str | None = None
    resume: bool | None = None
    seed: int = 0
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.trainer not in _TRAINER_NAMES:
            raise ValueError(f"unknown trainer {self.trainer!r}; known: {_TRAINER_NAMES}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, data: str) -> "TrainerConfig":
        return cls(**json.loads(data))

    def build(self, model):
        """Instantiate the configured trainer for ``model``."""
        import distkeras_tpu_torch as dk

        cls = getattr(dk, self.trainer)
        kwargs: dict[str, Any] = {
            "worker_optimizer": self.worker_optimizer,
            "loss": self.loss,
            "features_col": self.features_col,
            "label_col": self.label_col,
            "batch_size": self.batch_size,
            "num_epoch": self.num_epoch,
            "seed": self.seed,
        }
        if self.learning_rate is not None:
            kwargs["learning_rate"] = self.learning_rate
        optional = {
            "num_workers": self.num_workers,
            "communication_window": self.communication_window,
            "rho": self.rho,
            "momentum": self.momentum,
            "parallelism_factor": self.parallelism_factor,
            "transport": self.transport,
            "checkpoint_dir": self.checkpoint_dir,
            "resume": self.resume,
        }
        kwargs.update({k: v for k, v in optional.items() if v is not None})
        kwargs.update(self.extra)
        accepted = set()
        for klass in cls.__mro__:
            if klass is not object:
                accepted |= set(inspect.signature(klass.__init__).parameters)
        unknown = [k for k in kwargs if k not in accepted]
        if unknown:
            raise ValueError(f"{self.trainer} does not accept {unknown}; accepted: "
                             f"{sorted(accepted - {'self'})}")
        return cls(model, **kwargs)
