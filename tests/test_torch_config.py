"""``TrainerConfig`` against the reference's: the same fields and JSON, and
``build()`` makes this package's trainer with the same accepted-keyword
check (the cases of ``tests/test_config.py`` that need no pipeline
trainer, whose build raises naming ROADMAP item A10)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as dk
from distkeras_tpu.utils.config import TrainerConfig as RefTrainerConfig
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.utils.config import TrainerConfig
from torch_time_limit import time_limited


def _model():
    return Model(lambda: MLP(4, (8,), 2, compute_dtype=torch.float32), input_shape=(4,),
                 output_dim=2)


def test_fields_and_json_match_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(TrainerConfig)
            if f.name != "extra"] == [(f.name, f.default)
                                      for f in dataclasses.fields(RefTrainerConfig)
                                      if f.name != "extra"]
    kwargs = dict(trainer="ADAG", num_workers=4, communication_window=8, extra={"a": 1})
    assert json.loads(TrainerConfig(**kwargs).to_json()) == json.loads(
        RefTrainerConfig(**kwargs).to_json())
    back = TrainerConfig.from_json(RefTrainerConfig(**kwargs).to_json())
    assert back == TrainerConfig(**kwargs)


def test_roundtrip_json():
    cfg = TrainerConfig(trainer="ADAG", num_workers=4, communication_window=8)
    assert TrainerConfig.from_json(cfg.to_json()) == cfg


def test_unknown_trainer_rejected():
    with pytest.raises(ValueError):
        TrainerConfig(trainer="Nope")


@time_limited
def test_build_and_train():
    cfg = TrainerConfig(
        trainer="DOWNPOUR", worker_optimizer="adam", learning_rate=0.01,
        num_workers=2, batch_size=16, num_epoch=2, communication_window=4,
        extra={"device": "cpu"},
    )
    trainer = cfg.build(_model())
    assert isinstance(trainer, dk.DOWNPOUR)
    assert (trainer.num_workers, trainer.communication_window, trainer.batch_size) == (2, 4, 16)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    trainer.train(dk.Dataset.from_arrays(features=x, label=y))
    assert trainer.parameter_server.num_commits > 0


@pytest.mark.parametrize("name", ["SingleTrainer", "EnsembleTrainer", "AveragingTrainer",
                                  "SynchronousDistributedTrainer", "DOWNPOUR", "ADAG", "AEASGD",
                                  "EAMSGD", "DynSGD"])
def test_build_every_trainer(name):
    cfg = TrainerConfig(trainer=name, worker_optimizer="sgd", batch_size=8, seed=3,
                        extra={"device": "cpu"})
    trainer = cfg.build(_model())
    assert type(trainer) is getattr(dk, name)
    assert (trainer.batch_size, trainer.seed, trainer.worker_optimizer) == (8, 3, "sgd")


def test_build_rejects_inapplicable_kwargs():
    cfg = TrainerConfig(trainer="SingleTrainer", num_workers=4)
    with pytest.raises(ValueError, match="num_workers"):
        cfg.build(_model())


def test_build_checkpointing_sync_trainer(tmp_path):
    cfg = TrainerConfig(trainer="SynchronousDistributedTrainer", checkpoint_dir=str(tmp_path),
                        resume=True, num_workers=1, extra={"device": "cpu"})
    trainer = cfg.build(_model())
    assert (trainer.checkpoint_dir, trainer.resume, trainer.num_workers) == (
        str(tmp_path), True, 1)


def test_build_pipeline_trainer_raises():
    with pytest.raises(ValueError, match="A10"):
        TrainerConfig(trainer="PipelineTrainer").build(_model())
