"""The port stands alone: it imports neither JAX (nor flax, optax or
ml_dtypes) nor the reference package, and its entry points run on CUDA
unless asked for the CPU."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import distkeras_tpu_torch
from distkeras_tpu_torch.data.feed import DeviceFeed
from distkeras_tpu_torch.inference.predictors import ModelPredictor
from distkeras_tpu_torch.models.bert import bert_tiny_mlm
from distkeras_tpu_torch.models.core import TrainedModel
from distkeras_tpu_torch.models.mlp import mnist_mlp
from distkeras_tpu_torch.models.resnet import resnet18
from distkeras_tpu_torch.training.trainers import (
    DynSGD,
    EnsembleTrainer,
    SingleTrainer,
    SynchronousDistributedTrainer,
    Trainer,
)
from distkeras_tpu_torch.utils.bridge import params_from_jax
from distkeras_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(distkeras_tpu_torch.__path__,
                                               "distkeras_tpu_torch.")
    )


def test_port_imports_neither_jax_nor_reference():
    mods = _all_modules()
    for m in ("ops.flash_attention", "parallel.protocols", "parallel.ps", "parallel.ha",
              "telemetry.registry", "telemetry.spans", "telemetry.training_health",
              "utils.pytree", "models.mlp", "models.cnn", "data.transformers",
              "ops.launches", "checkpoint", "models.resnet", "utils.config"):
        assert f"distkeras_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'distkeras_tpu', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("entry", ["init", "params_from_jax", "trainer", "predictor",
                                   "single_trainer", "device_feed", "async_trainer",
                                   "mlp_init", "resnet_init", "sync_trainer",
                                   "ensemble_trainer"])
def test_entry_points_raise_without_cuda(entry):
    _no_cuda()
    model = bert_tiny_mlm(seq_len=16, vocab_size=64)
    calls = {
        "init": lambda: model.init(0),
        "params_from_jax": lambda: params_from_jax({"params": {"w": np.zeros(2)}}),
        "trainer": lambda: Trainer(model, loss="fused_categorical_crossentropy"),
        "predictor": lambda: ModelPredictor(TrainedModel(model, model.init(0, device="cpu"))),
        "single_trainer": lambda: SingleTrainer(model, loss="fused_categorical_crossentropy"),
        "device_feed": lambda: DeviceFeed(iter([])),
        "async_trainer": lambda: DynSGD(model, loss="fused_categorical_crossentropy"),
        "mlp_init": lambda: mnist_mlp().init(0),
        "resnet_init": lambda: resnet18(10, 32).init(0),
        "sync_trainer": lambda: SynchronousDistributedTrainer(model),
        "ensemble_trainer": lambda: EnsembleTrainer(model),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
