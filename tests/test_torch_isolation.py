"""The port stands alone: it imports neither JAX (nor flax, optax or
ml_dtypes) nor the reference package, nor grpc until a gRPC transport is
built, and its entry points run on CUDA unless asked for the CPU. Every
module imports with ``jax`` and ``distkeras_tpu`` made unimportable, and no
source file of the port names the reference package in an import."""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import distkeras_tpu_torch
from distkeras_tpu_torch.data.feed import DeviceFeed
from distkeras_tpu_torch.inference.generate import Generator, beam_search, generate
from distkeras_tpu_torch.inference.predictors import ModelPredictor
from distkeras_tpu_torch.models.bert import bert_tiny_mlm, decode_cache, gpt_tiny
from distkeras_tpu_torch.models.core import TrainedModel
from distkeras_tpu_torch.models.mlp import mnist_mlp
from distkeras_tpu_torch.models.resnet import resnet18
from distkeras_tpu_torch.serving import PrefixCache, ServingEngine
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
              "ops.launches", "checkpoint", "models.resnet", "utils.config",
              "parallel.ps_grpc", "inference.generate", "tracing",
              "telemetry.recompile", "telemetry.request_trace", "telemetry.wide_events",
              "telemetry.flight_recorder", "telemetry.exposition", "serving",
              "serving.scheduler", "serving.metrics", "serving.prefix_cache",
              "serving.engine", "serving.wire", "serving.server", "serving.client"):
        assert f"distkeras_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'distkeras_tpu', 'triton', 'grpc'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_imports_with_jax_and_the_reference_blocked():
    """With ``jax`` and ``distkeras_tpu`` unimportable, every module of
    the port imports, and the serving engine runs a request on the CPU."""
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'distkeras_tpu'):\n"
        "    sys.modules[m] = None  # any import of it now raises ImportError\n"
        f"for m in {_all_modules()!r}: importlib.import_module(m)\n"
        "import asyncio\n"
        "from distkeras_tpu_torch import ServingEngine, gpt_tiny\n"
        "lm = gpt_tiny(seq_len=16, vocab_size=64)\n"
        "eng = ServingEngine(lm, lm.init(0, device='cpu'), slots=2, device='cpu')\n"
        "async def go():\n"
        "    task = asyncio.create_task(eng.run())\n"
        "    out = await eng.submit([1, 2, 3], 4).result()\n"
        "    eng.shutdown(); await task\n"
        "    return out\n"
        "print('TOKENS', len(asyncio.run(go())))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TOKENS 4" in proc.stdout


def test_no_port_source_imports_the_reference():
    pkg = os.path.join(REPO, "distkeras_tpu_torch")
    bad = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            for i, line in enumerate(open(path, encoding="utf-8"), 1):
                words = line.split()
                if (len(words) >= 2 and words[0] in ("import", "from")
                        and words[1].split(".")[0] in ("distkeras_tpu", "jax", "jaxlib")):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not bad, bad


BLOCKED_GRPC = (
    "import sys\n"
    "sys.modules['grpc'] = None  # any import of grpc now raises ImportError\n"
    "import distkeras_tpu_torch, distkeras_tpu_torch.inference.generate\n"
    "import distkeras_tpu_torch.parallel.ps_grpc\n"
    "from distkeras_tpu_torch.models.mlp import mnist_mlp\n"
    "try:\n"
    "    distkeras_tpu_torch.ADAG(mnist_mlp(), transport='grpc', device='cpu')\n"
    "except ImportError as e:\n"
    "    print('REFUSED', e)\n"
)


def test_port_imports_without_grpc():
    """With grpc unimportable, the package, ``inference.generate`` and
    ``parallel.ps_grpc`` import, and ``transport="grpc"`` raises an
    ImportError that names grpcio (no quiet fall back to ``inprocess``)."""
    proc = subprocess.run([sys.executable, "-c", BLOCKED_GRPC], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "REFUSED" in proc.stdout and "grpcio" in proc.stdout, proc.stdout


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
                                   "ensemble_trainer", "generate", "beam_search",
                                   "generator", "serving_engine", "prefix_cache"])
def test_entry_points_raise_without_cuda(entry):
    _no_cuda()
    model = bert_tiny_mlm(seq_len=16, vocab_size=64)
    gpt = gpt_tiny(seq_len=16, vocab_size=64)
    gpt_weights, prompt = gpt.init(0, device="cpu"), np.zeros((1, 4), np.int32)
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
        "generate": lambda: generate(gpt, gpt_weights, prompt, 2),
        "beam_search": lambda: beam_search(gpt, gpt_weights, prompt, 2),
        "generator": lambda: Generator(gpt, gpt_weights),
        "serving_engine": lambda: ServingEngine(gpt, gpt_weights, slots=2),
        "prefix_cache": lambda: PrefixCache(decode_cache(
            dataclasses.replace(gpt.config, decode=True, decode_slots=True), 1, "meta"),
            block_tokens=4, budget_bytes=1 << 16),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
