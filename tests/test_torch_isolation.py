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
from distkeras_tpu_torch.deploy.harness import make_score_fn
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
              "serving.engine", "serving.wire", "serving.server", "serving.client",
              "serving.constraints", "ops.attention", "serving.kv_transfer",
              "serving.kv_tier", "serving.slo", "serving.debugz", "serving.cluster",
              "serving.cluster.replicas", "serving.cluster.supervisor",
              "serving.cluster.router", "telemetry.timeseries", "telemetry.device",
              "deploy", "deploy.publisher", "deploy.controller", "deploy.harness", "run"):
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
    the port imports, and the serving engine runs a request on the CPU,
    dense and paged (constrained, speculative)."""
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'distkeras_tpu'):\n"
        "    sys.modules[m] = None  # any import of it now raises ImportError\n"
        f"for m in {_all_modules()!r}: importlib.import_module(m)\n"
        "import asyncio\n"
        "from distkeras_tpu_torch import ServingEngine, gpt_tiny\n"
        "lm = gpt_tiny(seq_len=16, vocab_size=64)\n"
        "eng = ServingEngine(lm, lm.init(0, device='cpu'), slots=2, device='cpu')\n"
        "async def go(eng, **kw):\n"
        "    task = asyncio.create_task(eng.run())\n"
        "    req = eng.submit([1, 2, 3], 4, **kw)\n"
        "    out = await req.result()\n"
        "    eng.shutdown(); await task\n"
        "    return out\n"
        "print('TOKENS', len(asyncio.run(go(eng))))\n"
        "w = lm.init(0, device='cpu')\n"
        "paged = ServingEngine(lm, w, slots=2, kv_pool_blocks=16, kv_block_tokens=4,\n"
        "                      constrained=True, draft_model=lm, draft_variables=w,\n"
        "                      device='cpu')\n"
        "dfa = {'start': 0, 'edges': [[0, 5, 1], [1, 6, 0]]}\n"
        "print('PAGED', asyncio.run(go(paged, constraint=dfa)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TOKENS 4" in proc.stdout
    assert "PAGED [5, 6, 5, 6]" in proc.stdout


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
                                   "generator", "serving_engine", "prefix_cache",
                                   "paged_engine", "tiered_engine", "score_fn"])
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
        "paged_engine": lambda: ServingEngine(gpt, gpt_weights, slots=2, kv_pool_blocks=8),
        "tiered_engine": lambda: ServingEngine(gpt, gpt_weights, slots=2, kv_pool_blocks=8,
                                               kv_host_tier_mb=1.0),
        "score_fn": lambda: make_score_fn(gpt, 64),
        "prefix_cache": lambda: PrefixCache(decode_cache(
            dataclasses.replace(gpt.config, decode=True, decode_slots=True), 1, "meta"),
            block_tokens=4, budget_bytes=1 << 16),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


BLOCKED_CHILD = (
    "import sys\n"
    "for m in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'distkeras_tpu'):\n"
    "    sys.modules[m] = None\n"
    "from distkeras_tpu_torch.run import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)


@pytest.mark.parametrize("sub", ["serve", "cluster", "deploy"])
def test_cli_and_replica_child_refuse_without_cuda(sub, tmp_path):
    """``run.py`` and a replica child (``run serve``, what ``ProcessReplica``
    spawns) exit naming the missing device unless ``--device cpu`` is given,
    with JAX and the reference unimportable."""
    _no_cuda()
    argv = [sub, "--port", "0", "--model", "gpt_tiny"]
    if sub == "deploy":
        argv += ["--watch-dir", str(tmp_path)]
    proc = subprocess.run([sys.executable, "-c", BLOCKED_CHILD, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
    assert "--device" in proc.stderr
