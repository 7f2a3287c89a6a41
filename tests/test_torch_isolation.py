"""The port stands alone: it imports neither JAX (nor flax, optax or
ml_dtypes) nor the reference package, nor grpc until a gRPC transport is
built, nor keras or kafka until ``Model.from_keras`` or a ``KafkaSource``
needs them, and its entry points run on CUDA unless asked for the CPU.
Every module imports with ``jax``, ``distkeras_tpu``, ``keras`` and
``kafka`` made unimportable, importing builds and loads no kernel
library, and no source file of the port names the reference package in an
import."""

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
from distkeras_tpu_torch.data.streaming import StreamingPredictor
from distkeras_tpu_torch.deploy.harness import make_score_fn
from distkeras_tpu_torch.inference.generate import Generator, beam_search, generate
from distkeras_tpu_torch.inference.predictors import ModelPredictor
from distkeras_tpu_torch.models.bert import bert_tiny_mlm, decode_cache, gpt_tiny, with_ring_mesh
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.models.mlp import mnist_mlp
from distkeras_tpu_torch.models.resnet import resnet18
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.parallel import distributed, gspmd
from distkeras_tpu_torch.parallel.mesh import make_mesh
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
              "deploy", "deploy.publisher", "deploy.controller", "deploy.harness", "run",
              "parallel.distributed", "parallel.mesh", "parallel.sharding",
              "parallel.gspmd", "ops.ring_flash", "ops.ulysses", "parallel.pipeline",
              "parallel.pipeline_1f1b", "training.pipeline_trainer", "parallel.pp",
              "serving.sharded", "models.bert", "serving.metrics", "data", "data.sparse",
              "data.native", "data.streaming", "deployment"):
        assert f"distkeras_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'distkeras_tpu', 'triton', 'grpc',"
        " 'keras', 'kafka'))\n"
        "from distkeras_tpu_torch.utils import build\n"
        "bad += [f'lib{n}.so' for n in build._loaded]  # importing builds and loads no kernel\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_imports_with_jax_and_the_reference_blocked():
    """With ``jax`` and ``distkeras_tpu`` unimportable, every module of
    the port imports, the serving engine runs a request on the CPU, dense
    and paged (constrained, speculative), the sync trainer takes a
    sequence-parallel step under each ``sp_impl`` (an sp mesh of one rank),
    and the pipeline trainer a step under each schedule (a pipe of one
    stage, dropout on)."""
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'distkeras_tpu', 'keras', 'kafka'):\n"
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
        "import dataclasses, numpy as np\n"
        "from distkeras_tpu_torch import Dataset, SynchronousDistributedTrainer\n"
        "from distkeras_tpu_torch.models.bert import _make\n"
        "from distkeras_tpu_torch.parallel.mesh import make_mesh\n"
        "for impl in ('ring', 'ring_stripe', 'ulysses'):\n"
        "    cfg = dataclasses.replace(lm.config, ring_mesh=make_mesh({'sp': 1}), sp_impl=impl)\n"
        "    sp = _make(cfg, 16, 'gpt_tiny')\n"
        "    ids = np.zeros((4, 16), np.int32)\n"
        "    tr = SynchronousDistributedTrainer(sp, loss='fused_categorical_crossentropy',\n"
        "        batch_size=4, mesh={'sp': 1}, shard_sequence=True, device='cpu')\n"
        "    tr.train(Dataset.from_arrays(features=ids, label=ids))\n"
        "    print('SP', impl, len(tr.history))\n"
        "from distkeras_tpu_torch import PipelineTrainer, bert_tiny_mlm\n"
        "bt = bert_tiny_mlm(seq_len=16, vocab_size=64, dropout_rate=0.1)\n"
        "for sched in ('gpipe', '1f1b'):\n"
        "    tr = PipelineTrainer(bt, loss='fused_categorical_crossentropy', batch_size=4,\n"
        "        num_microbatches=2, schedule=sched, device='cpu')\n"
        "    tr.train(Dataset.from_arrays(features=ids, label=ids))\n"
        "    print('PP', sched, len(tr.history))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TOKENS 4" in proc.stdout
    assert "PAGED [5, 6, 5, 6]" in proc.stdout
    assert all(f"SP {impl} 1" in proc.stdout for impl in ("ring", "ring_stripe", "ulysses"))
    assert all(f"PP {sched} 1" in proc.stdout for sched in ("gpipe", "1f1b"))


A11_BLOCKED = (
    "import sys\n"
    "for m in ('jax', 'jaxlib', 'flax', 'optax', 'distkeras_tpu', 'keras', 'kafka'):\n"
    "    sys.modules[m] = None\n"
    "import numpy as np\n"
    "from distkeras_tpu_torch.data import Dataset, DenseTransformer, SparseColumn, native\n"
    "from distkeras_tpu_torch.data.streaming import GeneratorSource, KafkaSource, StreamingPredictor\n"
    "from distkeras_tpu_torch import TrainedModel, tracing\n"
    "from distkeras_tpu_torch.deployment import Job\n"
    "from distkeras_tpu_torch.models.core import Model\n"
    "from distkeras_tpu_torch.models.mlp import mnist_mlp\n"
    "ds = Dataset.from_arrays(features=SparseColumn.from_dense(np.eye(4, dtype=np.float32)))\n"
    "print('DENSE', DenseTransformer('features', 'd').transform(ds)['d'].shape)\n"
    "m = mnist_mlp()\n"
    "p = StreamingPredictor(TrainedModel(m, m.init(0, device='cpu')), max_batch=4)\n"
    "print('ROWS', p.run(GeneratorSource([np.zeros((6, 784), np.float32)]), lambda x, y: None)['rows'])\n"
    "print('PEAK', tracing.device_peak_flops('cpu'))\n"
    "for f in (lambda: KafkaSource('t'), lambda: Model.from_keras(object())):\n"
    "    try:\n"
    "        f()\n"
    "    except ImportError as e:\n"
    "        print('REFUSED', e)\n"
)


def test_a11_surface_without_keras_kafka_or_jax():
    """Sparse columns, the streaming predictor, the tracing helpers and the
    deployment module work with keras, kafka and JAX unimportable; a
    KafkaSource and Model.from_keras refuse with ImportError."""
    proc = subprocess.run([sys.executable, "-c", A11_BLOCKED], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DENSE (4, 4)" in proc.stdout and "ROWS 6" in proc.stdout
    assert "PEAK None" in proc.stdout
    assert proc.stdout.count("REFUSED") == 2 and "kafka-python" in proc.stdout, proc.stdout


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


def _example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"isolation_example_{name}", os.path.join(REPO, "examples", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
                                   "paged_engine", "tiered_engine", "score_fn",
                                   "initialize", "sharded_train_state", "place_sharded",
                                   "sp_trainer", "pipeline_trainer", "streaming_predictor",
                                   "module_init", "example_main"])
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
        # NCCL unless gloo is named: no CUDA device, no quiet switch to gloo
        "initialize": lambda: distributed.initialize("localhost:1", 2, 0),
        "sharded_train_state": lambda: gspmd.sharded_train_state(
            model, get_optimizer("adam"), make_mesh(devices=[0])),
        "place_sharded": lambda: gspmd.place_sharded({"w": np.zeros(2)}, None),
        "sp_trainer": lambda: SynchronousDistributedTrainer(
            with_ring_mesh(gpt, make_mesh({"sp": 1}, devices=[0])), mesh={"sp": 1},
            shard_sequence=True),
        "pipeline_trainer": lambda: distkeras_tpu_torch.PipelineTrainer(model),
        "streaming_predictor": lambda: StreamingPredictor(TrainedModel(model, model.init(0))),
        "module_init": lambda: Model.from_module(torch.nn.Linear(2, 2), (2,)).init(0),
        "example_main": lambda: _example("streaming_inference").main(["--batches", "1"]),
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
