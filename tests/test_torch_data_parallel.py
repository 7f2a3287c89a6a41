"""The port's data-parallel ``SynchronousDistributedTrainer`` over two gloo
ranks on the CPU, against the reference's ``num_workers=2`` run on 2 of its
8 virtual devices.

One spawn for the module: two ``tests/torch_dp_worker.py`` processes join
a gloo process group through a file store under the module's ``tmp_path``
(no port, so xdist workers cannot collide) and run every scenario in turn:
``bert_tiny_mlm`` with the fused loss (adagrad) with and without zero1;
the MLP (adam) with and without zero1; resnet18 at 32x32 (BatchNorm's
moments over both ranks); A/B/C checkpoint runs (B saves at dp=2, C
resumes it at dp=2), with and without zero1; ``ModelPredictor(mesh=)``;
a mesh's process groups; ``num_workers`` above the world size. Every model starts from the
reference's init for seed 0, bridged across; float32, dropout 0.

Tolerances, as ``tests/test_torch_training.py`` and
``tests/test_torch_resnet.py`` state theirs: each step's loss to 1e-5
relative and its accuracy to 1e-6; bert's and the MLP's weights to 2e-6
absolute (float32 rounding in another order over a few steps, the
gradients here averaged over two ranks where XLA reduces them in one
program); resnet18's weights and running statistics after two steps to
1e-4 of each tensor's largest magnitude (a float32 step at batch 16, as
``test_torch_resnet.py`` holds one). zero1 and the plain optimizer, two
runs, agree to the same tolerances: the CPU's matrix products may round
differently from one allocation to the next, by an ulp that the steps
carry on. The two ranks end on identical weights (they apply the same
all-reduced gradients), and the MLP resumed equals the MLP uninterrupted
bitwise, as ``tests/test_torch_checkpoint.py`` holds one rank's. The mesh
predictor equals the plain one to 1e-6 and the reference's to 1e-4.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
import distkeras_tpu_torch as dk
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.models import resnet as ref_resnet
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.core import TrainedModel as RefTrainedModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu.parallel.mesh import best_mesh as ref_best_mesh
from distkeras_tpu_torch.ops.losses import NesterovTrace, get_optimizer, optimizer_spec
from distkeras_tpu_torch.parallel.protocols import EAMSGDProtocol
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_dp_worker import MODELS, with_weights
from torch_time_limit import time_limited

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
WORLD = 2
LOSS_RTOL, ACC_ATOL, WEIGHT_ATOL, RESNET_RTOL = 1e-5, 1e-6, 2e-6, 1e-4
PRED_ATOL, PRED_REF_ATOL = 1e-6, 1e-4

BERT = {"name": "bert_tiny_mlm", "seq": 32, "vocab": 256}
MLP_CFG = {"dim": 16}
RESNET = {"classes": 10, "size": 32}
BERT_KW = dict(loss="fused_categorical_crossentropy", batch_size=4, num_epoch=1, seed=0)
MLP_KW = dict(worker_optimizer="adam", learning_rate=1e-2, batch_size=16, num_epoch=2, seed=0)
RESNET_KW = dict(loss="sparse_categorical_crossentropy", batch_size=8, num_epoch=1, seed=0)


def _ref_model(kind):
    if kind == "bert":
        base = getattr(ref_bert, BERT["name"])(seq_len=BERT["seq"], vocab_size=BERT["vocab"])
        return ref_bert._make(dataclasses.replace(
            base.config, use_flash_attention=True, dtype=jnp.float32, dropout_rate=0.0),
            BERT["seq"], BERT["name"])
    if kind == "mlp":
        return RefModel.from_flax(RefMLP(features=(32,), num_classes=2, compute_dtype=jnp.float32),
                                  input_shape=(MLP_CFG["dim"],), output_dim=2)
    return RefModel.from_flax(
        ref_resnet.ResNet(stage_sizes=(2, 2, 2, 2), block_cls=ref_resnet.BasicBlock,
                          num_classes=RESNET["classes"], dtype=jnp.float32),
        input_shape=(RESNET["size"], RESNET["size"], 3))


def _bridge(variables) -> dict:
    tree = jax.tree.map(np.asarray, variables)
    return {k: v.numpy() for k, v in params_from_jax(tree, device="cpu").items()}


def _init(kind) -> dict:
    """The reference's init for seed 0 (``TrainState.create``'s key), bridged:
    parameters, and resnet's running statistics."""
    variables = _ref_model(kind).init(jax.random.split(jax.random.PRNGKey(0))[0])
    return _bridge(variables if kind == "resnet" else variables["params"])


def _data(kind) -> dict:
    rng = np.random.default_rng({"bert": 1, "mlp": 2, "resnet": 3}[kind])
    if kind == "bert":
        shape = (3 * WORLD * BERT_KW["batch_size"], BERT["seq"])
        return {"features": rng.integers(0, BERT["vocab"], size=shape).astype(np.int32),
                "label": rng.integers(0, BERT["vocab"], size=shape).astype(np.int32)}
    if kind == "mlp":
        x = rng.normal(size=(128, MLP_CFG["dim"])).astype(np.float32)
        return {"features": x,
                "label": (x @ rng.normal(size=(MLP_CFG["dim"],)) > 0).astype(np.float32)}
    n = 2 * WORLD * RESNET_KW["batch_size"]
    return {"features": rng.normal(size=(n, RESNET["size"], RESNET["size"], 3)).astype(np.float32),
            "label": rng.integers(0, RESNET["classes"], size=(n,)).astype(np.int32)}


CONFIGS = {"bert": BERT, "mlp": MLP_CFG, "resnet": RESNET}
KWARGS = {"bert": BERT_KW, "mlp": MLP_KW, "resnet": RESNET_KW}
SHUFFLE = {"bert": False, "mlp": True, "resnet": False}
# scenario -> (model, extra trainer arguments)
TRAIN = {
    "bert": ("bert", {}),
    "bert_zero1": ("bert", {"zero1": True}),
    "mlp": ("mlp", {}),
    "mlp_zero1": ("mlp", {"zero1": True}),
    "resnet": ("resnet", {}),
    "ckpt_b": ("mlp", {"num_epoch": 1, "checkpoint_dir": "ck_plain"}),
    "ckpt_c": ("mlp", {"checkpoint_dir": "ck_plain", "resume": True}),
    "ckpt_zero1_b": ("mlp", {"num_epoch": 1, "checkpoint_dir": "ck_zero1", "zero1": True}),
    "ckpt_zero1_c": ("mlp", {"checkpoint_dir": "ck_zero1", "resume": True, "zero1": True}),
    "ckpt_timed": ("mlp", {"num_epoch": 5, "checkpoint_dir": "ck_timed",
                           "checkpoint_interval_s": 0.0}),
    "ckpt_zero1_timed": ("mlp", {"num_epoch": 5, "checkpoint_dir": "ck_zero1_timed",
                                 "checkpoint_interval_s": 0.0, "zero1": True}),
}


def _scenarios(inits, data) -> dict:
    out = {}
    for name, (kind, extra) in TRAIN.items():
        out[name] = {"kind": "train", "model": kind, "config": CONFIGS[kind],
                     "weights": inits[kind], "data": data[kind],
                     "kwargs": {**KWARGS[kind], **extra}, "shuffle": SHUFFLE[kind]}
    out["predict"] = {"kind": "predict", "model": "bert", "config": BERT,
                      "weights": inits["bert"], "features": data["bert"]["features"][:10],
                      "batch_size": 4}
    out["groups"] = {"kind": "groups"}
    out["too_many_workers"] = {"kind": "refuse", "model": "mlp", "config": MLP_CFG,
                               "weights": inits["mlp"], "data": data["mlp"],
                               "kwargs": {"num_workers": WORLD + 1}}
    return out


@time_limited(timeout=300)
def _spawn_ranks(workdir: str) -> list[dict]:
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, WORKER, workdir, str(r), str(WORLD)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=280)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    results = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"result-{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("dp"))
    kinds = ("bert", "mlp", "resnet")
    inits = {k: _init(k) for k in kinds}
    data = {k: _data(k) for k in kinds}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(_scenarios(inits, data), f)
    return {"ranks": _spawn_ranks(workdir), "inits": inits, "data": data}


@pytest.fixture(scope="module")
def reference(runs):
    """The reference's SynchronousDistributedTrainer(num_workers=2) per
    scenario that has a reference counterpart: (history, final variables
    bridged to the port's names)."""
    cache = {}

    def get(name):
        if name not in cache:
            kind, extra = TRAIN[name]
            tr = ref.SynchronousDistributedTrainer(_ref_model(kind), num_workers=WORLD,
                                                   **{**KWARGS[kind], **extra})
            trained = tr.train(ref.Dataset(runs["data"][kind]), shuffle=SHUFFLE[kind])
            v = trained.variables
            cache[name] = (tr.history, _bridge(v if kind == "resnet" else v["params"]))
        return cache[name]

    return get


def _assert_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "accuracy"}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        assert g["accuracy"] == pytest.approx(w["accuracy"], abs=ACC_ATOL)


def _assert_weights(got, want, kind):
    assert got.keys() == want.keys()
    for k in want:
        if kind == "resnet":
            atol = RESNET_RTOL * max(float(np.abs(want[k]).max()), 1e-6)
        else:
            atol = WEIGHT_ATOL
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def test_every_rank_joined_the_group(runs):
    assert [(r["world"], r["rank"]) for r in runs["ranks"]] == [(WORLD, 0), (WORLD, 1)]
    assert not any("failure" in r for r in runs["ranks"])


@pytest.mark.parametrize("name", ["bert", "bert_zero1", "mlp", "mlp_zero1", "resnet"])
def test_dp2_matches_reference(runs, reference, name):
    """Per-step loss and accuracy (the global batch's, on each rank) and the
    final weights, resnet's running statistics included."""
    want_history, want_weights = reference(name)
    kind = TRAIN[name][0]
    for got in runs["ranks"]:
        _assert_history(got[name]["history"], want_history)
        _assert_weights(got[name]["weights"], want_weights, kind)
    if kind == "resnet":
        stats = [k for k in want_weights if k.endswith((".mean", ".var"))]
        assert len(stats) == 2 * 20
        moved = [k for k in stats
                 if not np.array_equal(want_weights[k], runs["inits"]["resnet"][k])]
        assert len(moved) == len(stats)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_ranks_end_on_the_same_weights(runs, name):
    r0, r1 = (r[name] for r in runs["ranks"])
    assert r0["history"] == r1["history"]
    for k in r0["weights"]:
        np.testing.assert_array_equal(r0["weights"][k], r1["weights"][k], err_msg=k)


@pytest.mark.parametrize("kind", ["bert", "mlp"])
def test_zero1_equals_the_plain_optimizer(runs, kind):
    got, want = runs["ranks"][0][f"{kind}_zero1"], runs["ranks"][0][kind]
    _assert_history(got["history"], want["history"])
    _assert_weights(got["weights"], want["weights"], kind)


@pytest.mark.parametrize("variant", ["ckpt", "ckpt_zero1"])
def test_dp2_resume_matches_uninterrupted(runs, variant):
    """A (the 2-epoch MLP run) against B (1 epoch, saved at dp=2) resumed by
    C for 2 epochs at dp=2: C's steps are A's last ones, bitwise. Rank 0
    alone wrote; under zero1 the shards were gathered to it."""
    full = runs["ranks"][0]["mlp_zero1" if "zero1" in variant else "mlp"]
    for rank in runs["ranks"]:
        b, c = rank[f"{variant}_b"], rank[f"{variant}_c"]
        assert len(b["history"]) + len(c["history"]) == len(full["history"]) == 8
        assert c["history"] == full["history"][len(b["history"]):]
        for k in full["weights"]:
            np.testing.assert_array_equal(c["weights"][k], full["weights"][k], err_msg=k)


@pytest.mark.parametrize("variant, want", [("ckpt_timed", [18, 19, 20]),
                                           ("ckpt_zero1_timed", [16, 20])])
def test_timed_saves_at_dp2(runs, variant, want):
    """20 steps with a save due after every one (the newest 3 kept): the
    plain optimizer saves each step; zero1's ranks take rank 0's decision
    every 16 steps, so they save at step 16 and at the end."""
    for rank in runs["ranks"]:
        assert len(rank[variant]["history"]) == 20
        assert rank[variant]["saved_steps"] == want


@pytest.mark.parametrize("kind", ["bert", "mlp", "resnet"])
def test_dp2_equals_dp1_on_the_doubled_batch(runs, kind):
    """The port at dp=2 against the port alone (no process group) at twice
    the batch: the same global batches, one rank."""
    model = with_weights(MODELS[kind](CONFIGS[kind]), runs["inits"][kind])
    kwargs = {**KWARGS[kind], "batch_size": WORLD * KWARGS[kind]["batch_size"]}
    tr = dk.SynchronousDistributedTrainer(model, num_workers=1, device="cpu", **kwargs)
    trained = tr.train(dk.Dataset.from_arrays(**runs["data"][kind]), shuffle=SHUFFLE[kind])
    got = runs["ranks"][0][kind]
    _assert_history(got["history"], tr.history)
    _assert_weights(got["weights"], {k: v.numpy() for k, v in trained.variables.items()}, kind)


def test_mesh_predictor_equals_the_plain_one_and_the_reference(runs):
    """10 rows in batches of 4 (the last padded), each batch split 2 + 2 over
    the ranks and gathered back in order, on every rank."""
    x = runs["data"]["bert"]["features"][:10]
    model = _ref_model("bert")
    params = model.init(jax.random.split(jax.random.PRNGKey(0))[0])
    want = np.asarray(ref.ModelPredictor(RefTrainedModel(model, params), batch_size=4,
                                         mesh=ref_best_mesh(WORLD)).predict(
        ref.Dataset({"features": x}))["prediction"])
    for rank in runs["ranks"]:
        got = rank["predict"]
        assert got["mesh"].shape == got["plain"].shape == want.shape == (10, 32, 256)
        np.testing.assert_allclose(got["mesh"], got["plain"], atol=PRED_ATOL, rtol=0)
        np.testing.assert_allclose(got["mesh"], want, atol=PRED_REF_ATOL, rtol=0)


def test_mesh_groups(runs):
    """An axis over every rank is the default group; a smaller one is this
    rank's group of the mesh's DeviceMesh."""
    for r, rank in enumerate(runs["ranks"]):
        got = rank["groups"]
        assert got["device_mesh"] == [[0], [1]]
        assert got["dp"] == [WORLD, 3.0]
        assert got["tp"] == [1, r + 1.0]


def test_num_workers_above_the_world_size_raises(runs):
    model = _ref_model("mlp")
    with pytest.raises(ValueError) as e:
        ref.SynchronousDistributedTrainer(model, num_workers=9).train(
            ref.Dataset(runs["data"]["mlp"]))
    assert "requested 9 devices but only 8 are attached" in str(e.value)
    for rank in runs["ranks"]:
        assert rank["too_many_workers"]["error"] == (
            f"requested {WORLD + 1} devices but only {WORLD} are attached; reduce "
            f"num_workers or run on more chips")


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw", "adagrad", "adadelta",
                                  "rmsprop", "eamsgd"])
def test_optimizer_spec_rebuilds_every_factory(name):
    """zero1 builds each rank's shard from the factory's class and keyword
    arguments: they rebuild an optimizer that steps as the factory's does
    (optax's adagrad and rmsprop, EAMSGD's Nesterov trace included)."""
    factory = (EAMSGDProtocol().local_optimizer(get_optimizer("sgd", 0.1))
               if name == "eamsgd" else get_optimizer(name, 0.05))
    cls, kwargs = optimizer_spec(factory)
    if name == "eamsgd":
        assert cls is NesterovTrace
    steps = []
    for make in (factory, lambda p: cls(p, **kwargs)):
        w = torch.nn.Parameter(torch.linspace(-1, 1, 7))
        opt = make([w])
        for i in range(3):
            w.grad = torch.cos(w.detach() * (i + 1))
            opt.step()
        steps.append(w.detach().clone())
    torch.testing.assert_close(steps[0], steps[1], rtol=0, atol=0)
    with pytest.raises(TypeError, match="zero1"):
        optimizer_spec(lambda params: torch.optim.SGD(params, lr=0.1))


INIT_CHILD = """
import sys
from distkeras_tpu_torch.parallel import distributed
import torch
distributed.initialize(**eval(sys.argv[1]))
print("GROUP", torch.distributed.is_initialized() and
      (distributed.process_count(), distributed.process_index(),
       torch.distributed.get_backend()))
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("env, kwargs, want", [
    ({}, {}, "GROUP False"),
    ({"MASTER_ADDR": "localhost", "WORLD_SIZE": "1", "RANK": "0"}, {"backend": "gloo"},
     "GROUP (1, 0, 'gloo')"),
    ({"JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0"}, {"backend": "gloo"},
     "GROUP (1, 0, 'gloo')"),
    ({"WORLD_SIZE": "2"}, {"backend": "gloo", "coordinator_address": "localhost:1"},
     "needs a coordinator address, the number of processes and this process's id"),
])
@time_limited(timeout=120)
def test_initialize_reads_the_environment(env, kwargs, want):
    """A no-op without a process group's variables; torchrun's
    (MASTER_ADDR/MASTER_PORT through env://, WORLD_SIZE, RANK) and the
    reference's (JAX_*) join one; a missing rank raises."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
           and not k.startswith("JAX_")} | env
    if "MASTER_ADDR" in env:
        env["MASTER_PORT"] = port
    if "JAX_NUM_PROCESSES" in env:
        env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", INIT_CHILD, repr(kwargs)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=100)
    assert want in proc.stdout + proc.stderr, proc.stdout + proc.stderr[-2000:]


def test_islands_without_a_process_group():
    """One process: island 0 of ``num_islands``, its mesh the one rank, its
    client the port's gRPC client (a channel, no call made), as the
    reference's ``local_island`` on one host."""
    from distkeras_tpu.parallel import distributed as ref_distributed
    from distkeras_tpu_torch.parallel import distributed
    from distkeras_tpu_torch.parallel.ps_grpc import GrpcClient

    got = distributed.local_island("localhost", 1, num_islands=3)
    want = ref_distributed.local_island("localhost", 1, num_islands=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mesh().shape == {"dp": 1} and distributed.global_mesh().devices.tolist() == [0]
    client = got.client()
    try:
        assert isinstance(client, GrpcClient)
    finally:
        client.close()
