"""The port's model-parallel ``SynchronousDistributedTrainer`` (tp and fsdp
mesh axes) over gloo ranks on the CPU, against the reference's
``SynchronousDistributedTrainer(mesh=...)`` on as many of its 8 virtual
devices.

Two spawns for the module, each of ``tests/torch_dp_worker.py`` ranks that
join a gloo process group through a file store under the module's
``tmp_path``: two ranks run ``bert_tiny_mlm`` with the fused loss at tp=2
and at fsdp=2, the MLP at fsdp=2 (``fsdp_sharding_for``'s route) and at
tp=2 (un-annotated: replicated over tp), A/B/C checkpoint runs at tp=2 (B
saves, C resumes), ``sharded_train_state`` at tp=2 and fsdp=2,
``ModelPredictor`` over a tp mesh, and the decode mode of ``gpt_tiny`` with
``tp_mesh`` at tp=2; four ranks run bert_tiny_mlm at dp=2 x tp=2 for 2
steps (reference ``tests/test_sharding.py:130``) and build the group of two
mesh axes (dp, fsdp) on dp=2 x fsdp=1 x tp=2. Every model starts from
the reference's init for seed 0, bridged across; float32, dropout 0.

Tolerances against the reference, as ``tests/test_torch_data_parallel.py``
states them for bert: each step's loss to 1e-5 relative and its accuracy
to 1e-6; the weights to 2e-6 absolute (float32 rounding in another order
over a few steps: the ranks sum partial products over their heads and MLP
units where XLA sums them in one program). The MLP here (64 -> 256 -> 2,
adam at 1e-2) is wider than that file's, and the port's ONE-process run of
it is already up to 2.9e-4 (weights, absolute; 16 steps at batch 16) from
the reference's: adam's normalised steps carry the float32 rounding. So an
MLP run on the mesh may be as far from the reference as the port's
one-process run on the same batches is, each step's loss and each weight,
plus the bound below. Against the port's own one-process run on the same
global batches every model is held to 1e-6 (loss, relative) and 5e-7
(weights, absolute). A sharded init gathers to
``Model.init``'s bitwise; the
ranks end on the same whole weights bitwise (the replicated leaves are
each rank's own copy); C's steps equal the uninterrupted run's bitwise.
The tp decode's logits are within 2e-5 of tp=1's (float32 sums over two
halves of each contraction, logits of magnitude < 10) and its greedy
tokens equal tp=1's and the reference's ``generate``'s.
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
from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_dp_worker import MODELS, with_weights
from torch_time_limit import time_limited

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
LOSS_RTOL, ACC_ATOL, WEIGHT_ATOL, DECODE_ATOL = 1e-5, 1e-6, 2e-6, 2e-5
ONE_LOSS_RTOL, ONE_WEIGHT_ATOL = 1e-6, 5e-7

BERT = {"name": "bert_tiny_mlm", "seq": 32, "vocab": 256}
MLP_CFG = {"dim": 64, "hidden": (256,)}  # Dense_0 [256, 64]: 2^14 elements, fsdp shards it
GPT = {"seq": 64, "vocab": 256}
BERT_KW = dict(loss="fused_categorical_crossentropy", batch_size=4, num_epoch=1, seed=0)
MLP_KW = dict(worker_optimizer="adam", learning_rate=1e-2, batch_size=16, num_epoch=2, seed=0)
CONFIGS = {"bert": BERT, "mlp": MLP_CFG}
KWARGS = {"bert": BERT_KW, "mlp": MLP_KW}
DECODE_STEPS = 16

# scenario -> (model, mesh, extra trainer arguments)
TRAIN = {
    "bert_tp": ("bert", {"tp": 2}, {}),
    "bert_fsdp": ("bert", {"fsdp": 2}, {}),
    "mlp_fsdp": ("mlp", {"fsdp": 2}, {}),
    "mlp_tp": ("mlp", {"tp": 2}, {}),
    "bert_tp_long": ("bert", {"tp": 2}, {"num_epoch": 2}),
    "ckpt_b": ("bert", {"tp": 2}, {"checkpoint_dir": "ck_tp"}),
    "ckpt_c": ("bert", {"tp": 2}, {"num_epoch": 2, "checkpoint_dir": "ck_tp", "resume": True}),
}
FOUR = {"bert_dp_tp": ("bert", {"dp": 2, "tp": 2}, {})}


def _ref_model(kind):
    if kind == "bert":
        base = getattr(ref_bert, BERT["name"])(seq_len=BERT["seq"], vocab_size=BERT["vocab"])
        return ref_bert._make(dataclasses.replace(
            base.config, use_flash_attention=True, dtype=jnp.float32, dropout_rate=0.0),
            BERT["seq"], BERT["name"])
    return RefModel.from_flax(RefMLP(features=MLP_CFG["hidden"], num_classes=2,
                                     compute_dtype=jnp.float32),
                              input_shape=(MLP_CFG["dim"],), output_dim=2)


def _ref_gpt():
    base = ref_bert.gpt_tiny(seq_len=GPT["seq"], vocab_size=GPT["vocab"])
    return ref_bert._make(dataclasses.replace(base.config, dtype=jnp.float32), GPT["seq"],
                          "gpt_tiny")


def _bridge(variables) -> dict:
    tree = jax.tree.map(np.asarray, variables)
    return {k: v.numpy() for k, v in params_from_jax(tree, device="cpu").items()}


def _init(model) -> dict:
    """The reference's init for seed 0 (``TrainState.create``'s key), bridged."""
    return _bridge(model.init(jax.random.split(jax.random.PRNGKey(0))[0])["params"])


def _data(kind, rows) -> dict:
    rng = np.random.default_rng({"bert": 1, "mlp": 2}[kind])
    if kind == "bert":
        shape = (rows, BERT["seq"])
        return {"features": rng.integers(0, BERT["vocab"], size=shape).astype(np.int32),
                "label": rng.integers(0, BERT["vocab"], size=shape).astype(np.int32)}
    x = rng.normal(size=(rows, MLP_CFG["dim"])).astype(np.float32)
    return {"features": x,
            "label": (x @ rng.normal(size=(MLP_CFG["dim"],)) > 0).astype(np.float32)}


def _train_cases(table, inits, data) -> dict:
    return {name: {"kind": "train", "model": kind, "config": CONFIGS[kind],
                   "weights": inits[kind], "data": data[kind],
                   "kwargs": {**KWARGS[kind], "mesh": mesh, **extra}}
            for name, (kind, mesh, extra) in table.items()}


def _scenarios(inits, data, gpt, prompt) -> dict:
    out = _train_cases(TRAIN, inits, data)
    batch = {k: v[:8] for k, v in data["bert"].items()}
    for mesh in ("tp", "fsdp"):
        out[f"init_{mesh}"] = {"kind": "sharded_init", "model": "bert", "config": BERT,
                               "mesh": {mesh: 2}, "loss": BERT_KW["loss"], "batch": batch}
    out["predict_tp"] = {"kind": "predict", "model": "bert", "config": BERT,
                         "weights": inits["bert"], "features": data["bert"]["features"][:10],
                         "batch_size": 4, "mesh": {"tp": 2}}
    out["decode_tp"] = {"kind": "tp_decode", "mesh": {"tp": 2}, "weights": gpt,
                        "prompt": prompt, "steps": DECODE_STEPS, **GPT}
    return out


@time_limited(timeout=300)
def _spawn_ranks(workdir: str, world: int) -> list[dict]:
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, WORKER, workdir, str(r), str(world)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
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
    for r in range(world):
        with open(os.path.join(workdir, f"result-{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _spawn(tmp_path_factory, world, scenarios) -> list[dict]:
    workdir = str(tmp_path_factory.mktemp(f"mp{world}"))
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(scenarios, f)
    return _spawn_ranks(workdir, world)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inits = {k: _init(_ref_model(k)) for k in ("bert", "mlp")}
    data = {"bert": _data("bert", 24), "mlp": _data("mlp", 128)}
    gpt = _init(_ref_gpt())
    prompt = np.random.default_rng(4).integers(0, GPT["vocab"], size=(2, 8)).astype(np.int32)
    ranks = _spawn(tmp_path_factory, 2, _scenarios(inits, data, gpt, prompt))
    four = _spawn(tmp_path_factory, 4, {
        **_train_cases(FOUR, inits, {"bert": _data("bert", 16)}),
        "joint": {"kind": "joint_group", "mesh": {"dp": 2, "fsdp": 1, "tp": 2},
                  "axes": ("dp", "fsdp")}})
    return {"ranks": ranks, "four": four, "inits": inits, "data": data, "gpt": gpt,
            "prompt": prompt}


@pytest.fixture(scope="module")
def reference(runs):
    """The reference's SynchronousDistributedTrainer on a mesh of as many
    virtual devices, per scenario: (history, final params bridged)."""
    cache = {}

    def get(name):
        if name not in cache:
            kind, mesh, extra = {**TRAIN, **FOUR}[name]
            devices = jax.devices()[:int(np.prod(list(mesh.values())))]
            tr = ref.SynchronousDistributedTrainer(
                _ref_model(kind), mesh=ref_make_mesh(mesh, devices=devices),
                **{**KWARGS[kind], **extra})
            data = runs["data"][kind] if name in TRAIN else _data("bert", 16)
            trained = tr.train(ref.Dataset(data))
            cache[name] = (tr.history, _bridge(trained.variables["params"]))
        return cache[name]

    return get


def _assert_history(got, want, rtol=LOSS_RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "accuracy"}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)
        assert g["accuracy"] == pytest.approx(w["accuracy"], abs=ACC_ATOL)


def _assert_weights(got, want, atol=WEIGHT_ATOL):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def test_every_rank_joined(runs):
    assert [(r["world"], r["rank"]) for r in runs["ranks"]] == [(2, 0), (2, 1)]
    assert [(r["world"], r["rank"]) for r in runs["four"]] == [(4, r) for r in range(4)]


@pytest.mark.parametrize("name", ["bert_tp", "bert_fsdp", "mlp_fsdp", "mlp_tp", "bert_dp_tp"])
def test_matches_reference(runs, reference, one_process, name):
    """Per-step loss and accuracy (the global batch's, on every rank) and
    the final whole weights."""
    want_history, want_weights = reference(name)
    if name.startswith("mlp"):
        one_history, one_weights = one_process(name)
        rtol = ONE_LOSS_RTOL + max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                                   for g, w in zip(one_history, want_history))
        atol = ONE_WEIGHT_ATOL + max(float(np.abs(one_weights[k] - v).max())
                                     for k, v in want_weights.items())
    else:
        rtol, atol = LOSS_RTOL, WEIGHT_ATOL
    for got in runs["four" if name in FOUR else "ranks"]:
        _assert_history(got[name]["history"], want_history, rtol)
        _assert_weights(got[name]["weights"], want_weights, atol)


@pytest.fixture(scope="module")
def one_process(runs):
    """The port alone (no process group) on the scenario's global batches:
    (history, final weights)."""
    cache = {}

    def get(name):
        if name not in cache:
            kind, mesh, extra = {**TRAIN, **FOUR}[name]
            model = with_weights(MODELS[kind](CONFIGS[kind]), runs["inits"][kind])
            data = mesh.get("dp", 1) * mesh.get("fsdp", 1)
            kwargs = {**KWARGS[kind], **extra, "batch_size": data * KWARGS[kind]["batch_size"]}
            tr = dk.SynchronousDistributedTrainer(model, num_workers=1, device="cpu", **kwargs)
            rows = runs["data"][kind] if name in TRAIN else _data("bert", 16)
            trained = tr.train(dk.Dataset.from_arrays(**rows))
            cache[name] = (tr.history, {k: v.numpy() for k, v in trained.variables.items()})
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["bert_tp", "bert_fsdp", "mlp_fsdp", "mlp_tp", "bert_dp_tp"])
def test_equals_one_process(runs, one_process, name):
    """The port on the mesh against the port alone on the same global
    batches."""
    want_history, want_weights = one_process(name)
    for got in runs["four" if name in FOUR else "ranks"]:
        _assert_history(got[name]["history"], want_history, ONE_LOSS_RTOL)
        _assert_weights(got[name]["weights"], want_weights, ONE_WEIGHT_ATOL)


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(FOUR))
def test_ranks_end_on_the_same_whole_weights(runs, name):
    """The weights every rank returns are whole and equal: the replicated
    leaves (LayerNorms, biases, pos_embed) stayed equal over the steps."""
    ranks = [r[name] for r in runs["four" if name in FOUR else "ranks"]]
    kind = {**TRAIN, **FOUR}[name][0]
    for rank in ranks[1:]:
        assert rank["history"] == ranks[0]["history"]
        for k, v in ranks[0]["weights"].items():
            assert v.shape == runs["inits"][kind][k].shape
            np.testing.assert_array_equal(rank["weights"][k], v, err_msg=k)


def test_joint_group_of_two_axes(runs):
    """On dp=2 x fsdp=1 x tp=2 the group of (dp, fsdp) holds the two ranks
    of each tp index: ranks 0 and 2, 1 and 3 (the data group BatchNorm
    takes its moments over)."""
    assert [r["joint"] for r in runs["four"]] == [[2, 4.0], [2, 6.0], [2, 4.0], [2, 6.0]]


def test_tp2_resume_matches_uninterrupted(runs):
    """B (one epoch at tp=2, saved whole by rank 0) resumed by C for the
    second epoch at tp=2: C's steps and weights are the uninterrupted run's."""
    for rank in runs["ranks"]:
        full, b, c = rank["bert_tp_long"], rank["ckpt_b"], rank["ckpt_c"]
        assert len(b["history"]) + len(c["history"]) == len(full["history"]) == 12
        assert b["saved_steps"] == [6] and c["saved_steps"] == [6, 12]
        assert c["history"] == full["history"][6:]
        for k in full["weights"]:
            np.testing.assert_array_equal(c["weights"][k], full["weights"][k], err_msg=k)


@pytest.mark.parametrize("mesh", ["tp", "fsdp"])
def test_sharded_init_is_the_whole_init(runs, mesh):
    """Gathered, the sharded init is ``Model.init``'s for the same seed; each
    rank holds its part of every split leaf before and after a step: half
    of it along the split dimension."""
    for rank in runs["ranks"]:
        got = rank[f"init_{mesh}"]
        assert got["whole"].keys() == got["init"].keys()
        for k, v in got["init"].items():
            np.testing.assert_array_equal(got["whole"][k], v, err_msg=k)
        assert got["before"] == got["after"]
        split = {k for k, spec in got["specs"].items() if any(spec)}
        for k, shape in got["after"].items():
            whole = got["init"][k].shape
            if k in split:
                assert np.prod(shape) * 2 == np.prod(whole), k
            else:
                assert shape == whole, k
        if mesh == "tp":
            assert split == {k for k in got["init"] if bert.param_axes(k) not in (
                None, (None, "seq", "embed"))}
        else:  # every leaf of 2^14 elements or more
            assert split == {k for k, v in got["init"].items() if v.size >= 1 << 14}


def test_predictor_over_a_tp_mesh(runs):
    """ModelPredictor(mesh=) with a tp axis runs the replicated weights on
    every rank: the same rows as the plain predictor."""
    for rank in runs["ranks"]:
        got = rank["predict_tp"]
        assert got["mesh"].shape == (10, BERT["seq"], BERT["vocab"])
        np.testing.assert_array_equal(got["mesh"], got["plain"])


def _tp1_decode(weights, prompt):
    from distkeras_tpu_torch.inference.generate import greedy_ids

    base = bert.gpt_tiny(seq_len=GPT["seq"], vocab_size=GPT["vocab"])
    model = bert._make(dataclasses.replace(base.config, dtype=torch.float32, decode=True),
                       GPT["seq"], "gpt_tiny")
    w = {k: torch.as_tensor(v) for k, v in weights.items()}
    logits, cache = model.apply(w, torch.as_tensor(prompt))
    steps, toks = [logits[:, -1]], []
    for _ in range(DECODE_STEPS):
        tok = greedy_ids(logits[:, -1])
        toks.append(tok)
        logits, cache = model.apply({**w, **cache}, tok[:, None])
        steps.append(logits[:, -1])
    return torch.stack(steps).numpy(), torch.stack(toks, 1).numpy()


def test_tp2_decode_matches_tp1_and_the_reference(runs):
    """gpt_tiny's decode mode with tp_mesh at tp=2: K/V leaves of H/2 heads,
    logits within float32 rounding of tp=1, and the same greedy tokens as
    tp=1 and the reference's ``generate``."""
    want_logits, want_tokens = _tp1_decode(runs["gpt"], runs["prompt"])
    model = _ref_gpt()
    params = model.init(jax.random.split(jax.random.PRNGKey(0))[0])
    ref_tokens = np.asarray(ref_generate(model, params, runs["prompt"], DECODE_STEPS,
                                         greedy=True))
    assert np.array_equal(want_tokens, ref_tokens[:, -DECODE_STEPS:])
    heads, D = 4, 128 // 4
    for rank in runs["ranks"]:
        got = rank["decode_tp"]
        assert len(got["kv"]) == 2 * 2
        assert all(s == (2, GPT["seq"], heads // 2, D) for s in got["kv"].values())
        np.testing.assert_allclose(got["logits"], want_logits, atol=DECODE_ATOL, rtol=0)
        np.testing.assert_array_equal(got["tokens"], want_tokens)
