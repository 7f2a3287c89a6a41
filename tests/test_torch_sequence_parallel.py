"""The port's sequence parallelism at the model and trainer level, over gloo
ranks on the CPU, against the reference on as many of its 8 virtual
devices: the bert family under ``ring_mesh`` with ``sp_impl`` ``"ring"``,
``"ring_stripe"`` and ``"ulysses"`` (flash on), and the
``SynchronousDistributedTrainer`` with ``shard_sequence=True`` on
``{"sp": 2}`` and ``{"dp": 2, "sp": 2}``.

Two spawns for the module (``tests/torch_dp_worker.py``; runners
``sp_forward`` and ``train``), of 2 ranks and of 4. The models are small
(hidden 32, 2 layers, 4 heads, vocab 64), trained at 16 tokens under a
``max_seq_len`` of 32 (the positional rows past the trained length are
never read, and striped tokens need rows outside a rank's part of
``pos_embed``), dropout 0, from the reference's init for seed 0 bridged
across; the fused loss; the trainer's default optimizer (adagrad).

Tolerances. Logits of one forward, gathered from the ranks (unstriped under
``ring_stripe``), against the reference's model with the same ``ring_mesh``:
2e-5 absolute (float32 summation order; logits O(1)). Training in float32
(``tests/test_torch_data_parallel.py``'s bounds): each step's loss to 1e-5
relative, accuracy to 1e-6, the final weights to 2e-6 absolute; against
the port's own one-process run on the same global batches (the plain
model, no ``ring_mesh``): loss 1e-6, weights 5e-7; the ranks end on the
same whole weights bitwise. In bfloat16 no other test of the port's
training sets a bound; the sp run may be as far from the reference's sp
run as the port's one-process bfloat16 run is from the
reference's one-process bfloat16 run on the same batches (each step's loss
and each weight), plus the float32 bound. Generation from ``ring_stripe``
weights: greedy tokens equal to the plain model's rollout without a cache.
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
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.parallel.mesh import make_mesh
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_dp_worker import sp_model, with_weights
from torch_time_limit import time_limited

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
LOGITS_ATOL = 2e-5
LOSS_RTOL, ACC_ATOL, WEIGHT_ATOL = 1e-5, 1e-6, 2e-6
ONE_LOSS_RTOL, ONE_WEIGHT_ATOL = 1e-6, 5e-7
SEQ, MAX_SEQ, VOCAB, ROWS = 16, 32, 64, 16
KWARGS = dict(loss="fused_categorical_crossentropy", batch_size=4, num_epoch=1, seed=0,
              shard_sequence=True)

# name -> (sp_impl, causal, dtype)
CONFIGS = {
    "ring": ("ring", True, "float32"),
    "ring_full": ("ring", False, "float32"),
    "ring_stripe": ("ring_stripe", True, "float32"),
    "ulysses": ("ulysses", False, "float32"),
    "ring_bf16": ("ring", True, "bfloat16"),
}
TRAIN = {f"train_{name}": name for name in ("ring", "ring_stripe", "ulysses", "ring_bf16")}
FOUR = {f"train4_{name}": name for name in ("ring", "ring_stripe", "ulysses")}
FORWARD = ("ring", "ring_full", "ring_stripe", "ulysses")


def _config(name) -> dict:
    impl, causal, dtype = CONFIGS[name]
    return {"vocab": VOCAB, "hidden": 32, "heads": 4, "max_seq_len": MAX_SEQ, "seq": SEQ,
            "causal": causal, "dtype": dtype, "ring_mesh": {"sp": 2}, "sp_impl": impl}


def _ref_model(name, mesh):
    """The reference's model of ``name`` with ``ring_mesh=mesh`` (None: the
    plain model)."""
    impl, causal, dtype = CONFIGS[name]
    cfg = ref_bert.BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
        max_seq_len=MAX_SEQ, dropout_rate=0.0, causal=causal, dtype=getattr(jnp, dtype),
        use_flash_attention=True, ring_mesh=mesh, sp_impl=impl)
    return ref_bert._make(cfg, SEQ, "bert_sp")


def _ref_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ref_make_mesh(axes, devices=jax.devices()[:n])


def _bridge(variables) -> dict:
    tree = jax.tree.map(np.asarray, variables)
    return {k: v.numpy() for k, v in params_from_jax(tree, device="cpu").items()}


def _init(name) -> dict:
    """The reference's init for seed 0 (``TrainState.create``'s key), bridged."""
    model = _ref_model(name, None)
    return _bridge(model.init(jax.random.split(jax.random.PRNGKey(0))[0])["params"])


def _data(rows=ROWS, seed=1) -> dict:
    x = np.random.default_rng(seed).integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
    return {"features": x, "label": np.roll(x, -1, axis=1)}


def _train_cases(table, mesh, data) -> dict:
    return {case: {"kind": "train", "model": "sp", "config": _config(name),
                   "weights": _init(name), "data": data, "kwargs": {**KWARGS, "mesh": mesh}}
            for case, name in table.items()}


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
    workdir = str(tmp_path_factory.mktemp(f"sp{world}"))
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(scenarios, f)
    return _spawn_ranks(workdir, world)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tokens = _data(4, seed=2)["features"]
    forward = {"kind": "sp_forward", "weights": _init("ring"), "tokens": tokens,
               "cases": {name: {"config": _config(name)} for name in FORWARD}}
    two = _spawn(tmp_path_factory, 2, {**_train_cases(TRAIN, {"sp": 2}, _data()),
                                       "forward": forward})
    four = _spawn(tmp_path_factory, 4, _train_cases(FOUR, {"dp": 2, "sp": 2}, _data(2 * ROWS)))
    return {"two": two, "four": four, "tokens": tokens}


@pytest.fixture(scope="module")
def reference():
    """The reference's SynchronousDistributedTrainer (``shard_sequence=True``)
    per scenario: (history, final params bridged). ``mesh=None``: one
    device, the plain model."""
    cache = {}

    def get(name, axes):
        key = (name, tuple(sorted(axes.items())) if axes else None)
        if key not in cache:
            mesh = _ref_mesh(axes) if axes else None
            kwargs = {**KWARGS, "shard_sequence": mesh is not None}
            tr = ref.SynchronousDistributedTrainer(
                _ref_model(name, mesh), mesh=mesh if mesh else _ref_mesh({"dp": 1}),
                **kwargs)
            rows = ROWS * (axes or {}).get("dp", 1)
            trained = tr.train(ref.Dataset(_data(rows)))
            cache[key] = (tr.history, _bridge(trained.variables["params"]))
        return cache[key]

    return get


@pytest.fixture(scope="module")
def one_process():
    """The port alone (no process group, the plain model) on the same global
    batches: (history, final weights)."""
    cache = {}

    def get(name, data_ranks=1):
        if (name, data_ranks) not in cache:
            model = with_weights(sp_model({**_config(name), "ring_mesh": None}), _init(name))
            kwargs = {**KWARGS, "shard_sequence": False,
                      "batch_size": KWARGS["batch_size"] * data_ranks}
            tr = dk.SynchronousDistributedTrainer(model, num_workers=1, device="cpu", **kwargs)
            trained = tr.train(dk.Dataset.from_arrays(**_data(ROWS * data_ranks)))
            cache[(name, data_ranks)] = (tr.history,
                                         {k: v.numpy() for k, v in trained.variables.items()})
        return cache[(name, data_ranks)]

    return get


def _assert_history(got, want, rtol=LOSS_RTOL):
    assert len(got) == len(want) > 0
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
    assert [(r["world"], r["rank"]) for r in runs["two"]] == [(2, 0), (2, 1)]
    assert [(r["world"], r["rank"]) for r in runs["four"]] == [(4, r) for r in range(4)]


@pytest.mark.parametrize("name", FORWARD)
def test_shard_logits_match_the_reference_model(runs, name):
    """Each rank's [B, S/2, V] logits, gathered over sp (and unstriped)
    into the same whole logits on both ranks, against the reference's model
    with the same sp_impl on 2 virtual devices."""
    got = runs["two"][0]["forward"][name]["whole"]
    for rank in runs["two"]:
        assert rank["forward"][name]["local"] == (len(runs["tokens"]), SEQ // 2, VOCAB)
        np.testing.assert_array_equal(rank["forward"][name]["whole"], got)
    model = _ref_model(name, _ref_mesh({"sp": 2}))
    params = _ref_model("ring", None).init(jax.random.split(jax.random.PRNGKey(0))[0])
    want, _ = jax.jit(lambda p, x: model.apply(p, x))(params, runs["tokens"])
    assert got.shape == (len(runs["tokens"]), SEQ, VOCAB)
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(TRAIN) + sorted(FOUR))
def test_training_matches_reference(runs, reference, one_process, case):
    """Per-step loss and accuracy (the global batch's, on every rank) and the
    final whole weights, against the reference's trainer on the same mesh."""
    name = {**TRAIN, **FOUR}[case]
    axes = {"sp": 2} if case in TRAIN else {"dp": 2, "sp": 2}
    want_history, want_weights = reference(name, axes)
    rtol, atol = LOSS_RTOL, WEIGHT_ATOL
    if CONFIGS[name][2] == "bfloat16":
        one_history, one_weights = one_process(name)
        ref_history, ref_weights = reference(name, None)
        rtol += max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                    for g, w in zip(one_history, ref_history))
        atol += max(float(np.abs(one_weights[k] - v).max()) for k, v in ref_weights.items())
    for got in runs["two" if case in TRAIN else "four"]:
        _assert_history(got[case]["history"], want_history, rtol)
        _assert_weights(got[case]["weights"], want_weights, atol)


@pytest.mark.parametrize("case", sorted(k for k, v in {**TRAIN, **FOUR}.items()
                                        if CONFIGS[v][2] == "float32"))
def test_training_equals_one_process(runs, one_process, case):
    """The sp run against the port alone, the plain model, on the same
    global batches."""
    name = {**TRAIN, **FOUR}[case]
    want_history, want_weights = one_process(name, 1 if case in TRAIN else 2)
    for got in runs["two" if case in TRAIN else "four"]:
        _assert_history(got[case]["history"], want_history, ONE_LOSS_RTOL)
        _assert_weights(got[case]["weights"], want_weights, ONE_WEIGHT_ATOL)


@pytest.mark.parametrize("case", sorted(TRAIN) + sorted(FOUR))
def test_ranks_end_on_the_same_whole_weights(runs, case):
    """Every rank returns the whole weights (pos_embed gathered over sp) and
    the same ones; the replicated leaves stayed equal over the steps."""
    ranks = [r[case] for r in runs["two" if case in TRAIN else "four"]]
    init = _init({**TRAIN, **FOUR}[case])
    for rank in ranks:
        assert rank["history"] == ranks[0]["history"]
        for k, v in ranks[0]["weights"].items():
            assert rank["weights"][k].shape == init[k].shape
            np.testing.assert_array_equal(rank["weights"][k], v, err_msg=k)


def test_ring_stripe_below_max_seq_len(runs, reference):
    """Trained at 16 tokens under max_seq_len 32 with ring_stripe (rank m's
    tokens need positional rows j·2 + m, across both ranks' parts of
    pos_embed): the rows the tokens use moved as the reference's did, and
    the rows past the trained length kept their initial values."""
    got = runs["two"][0]["train_ring_stripe"]["weights"]["pos_embed"]
    want = reference("ring_stripe", {"sp": 2})[1]["pos_embed"]
    init = _init("ring_stripe")["pos_embed"]
    np.testing.assert_allclose(got, want, atol=WEIGHT_ATOL, rtol=0)
    assert not np.array_equal(got[:, :SEQ], init[:, :SEQ])
    np.testing.assert_array_equal(got[:, SEQ:], init[:, SEQ:])


def test_generate_from_ring_stripe_weights(runs):
    """Weights trained under ring_stripe generate through the plain decode
    path (generate drops ring_mesh): greedy tokens equal the plain model's
    rollout without a cache (reference tests/test_generate.py:180-220)."""
    weights = {k: torch.as_tensor(v) for k, v in
               runs["two"][0]["train_ring_stripe"]["weights"].items()}
    model = sp_model({**_config("ring_stripe"), "ring_mesh": None})
    ring_cfg = dataclasses.replace(model.config, ring_mesh=make_mesh({"sp": 2}, devices=[0, 1]))
    trained = bert._make(ring_cfg, SEQ, "bert_sp")
    plain = bert._make(dataclasses.replace(ring_cfg, ring_mesh=None), SEQ, "bert_sp")
    prompt = _data()["features"][:2, :6]
    got = dk.generate(trained, weights, prompt, 8, greedy=True, device="cpu")
    toks = torch.as_tensor(prompt).long()
    for _ in range(8):
        logits, _ = plain.apply(weights, toks)
        toks = torch.cat([toks, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    np.testing.assert_array_equal(np.asarray(got)[:, -8:], toks[:, -8:].numpy())


def test_a_trained_ring_model_needs_a_process_group(runs):
    """The trained model keeps its ring_mesh; applied outside a process
    group of the mesh's size it raises naming the need."""
    model = sp_model({**_config("ring"), "ring_mesh": None})
    ring = bert._make(dataclasses.replace(model.config,
                                          ring_mesh=make_mesh({"sp": 2}, devices=[0, 1])),
                      SEQ, "bert_sp")
    weights = {k: torch.as_tensor(v) for k, v in runs["two"][0]["train_ring"]["weights"].items()}
    with pytest.raises(RuntimeError, match="needs a process group"):
        ring.apply(weights, torch.zeros(1, SEQ // 2, dtype=torch.long))
