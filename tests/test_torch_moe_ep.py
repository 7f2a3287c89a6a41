"""Expert parallelism: the port's sync trainer and ``PipelineTrainer`` on
meshes with an ``ep`` axis, over gloo ranks on the CPU, against the
reference's trainers on the same meshes of its virtual CPU devices.

Two spawns for the module (``tests/torch_dp_worker.py``, runner
``pp_train``, model kind ``moe``): 2 ranks (the sync trainer at
``{"ep": 2}``, top-1 and top-2, one with a weight publisher;
``PipelineTrainer`` at ``{"pp": 2}`` on the MoE model, gpipe and 1f1b;
``ModelPredictor`` over ``{"dp": 2}``, runner ``predict``) and
4 (the sync trainer at ``{"dp": 2, "ep": 2}`` and ``{"fsdp": 2, "ep": 2}``,
zero1 at ``{"dp": 2, "ep": 2}`` whole, cut by a checkpoint after two steps
and resumed; ``PipelineTrainer`` at ``{"pp": 2, "ep": 2}``, gpipe and
1f1b). The model is a small bert-family config (hidden 32, 2 layers, 4
heads, mlp 64, vocab 64, 16 tokens, dropout 0) whose MLPs are MoE blocks of
4 experts, flash attention on and ``loss="fused_categorical_crossentropy"``
(both their plain versions on the CPU), the reference's init bridged
across, adagrad, a global batch of 8 (2 microbatches in the pipe), 3 steps.
The reference runs dense attention (the same float32 softmax attention) and
its 1f1b the plain cross-entropy, for the reasons
``tests/test_torch_pipeline_trainer.py`` gives.

Tolerances (the multi-rank float32 bounds of
``tests/test_torch_pipeline_trainer.py``): each step's loss (and aux loss)
to 1e-5 relative, accuracy to 1e-6, the final weights to 2e-6 absolute.
The resumed zero1 run equals the uninterrupted one bitwise, and every rank
returns the same whole weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
import distkeras_tpu_torch as dk
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.parallel.sharding import infer_variable_shardings
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_dp_worker import moe_model, spawn_ranks, with_weights
from torch_time_limit import time_limited

LOSS_RTOL, ACC_ATOL, WEIGHT_ATOL = 1e-5, 1e-6, 2e-6
SEQ, VOCAB, BATCH, M, STEPS = 16, 64, 8, 2, 3
LOSS = "fused_categorical_crossentropy"

# name -> (trainer, mesh, top_k, trainer kwargs)
TWO = {
    "sync_ep": ("sync", {"ep": 2}, 1, {}),
    "sync_ep_top2": ("sync", {"ep": 2}, 2, {}),
    "pp_gpipe": ("pipe", {"pp": 2}, 2, {}),
    "pp_1f1b": ("pipe", {"pp": 2}, 2, {"schedule": "1f1b"}),
}
FOUR = {
    "sync_dp_ep": ("sync", {"dp": 2, "ep": 2}, 2, {}),
    "sync_fsdp_ep": ("sync", {"fsdp": 2, "ep": 2}, 2, {}),
    "zero1_dp_ep": ("sync", {"dp": 2, "ep": 2}, 2, {"zero1": True}),
    "pp_ep_gpipe": ("pipe", {"pp": 2, "ep": 2}, 2, {}),
    "pp_ep_1f1b": ("pipe", {"pp": 2, "ep": 2}, 2, {"schedule": "1f1b"}),
}
ALL = {**TWO, **FOUR}


def _config(top_k) -> dict:
    return {"vocab": VOCAB, "hidden": 32, "layers": 2, "heads": 4, "seq": SEQ,
            "dtype": "float32", "experts": 4, "top_k": top_k}


def _ref_model(top_k):
    cfg = ref_bert.BertConfig(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
                              mlp_dim=64, max_seq_len=SEQ, dropout_rate=0.0,
                              dtype=jnp.float32, use_flash_attention=False, moe_experts=4,
                              moe_top_k=top_k)
    return ref_bert._make(cfg, SEQ, "bert_moe")


def _ref_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ref_make_mesh(axes, devices=jax.devices()[:n])


def _key(trainer):
    """The reference's init key: the sync trainer's ``TrainState.create``
    splits the seed's key, ``PipelineTrainer`` takes the seed itself."""
    return jax.random.split(jax.random.PRNGKey(0))[0] if trainer == "sync" else 0


def _init(trainer, top_k) -> dict:
    tree = jax.tree.map(np.asarray, _ref_model(top_k).init(_key(trainer)))
    return {k: v.numpy() for k, v in params_from_jax(tree, device="cpu").items()}


def _data(rows=BATCH * STEPS, seed=1) -> dict:
    x = np.random.default_rng(seed).integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
    return {"features": x, "label": np.roll(x, -1, axis=1)}


def _kwargs(trainer, mesh, extra) -> dict:
    """The trainer's arguments: a global batch of ``BATCH`` rows (the sync
    trainer's ``batch_size`` is a data shard's)."""
    kw = {"loss": LOSS, "batch_size": BATCH, "seed": 0, "mesh": mesh, **extra}
    if trainer == "pipe":
        kw["num_microbatches"] = M
    else:
        axes = mesh if isinstance(mesh, dict) else dict(mesh.shape)
        kw["batch_size"] = BATCH // (axes.get("dp", 1) * axes.get("fsdp", 1))
    return kw


def _case(name) -> dict:
    trainer, mesh, top_k, extra = ALL[name]
    return {"model": "moe", "config": _config(top_k), "weights": _init(trainer, top_k),
            "data": _data(), "kwargs": _kwargs(trainer, mesh, extra),
            **({"trainer": "sync"} if trainer == "sync" else {})}


def _four_cases() -> dict:
    cases = {name: _case(name) for name in FOUR}
    ck = {**cases["zero1_dp_ep"]["kwargs"], "checkpoint_dir": "ck",
          "checkpoint_interval_s": 1e9}
    cases["ck_first"] = {**cases["zero1_dp_ep"], "kwargs": ck, "rows": 2 * BATCH}
    cases["ck_resume"] = {**cases["zero1_dp_ep"], "kwargs": {**ck, "resume": True}}
    return cases


def _two_cases() -> dict:
    cases = {name: _case(name) for name in TWO}
    cases["publish_ep"] = {**cases["sync_ep_top2"], "publish": 1}
    return cases


def _predict_case() -> dict:
    """The predictor's batch of 8 rows over dp=2 (4 a rank), its MoE layers
    at capacity factor 1.25, so that some assignments find no seat."""
    return {"kind": "predict", "model": "moe", "config": _config(1),
            "weights": _init("sync", 1), "features": _data(rows=16)["features"],
            "batch_size": BATCH, "mesh": {"dp": 2}}


@time_limited(timeout=300)
def _spawn(workdir, world, cases, **more):
    return spawn_ranks(workdir, world, {"runs": {"kind": "pp_train", "cases": cases}, **more})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {2: _spawn(str(tmp_path_factory.mktemp("moe2")), 2, _two_cases(),
                      predict=_predict_case()),
            4: _spawn(str(tmp_path_factory.mktemp("moe4")), 4, _four_cases())}


def _ranks(runs, name):
    four = name in FOUR or name.startswith("ck_")
    return [r["runs"][name] for r in runs[4 if four else 2]]


@pytest.fixture(scope="module")
def reference():
    """The reference's trainer per case: (history, final params bridged)."""
    cache = {}

    def get(name):
        if name not in cache:
            trainer, mesh, top_k, extra = ALL[name]
            kw = _kwargs(trainer, _ref_mesh(mesh), extra)
            if trainer == "sync":
                tr = ref.SynchronousDistributedTrainer(_ref_model(top_k), **kw)
            else:
                if kw.get("schedule") == "1f1b":  # the loss runs inside the shard_map
                    kw["loss"] = "categorical_crossentropy"
                tr = ref.PipelineTrainer(_ref_model(top_k), **kw)
            trained = tr.train(ref.Dataset(_data()))
            tree = jax.tree.map(np.asarray, trained.variables)
            cache[name] = (tr.history, {k: v.numpy() for k, v in
                                        params_from_jax(tree, device="cpu").items()})
        return cache[name]

    return get


def _assert_history(got, want):
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "accuracy":
                assert g[k] == pytest.approx(w[k], abs=ACC_ATOL)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)


def _assert_weights(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=WEIGHT_ATOL, rtol=0, err_msg=k)


def test_every_rank_joined(runs):
    assert [(r["world"], r["rank"]) for r in runs[2]] == [(2, 0), (2, 1)]
    assert [(r["world"], r["rank"]) for r in runs[4]] == [(4, r) for r in range(4)]


@pytest.mark.parametrize("name", sorted(ALL))
def test_training_matches_reference(runs, reference, name):
    """Each step's loss (the sync trainer's holds the aux term; the pipe's
    history has ``aux_loss`` beside the task loss) and accuracy, and the
    final whole weights, against the reference's trainer on the same mesh."""
    want_history, want_weights = reference(name)
    if ALL[name][0] == "pipe":
        assert {"loss", "aux_loss", "accuracy"} == set(want_history[0])
    for got in _ranks(runs, name):
        _assert_history(got["history"], want_history)
        _assert_weights(got["weights"], want_weights)


@pytest.mark.parametrize("name", sorted(ALL) + ["ck_resume", "publish_ep"])
def test_ranks_end_on_the_same_whole_weights(runs, name):
    ranks = _ranks(runs, name)
    top_k = ALL.get(name, (None, None, 2))[2]
    init = _init(ALL.get(name, ("sync",))[0], top_k)
    for rank in ranks:
        assert rank["history"] == ranks[0]["history"]
        for k, v in ranks[0]["weights"].items():
            assert rank["weights"][k].shape == init[k].shape
            np.testing.assert_array_equal(rank["weights"][k], v, err_msg=k)
    for leaf in ("router", "w_in", "w_out"):
        assert not np.array_equal(ranks[0]["weights"][f"layer_1.moe_mlp.{leaf}"],
                                  init[f"layer_1.moe_mlp.{leaf}"]), leaf


def test_zero1_resume_equals_the_uninterrupted_run(runs):
    """Zero1 at dp=2 x ep=2: two steps saved whole (the optimizer state
    gathered over dp, then its expert moments over ep), then a resume that
    cuts the saved state back to each rank's experts and shard: the same
    history and weights as three steps in one run, bitwise."""
    for first, resumed, whole in zip(_ranks(runs, "ck_first"), _ranks(runs, "ck_resume"),
                                     _ranks(runs, "zero1_dp_ep")):
        assert first["saved_steps"] == [2]
        assert resumed["saved_steps"] == [2, 3]
        assert first["history"] + resumed["history"] == whole["history"]
        for k, v in whole["weights"].items():
            np.testing.assert_array_equal(resumed["weights"][k], v, err_msg=k)


def test_publisher_publishes_the_whole_weights(runs):
    """A publisher during ep training: rank 0 publishes the gathered whole
    weights every step; the last publish is the returned weights."""
    rank0 = _ranks(runs, "publish_ep")[0]
    assert rank0["published"] == STEPS
    for k, v in rank0["weights"].items():
        np.testing.assert_array_equal(rank0["last_published"][k], v, err_msg=k)
    assert rank0["history"] == _ranks(runs, "sync_ep_top2")[0]["history"]


def test_mesh_predictor_routes_the_whole_batch(runs):
    """``ModelPredictor(mesh={"dp": 2})`` on the MoE model: each rank runs
    its 4 rows of a batch of 8, and the routing seats and drops the 8 as one
    batch (the reference's XLA routes the sharded global batch), so both
    ranks return the one-process prediction. Routing each half alone would
    drop other assignments."""
    c = _predict_case()
    for rank in runs[2]:
        np.testing.assert_allclose(rank["predict"]["mesh"], rank["predict"]["plain"],
                                   atol=1e-6, rtol=0)
    model = with_weights(moe_model(c["config"]), c["weights"])
    x = torch.as_tensor(c["features"][:BATCH])
    weights = model.init()
    with torch.no_grad():
        whole = model.apply(weights, x)[0]
        halves = torch.cat([model.apply(weights, x[:4])[0], model.apply(weights, x[4:])[0]])
    np.testing.assert_allclose(runs[2][0]["predict"]["plain"][:BATCH], whole.numpy(),
                               atol=1e-6, rtol=0)
    assert (halves - whole).abs().max() > 1e-3


def test_refusals():
    """ep with tp or sp is ported (``tests/test_torch_moe_tp_sp.py`` trains
    it): in one process such a mesh meets the rank count's check, and an
    MoE ``BertConfig`` with ``tp_mesh`` builds, its expert leaves split
    over ep and tp; the pipe's ep checks give the reference's messages."""
    model = with_weights(moe_model(_config(1)), _init("sync", 1))
    ids = np.zeros((8, SEQ), np.int32)
    data = dk.Dataset.from_arrays(features=ids, label=ids)
    for mesh in ({"tp": 2, "ep": 2}, {"sp": 2, "ep": 2}):
        tr = dk.SynchronousDistributedTrainer(model, mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match="needs 4 ranks but the process group has 1"):
            tr.train(data)
    mesh = dk.parallel.make_mesh({"tp": 2, "ep": 2}, devices=[0, 1, 2, 3])
    cfg = bert.BertConfig(moe_experts=4, tp_mesh=mesh)
    shardings = infer_variable_shardings(
        mesh, bert._make(cfg, SEQ, "moe").module.state_dict(), bert.param_axes)
    assert shardings["layer_0.moe_mlp.w_in"].spec == ("ep", None, "tp")
    assert shardings["layer_0.moe_mlp.w_out"].spec == ("ep", "tp", None)
    assert shardings["layer_0.moe_mlp.router"].is_replicated
    ref_model, plain = _ref_model(1), with_weights(moe_model({**_config(1), "experts": 0}), {})

    def both(ref_call, port_call):
        with pytest.raises(ValueError) as want:
            ref_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)

    ref_dense = ref_bert._make(dataclasses.replace(ref_model.config, moe_experts=0), SEQ, "d")
    both(lambda: ref.PipelineTrainer(ref_dense, mesh=_ref_mesh({"pp": 1, "ep": 2}))
         .train(ref.Dataset(_data())),
         lambda: dk.PipelineTrainer(plain, mesh=dk.parallel.make_mesh(
             {"pp": 1, "ep": 2}, devices=[0, 1]), device="cpu")._pipeline_mesh())
    both(lambda: ref.PipelineTrainer(ref_model, ep=4, mesh=_ref_mesh({"pp": 1, "ep": 2}))
         .train(ref.Dataset(_data())),
         lambda: dk.PipelineTrainer(model, ep=4, mesh=dk.parallel.make_mesh(
             {"pp": 1, "ep": 2}, devices=[0, 1]), device="cpu")._pipeline_mesh())
    three = moe_model({**_config(1), "experts": 3})
    ref_three = ref_bert._make(dataclasses.replace(ref_model.config, moe_experts=3), SEQ, "t")
    both(lambda: ref.PipelineTrainer(ref_three, mesh=_ref_mesh({"pp": 1, "ep": 2}))
         .train(ref.Dataset(_data())),
         lambda: dk.PipelineTrainer(three, mesh=dk.parallel.make_mesh(
             {"pp": 1, "ep": 2}, devices=[0, 1]), device="cpu")._pipeline_mesh())
