"""The port's ``PipelineTrainer`` against the reference's, over gloo ranks on
the CPU, and the sync trainer's ``pp`` axis.

Two spawns for the module (``tests/torch_dp_worker.py``, runner
``pp_train``): 2 ranks (``mesh={"pp": 2}``: ``gpipe``, ``gpipe`` with
``remat``, ``virtual_stages=2``, ``1f1b``, ``gpipe`` in bfloat16, a run cut
by a checkpoint and resumed, and ``SynchronousDistributedTrainer`` on
``{"pp": 2}``) and 4 (``{"dp": 2, "pp": 2}``: ``gpipe`` and ``1f1b``).
The model is a small bert-family config (hidden 32, 4 layers, 4 heads, mlp
64, vocab 64, 16 tokens, dropout 0) with flash attention on (its plain
version on the CPU) and ``loss="fused_categorical_crossentropy"`` (likewise),
the reference's init for seed 0 bridged across, the trainer's default
optimizer (adagrad), a global batch of 8 in 2 microbatches, 3 steps. Each
run is held against the reference's trainer of the same arguments on a mesh
of as many virtual devices. The reference runs dense attention: its Pallas
flash kernel in interpret mode cannot run inside its pipeline's
``shard_map`` on this jax (``check_vma`` refuses the kernel's output
shapes), and dense attention is the same softmax attention in float32 that
the port's flash takes on the CPU. For the same reason the reference's
``1f1b``, whose loss runs inside the ``shard_map``, takes
``categorical_crossentropy``: the same float32 softmax cross-entropy as the
fused loss's plain version.

Tolerances (``tests/test_torch_sequence_parallel.py``'s float32 bounds):
each step's loss to 1e-5 relative, accuracy to 1e-6, the final merged
weights to 2e-6 absolute. bfloat16: the pp run may be as far from the
reference's pp run as the port's one-process pipeline (pp=1) is from the
reference's one-process pipeline on the same batches (each step's loss,
each weight), plus the float32 bound; each step's accuracy as far as that
one-process gap or the reference's own pp run from its one-process run
(argmax ties of near-uniform bfloat16 logits move with the schedule in the
reference itself), plus 1e-6. The resumed run equals the
uninterrupted one bitwise; every rank returns the same whole weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.models.mlp import mnist_mlp as ref_mnist_mlp
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
import distkeras_tpu_torch as dk
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.utils.bridge import params_from_jax
from distkeras_tpu_torch.utils.config import TrainerConfig
from torch_dp_worker import pp_model, spawn_ranks, with_weights
from torch_time_limit import time_limited

LOSS_RTOL, ACC_ATOL, WEIGHT_ATOL = 1e-5, 1e-6, 2e-6
SEQ, VOCAB, BATCH, M, STEPS = 16, 64, 8, 2, 3
KWARGS = dict(loss="fused_categorical_crossentropy", batch_size=BATCH, num_microbatches=M,
              seed=0)

# name -> (mesh, dtype, trainer kwargs)
TWO = {
    "gpipe": ({"pp": 2}, "float32", {}),
    "remat": ({"pp": 2}, "float32", {"remat": True}),
    "v2": ({"pp": 2}, "float32", {"virtual_stages": 2}),
    "1f1b": ({"pp": 2}, "float32", {"schedule": "1f1b"}),
    "bf16": ({"pp": 2}, "bfloat16", {}),
}
FOUR = {
    "dp_gpipe": ({"dp": 2, "pp": 2}, "float32", {}),
    "dp_1f1b": ({"dp": 2, "pp": 2}, "float32", {"schedule": "1f1b"}),
}
ALL = {**TWO, **FOUR}


def _config(dtype="float32") -> dict:
    return {"vocab": VOCAB, "hidden": 32, "layers": 4, "heads": 4, "seq": SEQ, "dtype": dtype}


def _ref_model(dtype="float32"):
    cfg = ref_bert.BertConfig(vocab_size=VOCAB, hidden_size=32, num_layers=4, num_heads=4,
                              mlp_dim=64, max_seq_len=SEQ, dropout_rate=0.0,
                              dtype=getattr(jnp, dtype), use_flash_attention=False)
    return ref_bert._make(cfg, SEQ, "bert_pp")


def _ref_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ref_make_mesh(axes, devices=jax.devices()[:n])


def _init(dtype="float32", key=0) -> dict:
    """The reference's init for seed 0 (``PipelineTrainer``'s; ``key``, the
    sync trainer's ``TrainState.create`` key), bridged."""
    tree = jax.tree.map(np.asarray, _ref_model(dtype).init(key))
    return {k: v.numpy() for k, v in params_from_jax(tree, device="cpu").items()}


def _sync_key():
    return jax.random.split(jax.random.PRNGKey(0))[0]


def _data(rows=BATCH * STEPS, seed=1) -> dict:
    x = np.random.default_rng(seed).integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
    return {"features": x, "label": np.roll(x, -1, axis=1)}


def _case(name) -> dict:
    mesh, dtype, kwargs = ALL[name]
    return {"model": "pp", "config": _config(dtype), "weights": _init(dtype), "data": _data(),
            "kwargs": {**KWARGS, **kwargs, "mesh": mesh}}


def _two_cases() -> dict:
    cases = {name: _case(name) for name in TWO}
    ck = {**KWARGS, "mesh": {"pp": 2}, "checkpoint_dir": "ck", "checkpoint_interval_s": 1e9}
    cases["ck_first"] = {**_case("gpipe"), "kwargs": ck, "rows": 2 * BATCH}
    cases["ck_resume"] = {**_case("gpipe"), "kwargs": {**ck, "resume": True}}
    cases["sync_pp"] = {**_case("gpipe"), "trainer": "sync", "weights": _init(key=_sync_key()),
                        "kwargs": {"loss": KWARGS["loss"], "batch_size": BATCH, "seed": 0,
                                   "mesh": {"pp": 2}}}
    return cases


@time_limited(timeout=300)
def _spawn(workdir, world, cases):
    return spawn_ranks(workdir, world, {"runs": {"kind": "pp_train", "cases": cases}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {2: _spawn(str(tmp_path_factory.mktemp("ppt2")), 2, _two_cases()),
            4: _spawn(str(tmp_path_factory.mktemp("ppt4")), 4,
                      {name: _case(name) for name in FOUR})}


def _ranks(runs, name):
    return [r["runs"][name] for r in runs[4 if name in FOUR else 2]]


@pytest.fixture(scope="module")
def reference():
    """The reference's PipelineTrainer per (mesh, dtype, kwargs): (history,
    final params bridged)."""
    cache = {}

    def get(axes, dtype="float32", **kwargs):
        key = (tuple(axes.items()), dtype, tuple(sorted(kwargs.items())))
        if key not in cache:
            args = {**KWARGS, **kwargs}
            if args.get("schedule") == "1f1b":  # the loss runs inside the shard_map
                args["loss"] = "categorical_crossentropy"
            tr = ref.PipelineTrainer(_ref_model(dtype), mesh=_ref_mesh(axes), **args)
            trained = tr.train(ref.Dataset(_data()))
            tree = jax.tree.map(np.asarray, trained.variables)
            cache[key] = (tr.history, {k: v.numpy() for k, v in
                                       params_from_jax(tree, device="cpu").items()})
        return cache[key]

    return get


def _assert_history(got, want, rtol=LOSS_RTOL, acc_atol=ACC_ATOL):
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "accuracy"}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)
        assert g["accuracy"] == pytest.approx(w["accuracy"], abs=acc_atol)


def _gap(got, want, key):
    return max(abs(g[key] - w[key]) for g, w in zip(got, want))


def _assert_weights(got, want, atol=WEIGHT_ATOL):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].astype(np.float32), want[k].astype(np.float32),
                                   atol=atol, rtol=0, err_msg=k)


def _one_process(dtype):
    """The port's pipeline at pp=1 in this process (no process group):
    (history, final weights)."""
    model = with_weights(pp_model(_config(dtype)), _init(dtype))
    tr = dk.PipelineTrainer(model, device="cpu", **KWARGS)
    trained = tr.train(dk.Dataset.from_arrays(**_data()))
    return tr.history, {k: v.numpy() for k, v in trained.variables.items()}


def test_every_rank_joined(runs):
    assert [(r["world"], r["rank"]) for r in runs[2]] == [(2, 0), (2, 1)]
    assert [(r["world"], r["rank"]) for r in runs[4]] == [(4, r) for r in range(4)]


@pytest.mark.parametrize("name", sorted(ALL))
def test_training_matches_reference(runs, reference, name):
    """Per-step loss and accuracy and the final merged weights against the
    reference's PipelineTrainer of the same arguments."""
    axes, dtype, kwargs = ALL[name]
    want_history, want_weights = reference(axes, dtype, **kwargs)
    rtol, atol, acc_atol = LOSS_RTOL, WEIGHT_ATOL, ACC_ATOL
    if dtype == "bfloat16":
        one_history, one_weights = _one_process(dtype)
        ref_history, ref_weights = reference({"pp": 1}, dtype)
        rtol += max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                    for g, w in zip(one_history, ref_history))
        atol += max(float(np.abs(one_weights[k].astype(np.float32)
                                 - v.astype(np.float32)).max())
                    for k, v in ref_weights.items())
        # Near-uniform bf16 logits tie: the argmax moves with the schedule
        # in the reference itself (its pp=2 run against its pp=1 run).
        acc_atol += max(_gap(one_history, ref_history, "accuracy"),
                        _gap(want_history, ref_history, "accuracy"))
    for got in _ranks(runs, name):
        _assert_history(got["history"], want_history, rtol, acc_atol)
        _assert_weights(got["weights"], want_weights, atol)


@pytest.mark.parametrize("name", sorted(ALL) + ["sync_pp"])
def test_ranks_end_on_the_same_whole_weights(runs, name):
    ranks = _ranks(runs, name)
    init = _init(ALL[name][1]) if name in ALL else _init(key=_sync_key())
    for rank in ranks:
        assert rank["history"] == ranks[0]["history"]
        for k, v in ranks[0]["weights"].items():
            assert rank["weights"][k].shape == init[k].shape
            np.testing.assert_array_equal(rank["weights"][k], v, err_msg=k)
    assert not np.array_equal(ranks[0]["weights"]["layer_3.mlp_in.weight"],
                              init["layer_3.mlp_in.weight"])


def test_resume_equals_the_uninterrupted_run(runs):
    """Two steps saved whole by rank 0, then a resume that cuts the saved
    state back to each rank's layers and takes the third step: the same
    history and weights as three steps in one run, bitwise."""
    for first, resumed, whole in zip(_ranks(runs, "ck_first"), _ranks(runs, "ck_resume"),
                                     _ranks(runs, "gpipe")):
        assert first["saved_steps"] == [2]
        assert resumed["saved_steps"] == [2, 3]
        assert first["history"] + resumed["history"] == whole["history"]
        for k, v in whole["weights"].items():
            np.testing.assert_array_equal(resumed["weights"][k], v, err_msg=k)


def test_sync_trainer_trains_replicated_over_pp(runs):
    """The sync trainer on ``{"pp": 2}`` trains every rank on the same rows,
    replicated, as the reference's does (its model axes leave pp out)."""
    tr = ref.SynchronousDistributedTrainer(_ref_model(), mesh=_ref_mesh({"pp": 2}),
                                           loss=KWARGS["loss"], batch_size=BATCH, seed=0)
    trained = tr.train(ref.Dataset(_data()))
    want = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, trained.variables), device="cpu").items()}
    for got in _ranks(runs, "sync_pp"):
        _assert_history(got["history"], tr.history)
        _assert_weights(got["weights"], want)


def test_schedules_agree_in_one_process():
    """At pp=1 (no process group): gpipe, remat, V=2 and 1f1b take the same
    steps (1f1b's loss is the sum of its microbatches' means: 1e-6)."""
    out = {}
    for name, kwargs in (("gpipe", {}), ("remat", {"remat": True}),
                         ("v2", {"virtual_stages": 2}), ("1f1b", {"schedule": "1f1b"})):
        model = with_weights(pp_model(_config()), _init())
        tr = dk.PipelineTrainer(model, device="cpu", **KWARGS, **kwargs)
        trained = tr.train(dk.Dataset.from_arrays(**_data()))
        out[name] = (tr.history, trained.variables)
    for name in ("remat", "v2", "1f1b"):
        _assert_history(out[name][0], out["gpipe"][0], 1e-6)
        for k, v in out["gpipe"][1].items():
            torch.testing.assert_close(out[name][1][k], v, rtol=0, atol=1e-6)


def test_split_and_merge_invert_each_other():
    """``_split_params`` of every pp index, then ``_merge_params``: the
    model's layout again, each layer where the round-robin layout put it."""
    model = with_weights(pp_model({**_config(), "layers": 8}), {})
    weights = {k: torch.full((1,), float(i)) for i, k in enumerate(
        model.module.state_dict())}
    for P, V in ((1, 1), (2, 1), (2, 2), (4, 2), (2, 4)):
        tr = dk.PipelineTrainer(model, device="cpu", virtual_stages=V)
        parts = [tr._split_params(weights, P, d)[0] for d in range(P)]
        per = 8 // (P * V)
        assert tr._merge_params(parts, P, per) == weights
        for d, part in enumerate(parts):
            for v, chunk in enumerate(part["stages"]):
                s = v * P + d
                assert chunk["sub_0"]["mlp_in.weight"] is weights[f"layer_{s * per}.mlp_in.weight"]


def test_refusals_match_reference():
    """The reference's refusals, message for message (the model zoo's package
    name aside); ``ep`` on a model without MoE among them (MoE and ep are
    ported: ``tests/test_torch_moe_ep.py``)."""
    ref_model, model = _ref_model(), with_weights(pp_model(_config()), _init())

    def both(ref_call, port_call, exc=ValueError):
        with pytest.raises(exc) as want:
            ref_call()
        with pytest.raises(exc) as got:
            port_call()
        assert str(got.value) == str(want.value).replace("distkeras_tpu.", "distkeras_tpu_torch.")

    both(lambda: ref.PipelineTrainer(ref_model, schedule="zb"),
         lambda: dk.PipelineTrainer(model, schedule="zb", device="cpu"))
    ring = ref_bert._make(dataclasses.replace(ref_model.config, ring_mesh=_ref_mesh({"sp": 1})),
                          SEQ, "ring")
    port_ring = bert.with_ring_mesh(model, dk.parallel.make_mesh({"sp": 1}, devices=[0]))
    both(lambda: ref.PipelineTrainer(ring), lambda: dk.PipelineTrainer(port_ring, device="cpu"))
    both(lambda: ref.PipelineTrainer(ref_mnist_mlp()),
         lambda: dk.PipelineTrainer(dk.mnist_mlp(), device="cpu"))
    both(lambda: ref.PipelineTrainer(ref_model)._split_params(ref_model.init(0)["params"], 3),
         lambda: dk.PipelineTrainer(model, device="cpu")._split_params(model.init(0), 3))
    both(lambda: ref.PipelineTrainer(ref_model, schedule="1f1b", virtual_stages=2,
                                     mesh=_ref_mesh({"pp": 1})).train(ref.Dataset(_data())),
         lambda: dk.PipelineTrainer(model, schedule="1f1b", virtual_stages=2,
                                    device="cpu").train(dk.Dataset.from_arrays(**_data())))
    both(lambda: ref.PipelineTrainer(ref_model, batch_size=6, num_microbatches=4,
                                     mesh=_ref_mesh({"pp": 1})).train(ref.Dataset(_data())),
         lambda: dk.PipelineTrainer(model, batch_size=6, num_microbatches=4,
                                    device="cpu").train(dk.Dataset.from_arrays(**_data())))
    both(lambda: ref.PipelineTrainer(ref_model, ep=2, mesh=_ref_mesh({"pp": 1, "ep": 2}))
         .train(ref.Dataset(_data())),
         lambda: dk.PipelineTrainer(model, ep=2, device="cpu", mesh=dk.parallel.make_mesh(
             {"pp": 1, "ep": 2}, devices=[0, 1]))._pipeline_mesh())


def test_trainer_config_builds_it():
    cfg = TrainerConfig(trainer="PipelineTrainer", worker_optimizer="adam", batch_size=8,
                        extra={"num_microbatches": 2, "schedule": "1f1b", "device": "cpu"})
    tr = cfg.build(with_weights(pp_model(_config()), _init()))
    assert isinstance(tr, dk.PipelineTrainer)
    assert (tr.schedule, tr.num_microbatches, tr.batch_size) == ("1f1b", 2, 8)
    tr.train(dk.Dataset.from_arrays(**_data()))
    assert len(tr.history) == STEPS and all(np.isfinite(h["loss"]) for h in tr.history)
