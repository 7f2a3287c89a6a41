"""MoE with tensor and sequence parallelism: the port's sync trainer, its
``ModelPredictor(mesh=)``, ``generate(mesh=)`` and ``ServingEngine(mesh=)``
on an MoE model over meshes with ``tp`` or ``sp`` (and ``ep``), over gloo
ranks on the CPU, against the reference's trainer on its virtual CPU
devices, its plain apply and its unsharded ``generate``.

Two spawns for the module (``tests/torch_dp_worker.py``, runners
``pp_train``, ``predict`` and ``serve_mesh``, model kind ``moe``):

- 2 ranks: the sync trainer at ``{"tp": 2}`` and at ``{"sp": 2}`` under the
  XLA split (``shard_sequence=True``), MoE at ep=1, top-2;
  ``ModelPredictor(mesh={"sp": 2})`` on the MoE model with a ring over
  sp, and over ``{"tp": 2}`` without one; ``generate(mesh={"tp": 2})`` and ``ServingEngine(mesh={"tp": 2})``
  requests at slots 1 on a causal MoE ``gpt_tiny``;
- 4 ranks: ``{"tp": 2, "ep": 2}`` at top-1 and top-2; ``{"sp": 2, "ep":
  2}`` under the XLA split, ``ring``, ``ulysses`` and, on a causal config,
  ``ring_stripe``; zero1 at ``{"tp": 2, "ep": 2}`` cut by a checkpoint
  after two steps and resumed; a weight publisher at ``{"tp": 2, "ep":
  2}``. Four ranks hold no dp axis beside tp and ep, so ZeRO-1 shards
  nothing there: that case covers the expert leaves split along two
  dimensions over two axes (``w_in`` ``[E/ep, D, M/tp]``) through
  ``gather_whole``, the checkpoint's save and its cut back on resume, and
  the publisher, as ``tests/test_torch_moe_ep.py`` covers zero1 over dp
  at ``{"dp": 2, "ep": 2}``.

The model is ``tests/test_torch_moe_ep.py``'s (hidden 32, 2 layers, 4
heads, mlp 64, vocab 64, 16 tokens, 4 experts, dropout 0, float32), flash
attention and ``loss="fused_categorical_crossentropy"`` (their plain
versions on the CPU), the reference's init bridged across, adagrad, a
global batch of 8, 3 steps. The batch's tokens come from the lower quarter
of the vocabulary, which skews the routing so that capacity 1.25 drops
assignments in every layer: the seat order decides which (the test
asserts drops). The reference runs once per configuration on the
``{"tp": 2, "ep": 2}`` or ``{"sp": 2, "ep": 2}`` mesh of its virtual
devices; the two-rank meshes compute the same function and are held to
those runs.

Tolerances (the multi-rank float32 bounds of
``tests/test_torch_moe_ep.py``): each step's loss and aux loss to 1e-5
relative, accuracy to 1e-6, the final weights to 2e-6 absolute; the
predictor's logits to 1e-5 absolute; generated tokens exactly. The resumed
run equals the uninterrupted one bitwise, every rank returns the same
whole weights, and the ranks of a tp group route identically.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu.parallel.mesh import serving_mesh as ref_serving_mesh
import distkeras_tpu_torch as dk
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.parallel.mesh import make_mesh, serving_mesh
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_dp_worker import moe_model, spawn_ranks, with_weights
from torch_time_limit import time_limited

LOSS_RTOL, ACC_ATOL, WEIGHT_ATOL, LOGIT_ATOL = 1e-5, 1e-6, 2e-6, 1e-5
SEQ, VOCAB, BATCH, STEPS = 16, 64, 8, 3
LOSS = "fused_categorical_crossentropy"
TP_EP, SP_EP = {"tp": 2, "ep": 2}, {"sp": 2, "ep": 2}
RING = {"ring_mesh": {"sp": 2}, "sp_impl": "ring"}

# name -> (mesh, model config, trainer kwargs, the reference run it is held to)
TWO = {
    "tp": ({"tp": 2}, {}, {}, "tp_ep_top2"),
    "sp_xla": ({"sp": 2}, {}, {"shard_sequence": True}, "sp_ep_xla"),
}
FOUR = {
    "tp_ep_top1": (TP_EP, {"top_k": 1}, {}, "tp_ep_top1"),
    "tp_ep_top2": (TP_EP, {}, {}, "tp_ep_top2"),
    "sp_ep_xla": (SP_EP, {}, {"shard_sequence": True}, "sp_ep_xla"),
    "sp_ep_ring": (SP_EP, RING, {}, "sp_ep_ring"),
    "sp_ep_ulysses": (SP_EP, {**RING, "sp_impl": "ulysses"}, {}, "sp_ep_ulysses"),
    "sp_ep_stripe": (SP_EP, {**RING, "sp_impl": "ring_stripe", "causal": True}, {},
                     "sp_ep_stripe"),
    "zero1_tp_ep": (TP_EP, {}, {"zero1": True}, "tp_ep_top2"),
}
ALL = {**TWO, **FOUR}
# The reference's runs: (mesh, model config, trainer kwargs).
REFERENCE = {name: (mesh, cfg, kw) for name, (mesh, cfg, kw, _) in FOUR.items()
             if name != "zero1_tp_ep"}


def _config(**over) -> dict:
    return {"vocab": VOCAB, "hidden": 32, "layers": 2, "heads": 4, "seq": SEQ,
            "dtype": "float32", "experts": 4, "top_k": 2, **over}


def _ref_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ref_make_mesh(axes, devices=jax.devices()[:n])


def _ref_model(cfg: dict, mesh=None):
    """The reference's model of the port config ``cfg`` (its ring over
    ``mesh``'s sp axis when ``cfg`` has one)."""
    config = ref_bert.BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
        max_seq_len=SEQ, dropout_rate=0.0, dtype=jnp.float32, use_flash_attention=False,
        moe_experts=4, moe_top_k=cfg["top_k"], causal=cfg.get("causal", False),
        ring_mesh=mesh if cfg.get("ring_mesh") else None, sp_impl=cfg.get("sp_impl", "ring"))
    return ref_bert._make(config, SEQ, "bert_moe")


def _bridge(tree) -> dict:
    tree = jax.tree.map(np.asarray, tree)
    return {k: v.numpy() for k, v in params_from_jax(tree, device="cpu").items()}


def _init(top_k=2) -> dict:
    """The reference sync trainer's init (``TrainState.create`` splits the
    seed's key), bridged."""
    return _bridge(_ref_model(_config(top_k=top_k)).init(
        jax.random.split(jax.random.PRNGKey(0))[0]))


def _data(rows=BATCH, seed=1) -> dict:
    """One global batch of tokens from the vocabulary's lower quarter (the
    skew that makes the routing drop assignments), repeated for each
    step."""
    x = np.random.default_rng(seed).integers(0, VOCAB // 4, size=(rows, SEQ)).astype(np.int32)
    x = np.concatenate([x] * STEPS)
    return {"features": x, "label": np.roll(x, -1, axis=1)}


def _kwargs(mesh, extra) -> dict:
    """The trainer's arguments: a global batch of ``BATCH`` rows (no data
    axis, so a data shard is the whole batch)."""
    return {"loss": LOSS, "batch_size": BATCH, "seed": 0, "mesh": mesh, **extra}


def _case(name) -> dict:
    mesh, cfg, extra, _ = ALL[name]
    config = _config(**cfg)
    return {"model": "moe", "config": config, "weights": _init(config["top_k"]),
            "data": _data(), "kwargs": _kwargs(mesh, extra), "trainer": "sync", "routes": 2}


def _four_cases() -> dict:
    cases = {name: _case(name) for name in FOUR}
    ck = {**cases["zero1_tp_ep"]["kwargs"], "checkpoint_dir": "ck",
          "checkpoint_interval_s": 1e9}
    cases["ck_first"] = {**cases["zero1_tp_ep"], "kwargs": ck, "rows": 2 * BATCH}
    cases["ck_resume"] = {**cases["zero1_tp_ep"], "kwargs": {**ck, "resume": True}}
    cases["publish_tp_ep"] = {**cases["tp_ep_top2"], "publish": 1}
    return cases


def _predict_case() -> dict:
    """The predictor's batch of 8 rows of 16 over sp=2: each rank runs the
    ring model on its 8 columns of every row."""
    return {"kind": "predict", "model": "moe", "config": _config(**RING),
            "weights": _init(), "features": _data()["features"][:BATCH],
            "batch_size": BATCH, "mesh": {"sp": 2}, "plain": False}


def _predict_tp_case() -> dict:
    """``ModelPredictor(mesh={"tp": 2})`` on the MoE model without a ring:
    the predictor keeps the weights whole, so each rank runs the 8 rows."""
    return {**_predict_case(), "config": _config(), "mesh": {"tp": 2}, "plain": True}


# The causal MoE gpt_tiny of the decode cases: 4 experts at top-2.
GPT = {"seq": 64, "vocab": VOCAB, "experts": 4, "top_k": 2}


def _ref_gpt():
    m = ref_bert.gpt_tiny(seq_len=GPT["seq"], vocab_size=VOCAB)
    return ref_bert._make(dataclasses.replace(m.config, dtype=jnp.float32, moe_experts=4,
                                              moe_top_k=2), GPT["seq"], "gpt_tiny")


GPT_REF = _ref_gpt()
GPT_VARS = GPT_REF.init(0)
GPT_PROMPTS = [np.random.default_rng(9).integers(0, VOCAB, size=(n,)).tolist()
               for n in (5, 9, 6, 12)]
GEN_PROMPT = np.random.default_rng(3).integers(0, VOCAB, size=(4, 6)).astype(np.int32)
NEW = 8


def _serve_case() -> dict:
    cases = {
        "generate": {**GPT, "generate": True, "mesh": {"tp": 2}, "prompt": GEN_PROMPT,
                     "new": NEW},
        "engine": {**GPT, "mesh": {"tp": 2}, "engine": {"slots": 1},
                   "requests": [(p, NEW, {}) for p in GPT_PROMPTS]},
    }
    weights = _bridge(GPT_VARS)
    return {"kind": "serve_mesh", "cases": {k: {**c, "weights": weights}
                                            for k, c in cases.items()}}


@time_limited(timeout=300)
def _spawn(workdir, world, cases, **more):
    return spawn_ranks(workdir, world, {"runs": {"kind": "pp_train", "cases": cases}, **more})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {2: _spawn(str(tmp_path_factory.mktemp("moetp2")), 2,
                      {name: _case(name) for name in TWO}, predict=_predict_case(),
                      predict_tp=_predict_tp_case(), serve=_serve_case()),
            4: _spawn(str(tmp_path_factory.mktemp("moetp4")), 4, _four_cases())}


def _ranks(runs, name):
    return [r["runs"][name] for r in runs[2 if name in TWO else 4]]


@pytest.fixture(scope="module")
def reference():
    """The reference's trainer per run of :data:`REFERENCE`: (history,
    final params bridged)."""
    cache = {}

    def get(name):
        if name not in cache:
            axes, cfg, extra = REFERENCE[name]
            mesh = _ref_mesh(axes)
            config = _config(**cfg)
            tr = ref.SynchronousDistributedTrainer(_ref_model(config, mesh),
                                                   **_kwargs(mesh, extra))
            trained = tr.train(ref.Dataset(_data()))
            cache[name] = (tr.history, _bridge(trained.variables))
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


def test_every_rank_joined(runs):
    assert [(r["world"], r["rank"]) for r in runs[2]] == [(2, 0), (2, 1)]
    assert [(r["world"], r["rank"]) for r in runs[4]] == [(4, r) for r in range(4)]


@pytest.mark.parametrize("name", sorted(ALL))
def test_training_matches_reference(runs, reference, name):
    """Each step's loss (with the aux term) and accuracy, and the final
    whole weights, against the reference's trainer."""
    want_history, want_weights = reference(ALL[name][3])
    for got in _ranks(runs, name):
        _assert_history(got["history"], want_history)
        assert got["weights"].keys() == want_weights.keys()
        for k, v in want_weights.items():
            np.testing.assert_allclose(got["weights"][k], v, atol=WEIGHT_ATOL, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("name", sorted(ALL) + ["ck_resume", "publish_tp_ep"])
def test_ranks_end_on_the_same_whole_weights(runs, name):
    ranks = _ranks(runs, name)
    init = _init(ALL.get(name, (None, {}))[1].get("top_k", 2))
    for rank in ranks:
        assert rank["history"] == ranks[0]["history"]
        for k, v in ranks[0]["weights"].items():
            assert rank["weights"][k].shape == init[k].shape
            np.testing.assert_array_equal(rank["weights"][k], v, err_msg=k)
    for leaf in ("router", "w_in", "w_out"):
        assert not np.array_equal(ranks[0]["weights"][f"layer_1.moe_mlp.{leaf}"],
                                  init[f"layer_1.moe_mlp.{leaf}"]), leaf


@pytest.mark.parametrize("name", sorted(ALL))
def test_routing_drops_and_agrees_across_shards(runs, name):
    """The first step's routing of both layers: assignments are dropped (the
    seat order decides which), and the ranks that hold the same tokens (a
    tp or ep group, every rank at tp x ep) pick the same experts and seats,
    bitwise."""
    mesh = ALL[name][0]
    top_k = ALL[name][1].get("top_k", 2)
    ranks = _ranks(runs, name)
    for rank in ranks:
        assert len(rank["routes"]) == 2
        for dispatch in rank["routes"]:
            assert 0 < dispatch.sum() < dispatch.shape[0] * top_k
    layout = make_mesh(mesh, devices=list(range(len(ranks))))
    pairs = [(r, q) for r in range(len(ranks)) for q in range(r + 1, len(ranks))
             if layout.coords(q).get("sp", 0) == layout.coords(r).get("sp", 0)]
    assert pairs or mesh == {"sp": 2}
    for r, q in pairs:
        for mine, theirs in zip(ranks[r]["routes"], ranks[q]["routes"]):
            np.testing.assert_array_equal(mine, theirs)


def test_zero1_resume_equals_the_uninterrupted_run(runs):
    """Zero1 at tp=2 x ep=2: two steps saved whole (each expert leaf and its
    optimizer moments gathered over the joint (ep, tp) group), then a
    resume that cuts the saved state back to each rank's two-axis part:
    the same history and weights as three steps in one run, bitwise."""
    for first, resumed, whole in zip(_ranks(runs, "ck_first"), _ranks(runs, "ck_resume"),
                                     _ranks(runs, "zero1_tp_ep")):
        assert first["saved_steps"] == [2]
        assert resumed["saved_steps"] == [2, 3]
        assert first["history"] + resumed["history"] == whole["history"]
        for k, v in whole["weights"].items():
            np.testing.assert_array_equal(resumed["weights"][k], v, err_msg=k)


def test_publisher_publishes_the_whole_weights(runs):
    """A publisher during tp x ep training: rank 0 publishes the gathered
    whole weights every step; the last publish is the returned weights."""
    rank0 = _ranks(runs, "publish_tp_ep")[0]
    assert rank0["published"] == STEPS
    for k, v in rank0["weights"].items():
        np.testing.assert_array_equal(rank0["last_published"][k], v, err_msg=k)
    assert rank0["history"] == _ranks(runs, "tp_ep_top2")[0]["history"]


def test_sp_predictor_routes_the_whole_batch(runs):
    """``ModelPredictor(mesh={"sp": 2})`` on the MoE model with a ring over
    sp: each rank runs its columns of the 8 rows, and the routing seats the
    8 x 16 tokens as one batch in row-major order, so both ranks return the
    reference's plain apply on the whole batch. The batch drops
    assignments (the training cases assert it on the same rows)."""
    c = _predict_case()
    ref_model = _ref_model(c["config"])
    variables = ref_model.init(jax.random.split(jax.random.PRNGKey(0))[0])
    want = np.asarray(ref_model.apply(variables, jnp.asarray(c["features"]))[0])
    for rank in runs[2]:
        assert rank["predict"]["mesh"].shape == want.shape
        np.testing.assert_allclose(rank["predict"]["mesh"], want, atol=LOGIT_ATOL, rtol=0)


def test_tp_predictor_routes_the_whole_batch(runs):
    """``ModelPredictor(mesh={"tp": 2})`` on the MoE model: every rank
    returns the one-process prediction bitwise, and the reference's plain
    apply on the whole batch within the stated bound."""
    c = _predict_tp_case()
    ref_model = _ref_model(c["config"])
    variables = ref_model.init(jax.random.split(jax.random.PRNGKey(0))[0])
    want = np.asarray(ref_model.apply(variables, jnp.asarray(c["features"]))[0])
    for rank in runs[2]:
        np.testing.assert_array_equal(rank["predict_tp"]["mesh"], rank["predict_tp"]["plain"])
        np.testing.assert_allclose(rank["predict_tp"]["mesh"], want, atol=LOGIT_ATOL, rtol=0)


def _want_tokens(prompt, n):
    return np.asarray(ref_generate(GPT_REF, GPT_VARS, np.asarray(prompt, np.int32), n,
                                   greedy=True))


def test_tp_generate_and_engine_give_the_reference_tokens(runs):
    """A causal MoE gpt_tiny at tp=2 (``w_in``/``w_out`` split over tp, the
    layer's partial sums added over it): batch-parallel ``generate(mesh=)``
    routes each step's tokens of the whole batch and gives the reference's
    unsharded greedy tokens; the sharded engine at slots 1 gives the
    reference's ``generate`` of each prompt alone."""
    gen = runs[2][0]["serve"]["generate"]
    np.testing.assert_array_equal(gen["greedy"], _want_tokens(GEN_PROMPT, NEW))
    for rank in runs[2]:
        np.testing.assert_array_equal(rank["serve"]["generate"]["greedy"], gen["greedy"])
    outs = runs[2][0]["serve"]["engine"]["outs"]
    assert outs == [_want_tokens([p], NEW)[0].tolist() for p in GPT_PROMPTS]


def test_refusals_are_the_references():
    """What stays refused is what the reference refuses: serving over an sp
    axis (its message, word for word) and ``PipelineTrainer`` over axes
    other than dp, pp and ep; an MoE ``BertConfig`` with ``tp_mesh`` and
    ``seq_mesh`` builds."""
    for shape in ({"tp": 1, "sp": 2}, {"tp": 2, "sp": 2}):
        with pytest.raises(ValueError) as want:
            ref_serving_mesh(shape, devices=jax.devices()[:4])
        with pytest.raises(ValueError) as got:
            serving_mesh(shape, devices=list(range(4)))
        assert str(got.value) == str(want.value)
    model = with_weights(moe_model(_config()), _init())
    with pytest.raises(ValueError, match="trains over dp, pp and ep"):
        dk.PipelineTrainer(model, mesh=make_mesh({"pp": 1, "tp": 2}, devices=[0, 1]),
                           device="cpu")._pipeline_mesh()
    one = make_mesh({"tp": 1, "sp": 1}, devices=[0])
    cfg = bert.BertConfig(moe_experts=4, moe_top_k=2, tp_mesh=one, seq_mesh=one)
    assert "layer_0.moe_mlp.w_in" in bert._make(cfg, 16, "moe").module.state_dict()
