"""The rest of the port's sequence parallelism, over gloo ranks on the CPU,
against the reference on as many of its 8 virtual devices:

- the XLA sequence split: ``SynchronousDistributedTrainer(shard_sequence=True)``
  on a model without ``ring_mesh`` (reference ``trainers.py:634-657``;
  ``tests/test_sharding.py:237-256``) on ``{"sp": 2}`` (dense attention as
  the reference's test runs it, causal and not, and flash) and on
  ``{"dp": 2, "sp": 2}``;
- a ring model on ``{"sp": 2, "tp": 2}`` with ``sp_impl`` ``"ring"``,
  ``"ring_stripe"`` and ``"ulysses"``;
- ``ModelPredictor(mesh=)`` of a ring model over ``{"dp": 2, "sp": 2}``.

Two spawns for the module (``tests/torch_dp_worker.py``; runners ``train``
and ``predict``), of 2 ranks and of 4. The models are small (hidden 32, 2
layers, 4 heads, vocab 64), trained at 16 tokens under a ``max_seq_len`` of
32, dropout 0, from the reference's init for seed 0 bridged across; the
fused loss; the trainer's default optimizer (adagrad); float32.

Tolerances (``tests/test_torch_sequence_parallel.py``'s): each step's loss
to 1e-5 relative, accuracy to 1e-6, the final weights to 2e-6 absolute
against the reference's trainer on the same mesh; against the port's own
one-process run of the plain model on the same global batches, loss 1e-6
and weights 5e-7; the ranks end on the same whole weights bitwise. The
predictor's logits: 2e-5 absolute against the reference's predictor over
the same mesh (float32 summation order; logits O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import distkeras_tpu as ref
import distkeras_tpu_torch as dk
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.models.core import TrainedModel as RefTrainedModel
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_dp_worker import sp_model, spawn_ranks, with_weights
from torch_time_limit import time_limited

LOGITS_ATOL = 2e-5
LOSS_RTOL, ACC_ATOL, WEIGHT_ATOL = 1e-5, 1e-6, 2e-6
ONE_LOSS_RTOL, ONE_WEIGHT_ATOL = 1e-6, 5e-7
SEQ, MAX_SEQ, VOCAB, ROWS = 16, 32, 64, 16
KWARGS = dict(loss="fused_categorical_crossentropy", batch_size=4, num_epoch=1, seed=0,
              shard_sequence=True)

# name -> (sp_impl or None for the XLA split, causal, flash, mesh)
CONFIGS = {
    "xla": (None, True, False, {"sp": 2}),
    "xla_full": (None, False, False, {"sp": 2}),
    "xla_flash": (None, True, True, {"sp": 2}),
    "xla_dp": (None, True, False, {"dp": 2, "sp": 2}),
    "tp_ring": ("ring", True, True, {"sp": 2, "tp": 2}),
    "tp_ring_stripe": ("ring_stripe", True, True, {"sp": 2, "tp": 2}),
    "tp_ulysses": ("ulysses", True, True, {"sp": 2, "tp": 2}),
}
TWO = ("xla", "xla_full", "xla_flash")
FOUR = ("xla_dp", "tp_ring", "tp_ring_stripe", "tp_ulysses")
PREDICT = {"predict_ring": "ring", "predict_ring_stripe": "ring_stripe"}


def _config(name) -> dict:
    impl, causal, flash, mesh = CONFIGS[name]
    return {"vocab": VOCAB, "hidden": 32, "heads": 4, "max_seq_len": MAX_SEQ, "seq": SEQ,
            "causal": causal, "dtype": "float32", "flash": flash,
            "ring_mesh": mesh if impl else None, "sp_impl": impl or "ring"}


def _ref_model(name, mesh, impl=None):
    """The reference's model of ``name`` with ``ring_mesh=mesh`` (None:
    the plain model)."""
    _, causal, flash, _ = CONFIGS[name]
    cfg = ref_bert.BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
        max_seq_len=MAX_SEQ, dropout_rate=0.0, causal=causal, dtype=jnp.float32,
        use_flash_attention=flash, ring_mesh=mesh, sp_impl=impl or "ring")
    return ref_bert._make(cfg, SEQ, "bert_sp")


def _ref_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ref_make_mesh(axes, devices=jax.devices()[:n])


def _bridge(variables) -> dict:
    tree = jax.tree.map(np.asarray, variables)
    return {k: v.numpy() for k, v in params_from_jax(tree, device="cpu").items()}


def _ref_init(name):
    return _ref_model(name, None).init(jax.random.split(jax.random.PRNGKey(0))[0])


def _init(name) -> dict:
    """The reference's init for seed 0 (``TrainState.create``'s key), bridged."""
    return _bridge(_ref_init(name)["params"])


def _data(rows=ROWS, seed=1) -> dict:
    x = np.random.default_rng(seed).integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
    return {"features": x, "label": np.roll(x, -1, axis=1)}


def _rows(name) -> int:
    return ROWS * CONFIGS[name][3].get("dp", 1)


def _train_cases(names) -> dict:
    return {name: {"kind": "train", "model": "sp", "config": _config(name),
                   "weights": _init(name), "data": _data(_rows(name)),
                   "kwargs": {**KWARGS, "mesh": CONFIGS[name][3]}, "trace": True}
            for name in names}


def _predict_cases() -> dict:
    cases = {}
    for case, impl in PREDICT.items():
        cfg = {**_config("tp_ring"), "ring_mesh": {"dp": 2, "sp": 2}, "sp_impl": impl}
        cases[case] = {"kind": "predict", "model": "sp", "config": cfg,
                       "weights": _init("tp_ring"), "features": _data(12, seed=3)["features"],
                       "batch_size": 8, "mesh": {"dp": 2, "sp": 2}, "plain": False}
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two = time_limited(timeout=300)(spawn_ranks)(
        str(tmp_path_factory.mktemp("xsp2")), 2, _train_cases(TWO))
    four = time_limited(timeout=300)(spawn_ranks)(
        str(tmp_path_factory.mktemp("xsp4")), 4, {**_train_cases(FOUR), **_predict_cases()})
    return {name: [r[name] for r in (two if name in TWO else four)]
            for name in (*TWO, *FOUR, *PREDICT)} | {"ranks": (two, four)}


@pytest.fixture(scope="module")
def reference():
    """The reference's SynchronousDistributedTrainer with
    ``shard_sequence=True`` on the case's mesh: (history, final params
    bridged)."""
    cache = {}

    def get(name):
        if name not in cache:
            impl, _, _, axes = CONFIGS[name]
            mesh = _ref_mesh(axes)
            tr = ref.SynchronousDistributedTrainer(
                _ref_model(name, mesh if impl else None, impl), mesh=mesh, **KWARGS)
            trained = tr.train(ref.Dataset(_data(_rows(name))))
            cache[name] = (tr.history, _bridge(trained.variables["params"]))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def one_process():
    """The port alone (no process group, the plain model) on the same global
    batches: (history, final weights)."""
    cache = {}

    def get(name):
        if name not in cache:
            model = with_weights(sp_model({**_config(name), "ring_mesh": None}), _init(name))
            rows = _rows(name)
            kwargs = {**KWARGS, "shard_sequence": False,
                      "batch_size": KWARGS["batch_size"] * rows // ROWS}
            tr = dk.SynchronousDistributedTrainer(model, num_workers=1, device="cpu", **kwargs)
            trained = tr.train(dk.Dataset.from_arrays(**_data(rows)))
            cache[name] = (tr.history, {k: v.numpy() for k, v in trained.variables.items()})
        return cache[name]

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
    two, four = runs["ranks"]
    assert [(r["world"], r["rank"]) for r in two] == [(2, 0), (2, 1)]
    assert [(r["world"], r["rank"]) for r in four] == [(4, r) for r in range(4)]


@pytest.mark.parametrize("name", TWO + FOUR)
def test_training_matches_reference(runs, reference, name):
    """Per-step loss and accuracy (the global batch's, on every rank) and
    the final whole weights against the reference's trainer on the same
    mesh: the XLA split on sp and dp x sp, and the three ring
    implementations on sp x tp."""
    want_history, want_weights = reference(name)
    for got in runs[name]:
        _assert_history(got["history"], want_history)
        _assert_weights(got["weights"], want_weights)


@pytest.mark.parametrize("name", TWO + FOUR)
def test_training_equals_one_process(runs, one_process, name):
    """The split run against the port alone, the plain model, on the same
    global batches."""
    want_history, want_weights = one_process(name)
    for got in runs[name]:
        _assert_history(got["history"], want_history, ONE_LOSS_RTOL)
        _assert_weights(got["weights"], want_weights, ONE_WEIGHT_ATOL)


@pytest.mark.parametrize("name", TWO + FOUR)
def test_ranks_end_on_the_same_whole_weights(runs, name):
    """Every rank returns the whole weights (pos_embed gathered over sp, the
    tp leaves over tp) and the same ones."""
    ranks = runs[name]
    init = _init(name)
    for rank in ranks:
        assert rank["history"] == ranks[0]["history"]
        for k, v in ranks[0]["weights"].items():
            assert rank["weights"][k].shape == init[k].shape
            np.testing.assert_array_equal(rank["weights"][k], v, err_msg=k)


@pytest.mark.parametrize("name", TWO + FOUR)
def test_attention_ran_over_sp(runs, name):
    """The split really ran: every attention layer of the XLA split gathered
    over sp once a step forward and once backward (2 layers, 4 steps), and
    the rings moved K/V between the sp ranks (sp_permute or sp_all_to_all)
    and gathered nothing; the tp leaves stayed split (tp collectives ran)."""
    impl = CONFIGS[name][0]
    for got in runs[name]:
        spans = got["spans"]
        if impl is None:
            assert spans["sp_all_gather"] == 2 * 2 * len(got["history"])
        else:
            assert "sp_all_gather" not in spans
            assert spans.get("sp_permute" if impl != "ulysses" else "sp_all_to_all", 0) > 0
            assert spans.get("tp_all_reduce", 0) > 0


@pytest.mark.parametrize("case", sorted(PREDICT))
def test_predictor_over_an_sp_mesh_matches_reference(runs, case):
    """ModelPredictor(mesh={dp: 2, sp: 2}) of a ring model: every rank
    returns the whole [N, S, V] logits (rows over dp, columns over sp, the
    last batch padded and trimmed), the same on every rank, against the
    reference's predictor of its ring model over the same mesh."""
    impl = PREDICT[case]
    mesh = _ref_mesh({"dp": 2, "sp": 2})
    model = _ref_model("tp_ring", mesh, impl)
    features = _data(12, seed=3)["features"]
    pred = ref.ModelPredictor(RefTrainedModel(model, _ref_init("tp_ring")), batch_size=8,
                              mesh=mesh)
    want = np.asarray(pred.predict(ref.Dataset({"features": features}))["prediction"])
    got = runs[case][0]["mesh"]
    assert got.shape == want.shape == (12, SEQ, VOCAB)
    for rank in runs[case]:
        np.testing.assert_array_equal(rank["mesh"], got)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_ulysses_with_tp_needs_local_heads_to_divide():
    """Ulysses on {sp: 2, tp: 2} runs over the rank's H/tp heads: 2 heads
    at tp=2 leave 1 a rank, which sp=2 does not divide; the port raises
    the reference's message."""
    import dataclasses

    import torch

    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"sp": 2, "tp": 2}, devices=list(range(4)))
    cfg = bert.BertConfig(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=2,
                          mlp_dim=64, max_seq_len=MAX_SEQ, dropout_rate=0.0,
                          dtype=torch.float32, sp_impl="ulysses")
    q = torch.zeros(1, 4, 1, 16)  # this rank's 2/tp heads
    with pytest.raises(ValueError, match="ulysses_attention needs num_heads % sp == 0"):
        bert._sp_attention(dataclasses.replace(cfg, ring_mesh=mesh, tp_mesh=mesh), q, q, q)


def test_seq_mesh_checks():
    """BertConfig.seq_mesh (the port's field for the XLA split) takes a
    port Mesh with an sp axis, and not together with ring_mesh; an MoE
    config takes it too (``tests/test_torch_moe_tp_sp.py`` trains one)."""
    from distkeras_tpu_torch.models import bert
    from distkeras_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"sp": 2}, devices=[0, 1])
    with pytest.raises(TypeError, match="seq_mesh must be a distkeras_tpu_torch Mesh"):
        bert.BertConfig(seq_mesh=object())
    with pytest.raises(ValueError, match="has no 'sp' axis"):
        bert.BertConfig(seq_mesh=make_mesh({"tp": 2}, devices=[0, 1]))
    with pytest.raises(ValueError, match="give one of them"):
        bert.BertConfig(seq_mesh=mesh, ring_mesh=mesh)
    assert bert.BertConfig(seq_mesh=mesh, moe_experts=4).seq_mesh is mesh
    with pytest.raises(ValueError, match="give one of them"):
        bert.BertConfig(seq_mesh=mesh, ring_mesh=mesh, moe_experts=4)
    assert bert.BertConfig(seq_mesh=mesh).seq_mesh is mesh
