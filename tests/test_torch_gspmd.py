"""The port's sharding rules and model-parallel pieces that need no process
group, against the reference's: ``fsdp_sharding_for`` on a table of
shapes, every bert leaf's part under tp (``infer_variable_shardings`` after
the bridge's transpose), ``batch_sharding``, the vocab-65 refusal,
``constrain_heads``, and ``sharded_train_state`` on one rank. Placements
are compared as the part (the index ranges) a rank holds. The multi-rank
runs are in ``tests/test_torch_model_parallel.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.parallel import gspmd as ref_gspmd
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu.parallel.sharding import infer_variable_shardings as ref_infer
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops.attention import constrain_heads
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.parallel import gspmd
from distkeras_tpu_torch.parallel.mesh import make_mesh
from distkeras_tpu_torch.parallel.sharding import infer_variable_shardings
from distkeras_tpu_torch.utils.bridge import params_from_jax


def mlp(dim, hidden, classes) -> Model:
    return Model(lambda: MLP(dim, hidden, classes, compute_dtype=torch.float32),
                 input_shape=(dim,), output_dim=classes)


def _meshes(axes: dict):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, devices=list(range(n))), ref_make_mesh(axes, devices=jax.devices()[:n])


def _ranges(index, shape):
    return [s.indices(size)[:2] for s, size in zip(index, shape)]


def _assert_same_parts(got, want, shape):
    """Every rank's part of a tensor of ``shape`` under the port's sharding
    ``got`` equals the reference's ``want`` on the same device."""
    devices = want.mesh.devices.reshape(-1)
    wanted = want.devices_indices_map(shape)
    for rank, device in enumerate(devices):
        assert _ranges(got.index(shape, rank), shape) == _ranges(wanted[device], shape), rank


FSDP_SHAPES = [
    (8,), (100,), (128, 128), (127, 128), (128, 127), (129, 129), (3, 5, 7), (256, 256),
    (64, 512), (512, 64), (30522, 768), (768, 30522), (1, 512, 768), (3072, 768),
    (4, 4096), (5, 4096), (16384,), (16383,), (6, 6, 1000),
]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", FSDP_SHAPES, ids=str)
def test_fsdp_sharding_for_matches_reference(shape, n):
    """Under 2^14 elements, no dimension dividing, ties (the first of the
    largest), and a mesh without the axis."""
    got_mesh, want_mesh = _meshes({"fsdp": n})
    got = gspmd.fsdp_sharding_for(got_mesh, shape)
    want = ref_gspmd.fsdp_sharding_for(want_mesh, shape)
    assert got.spec == tuple(want.spec)[:len(got.spec)] or (got.is_replicated and not any(
        want.spec))
    _assert_same_parts(got, want, shape)
    got_dp, want_dp = _meshes({"dp": n})
    assert gspmd.fsdp_sharding_for(got_dp, shape).is_replicated
    assert not any(ref_gspmd.fsdp_sharding_for(want_dp, shape).spec)


def _ref_bert_shardings(axes, vocab=256):
    model = ref_bert.bert_tiny_mlm(seq_len=32, vocab_size=vocab)
    abstract = jax.eval_shape(model.boxed_init, jax.random.PRNGKey(0))
    n = int(np.prod(list(axes.values())))
    mesh = ref_make_mesh(axes, devices=jax.devices()[:n])
    return jax.eval_shape(model.init, jax.random.PRNGKey(0)), ref_infer(mesh, abstract)


@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 4}, {"dp": 2, "tp": 2}],
                         ids=lambda a: ",".join(f"{k}{v}" for k, v in a.items()))
def test_bert_leaf_parts_match_reference(axes):
    """Every bert_tiny_mlm leaf's part on each rank under the port's rules
    (the table in ``models/bert.py``) has the shape of the reference's part
    after the bridge's transpose (a flax kernel ``[in, out]`` is a torch
    weight ``[out, in]``), and the parts of the split leaves differ per tp
    rank as the reference's do."""
    shapes, shardings = _ref_bert_shardings(axes)
    got_mesh, _ = _meshes(axes)
    whole = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                            device="cpu")
    got = infer_variable_shardings(got_mesh, whole, bert.param_axes)
    assert got.keys() == whole.keys()
    n = int(np.prod(list(axes.values())))
    for rank in range(n):
        device = jax.devices()[rank]
        parts = jax.tree.map(
            lambda s, a: np.zeros(
                [len(range(*sl.indices(d))) for sl, d in zip(
                    s.devices_indices_map(a.shape)[device], a.shape)], a.dtype),
            shardings["params"], shapes["params"],
            is_leaf=lambda x: hasattr(x, "devices_indices_map"))
        want = params_from_jax({"params": parts}, device="cpu")
        for k, sharding in got.items():
            index = sharding.index(whole[k].shape, rank)
            assert whole[k][index].shape == want[k].shape, (k, rank)
    split = {k for k, s in got.items() if not s.is_replicated}
    assert split == {k for k in whole if bert.param_axes(k) not in (None, (None, "seq", "embed"))}
    assert {k for k in split if k.endswith(".bias")} == set()


def test_unannotated_leaves_are_replicated():
    model = mlp(16, (256,), 2)
    m, _ = _meshes({"tp": 2})
    variables = model.init(0, device="cpu")
    got = infer_variable_shardings(m, variables, None)
    assert all(s.is_replicated for s in got.values())
    assert gspmd.variable_shardings(model, m, variables) == got
    fsdp, _ = _meshes({"fsdp": 2})
    split = {k for k, s in gspmd.variable_shardings(model, fsdp, variables).items()
             if not s.is_replicated}
    assert split == {k for k, v in variables.items() if v.numel() >= 1 << 14}


def test_vocab_that_does_not_divide_is_refused():
    """vocab 65 at tp=2: the reference's engine refuses it naming
    vocab_size (``tests/test_sharded_serving.py:113-116``), as does a
    placement in JAX."""
    odd = bert.gpt_tiny(seq_len=64, vocab_size=65)
    m, _ = _meshes({"tp": 2})
    with pytest.raises(ValueError, match="vocab_size") as e:
        infer_variable_shardings(m, odd.init(0, device="cpu"), bert.param_axes)
    assert str(e.value).startswith(("token_embed.weight", "mlm_bias")) and "65" in str(e.value)


@pytest.mark.parametrize("axes", [{"dp": 2}, {"fsdp": 2}, {"dp": 2, "fsdp": 2}, {"tp": 2},
                                  {"dp": 2, "tp": 2}],
                         ids=lambda a: ",".join(f"{k}{v}" for k, v in a.items()))
def test_batch_sharding_matches_reference(axes):
    got_mesh, want_mesh = _meshes(axes)
    for shape in ((16, 8), (16,), (16, 4, 3)):
        got = gspmd.batch_sharding(got_mesh, len(shape), seq_dim=None)
        want = ref_gspmd.batch_sharding(want_mesh, len(shape), seq_dim=None)
        _assert_same_parts(got, want, shape)


def test_batch_sharding_refuses_a_sequence_split():
    """The sequence split over sp resolves now (the name is kept from when
    it was refused): each rank's rows and columns are the reference's, on
    sp=2 and dp=2 x sp=2, with and without ``seq_dim``; a rank-1 label
    takes rows only."""
    for axes in ({"sp": 2}, {"dp": 2, "sp": 2}):
        got_mesh, want_mesh = _meshes(axes)
        for shape, seq_dim in (((8, 16), 1), ((8, 16), None), ((8,), 1), ((8, 16, 3), 1)):
            got = gspmd.batch_sharding(got_mesh, len(shape), seq_dim=seq_dim)
            want = ref_gspmd.batch_sharding(want_mesh, len(shape), seq_dim=seq_dim)
            _assert_same_parts(got, want, shape)
    m = make_mesh({"sp": 2}, devices=[0, 1])
    assert gspmd.batch_sharding(m, 2, seq_dim=1).spec == ("dp", "sp")
    assert gspmd.batch_sharding(m, 2, seq_dim=None).spec == ("dp", None)


@pytest.mark.parametrize("case", ["no_mesh", "no_axis", "one_rank", "heads_do_not_divide",
                                  "local_heads", "whole_heads"])
def test_constrain_heads(case):
    """Pass-through without a mesh, without the axis, at one rank or when
    the heads do not divide (reference ``ops/attention.py:52-56``); a leaf
    of this rank's heads passes; one of every head raises."""
    x = torch.zeros(2, 16, 4, 8)
    tp2 = make_mesh({"tp": 2}, devices=[0, 1])
    mesh, heads, leaf = {
        "no_mesh": (None, 8, x),
        "no_axis": (make_mesh({"dp": 2}, devices=[0, 1]), 8, x),
        "one_rank": (make_mesh({"tp": 1}, devices=[0]), 8, x),
        "heads_do_not_divide": (tp2, 3, x),
        "local_heads": (tp2, 8, x),
        "whole_heads": (tp2, 4, x),
    }[case]
    if case == "whole_heads":
        with pytest.raises(ValueError, match="holds 4 heads"):
            constrain_heads(leaf, mesh, heads)
    else:
        assert constrain_heads(leaf, mesh, heads) is leaf


def test_tp_mesh_config_checks():
    tp2 = make_mesh({"tp": 2}, devices=[0, 1])
    cfg = bert.BertConfig(num_heads=4, tp_mesh=tp2)
    assert cfg.tp_mesh is tp2
    with pytest.raises(ValueError, match="num_heads 3"):
        bert.BertConfig(num_heads=3, hidden_size=96, tp_mesh=tp2)
    lm = bert.with_tp_mesh(bert.gpt_tiny(), tp2)
    assert lm.config.tp_mesh is tp2 and lm.name == "gpt_tiny"
    cache = bert.decode_cache(dataclasses.replace(lm.config, decode=True), 2, "cpu")
    assert cache["layer_0.attention.cached_key"].shape == (2, 64, 2, 32)


@pytest.mark.parametrize("name", ["bert_tiny_mlm", "mlp"])
def test_sharded_train_state_on_one_rank_is_the_init(name):
    """Without a process group the mesh is one rank: every leaf whole, equal
    to ``Model.init``'s for the seed, and the step trains it as
    ``make_train_step`` does."""
    from distkeras_tpu_torch.training.step import TrainState, make_train_step

    model = bert.bert_tiny_mlm(seq_len=16, vocab_size=64, dropout_rate=0.0) if name != "mlp" \
        else mlp(16, (32,), 2)
    m = make_mesh({"dp": 1}, devices=[0])
    state, shardings = gspmd.sharded_train_state(model, get_optimizer("adam"), m, seed=5,
                                                 device="cpu")
    want = model.init(5, device="cpu")
    assert state.variables.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(state.variables[k], v), k
    assert all(s.is_replicated for s in shardings.values())
    rng = np.random.default_rng(0)
    if name == "mlp":
        batch = {"features": torch.as_tensor(rng.normal(size=(8, 16)).astype(np.float32)),
                 "label": torch.as_tensor(rng.integers(0, 2, size=(8,)))}
        loss = "sparse_categorical_crossentropy"
    else:
        ids = torch.as_tensor(rng.integers(0, 64, size=(4, 16)))
        batch = {"features": ids, "label": ids}
        loss = "fused_categorical_crossentropy"
    plain = TrainState.create(model, get_optimizer("adam"), 5, "cpu")
    _, want_m = make_train_step(model, loss)(plain, batch)
    _, got_m = gspmd.make_sharded_train_step(model, loss, m)(state, batch)
    assert {k: v.item() for k, v in got_m.items()} == {k: v.item() for k, v in want_m.items()}
    for k in plain.params:
        assert torch.equal(state.params[k], plain.params[k]), k


@pytest.mark.parametrize("kwargs, item", [
    pytest.param({"mesh": {"pp": 2}}, "needs 2 ranks but the process group has 1",
                 id="pp-A10d"),
    pytest.param({"mesh": {"tp": 2, "ep": 2}}, "needs 4 ranks but the process group has 1",
                 id="ep-A12"),
])
def test_unported_axes_name_their_item(kwargs, item):
    """Every axis of the later items is ported, so the sync trainer refuses
    none by name: the sp axis with the reference's XLA sequence split
    (``tests/test_torch_xla_sp.py``); the ep axis (A12) with tp or sp too
    (``tests/test_torch_moe_tp_sp.py``); the pp axis (A10d), over which the
    sync trainer trains replicated, as the reference's does
    (``tests/test_torch_pipeline_trainer.py`` trains it on 2 ranks). In one
    process each such mesh meets the rank count's check instead."""
    from distkeras_tpu_torch import Dataset, SynchronousDistributedTrainer

    model = bert.bert_tiny_mlm(seq_len=16, vocab_size=64, dropout_rate=0.0)
    ids = np.zeros((4, 16), np.int32)
    tr = SynchronousDistributedTrainer(model, device="cpu",
                                       loss="fused_categorical_crossentropy", **kwargs)
    with pytest.raises(ValueError, match=item):
        tr.train(Dataset.from_arrays(features=ids, label=ids))
