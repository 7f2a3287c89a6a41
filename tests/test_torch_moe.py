"""The port's MoE (``ops/moe.py``, the bert family's ``moe_experts``)
against the reference's, on bridged weights, in one process on the CPU.

Every case of the reference's ``tests/test_moe.py`` at top-1 and at top-2:
ample capacity against the per-token gather, drops passing through, second
choices dropped first, the gradients of ``router``, ``w_in`` and ``w_out``
against ``jax.grad``, the aux loss returned and added; then
``bert_tiny_moe_mlm``'s logits and aux, the train step and ``SingleTrainer``
against the reference's, and the bridge both ways.

Tolerances (float32): the block's output to 1e-5 absolute, its aux loss to
1e-6 relative, each gradient to 1e-5 relative in norm (the same float32
arithmetic in another order: the observed gaps are ~2e-7, ~1e-7 and
~3e-7). The model's logits keep the port's stated envelope: 7e-7 in
float32 and one bfloat16 ulp (0.0078) in bfloat16 (the observed gaps are
4.5e-7 and 0.0061 at logits below 0.72 in magnitude). The training runs
keep the envelope of ``tests/test_torch_training.py`` (each step's loss to
1e-5 relative, the weights to 2e-6 absolute).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distkeras_tpu.data.dataset import Dataset as RefDataset
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.ops.losses import get_optimizer as ref_get_optimizer
from distkeras_tpu.ops.moe import MoEMLP as RefMoEMLP
from distkeras_tpu.parallel.mesh import make_mesh as ref_make_mesh
from distkeras_tpu.parallel.sharding import infer_variable_shardings as ref_infer
from distkeras_tpu.training.step import TrainState as RefTrainState
from distkeras_tpu.training.step import make_train_step as ref_make_train_step
from distkeras_tpu.training.trainers import SingleTrainer as RefSingleTrainer
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.core import TrainedModel
from distkeras_tpu_torch.ops import moe
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.ops.moe import MoEMLP
from distkeras_tpu_torch.parallel.mesh import make_mesh
from distkeras_tpu_torch.parallel.sharding import infer_variable_shardings
from distkeras_tpu_torch.training.step import TrainState, make_train_step
from distkeras_tpu_torch.training.trainers import SingleTrainer
from distkeras_tpu_torch.utils.bridge import params_from_jax, params_to_jax

OUT_ATOL, AUX_RTOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5
LOGIT_ATOL = {"float32": 7e-7, "bfloat16": 0.0078125}
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 2e-6
E, D, M = 4, 16, 32
SEQ, VOCAB = 16, 64
TOPK = pytest.mark.parametrize("top_k", [1, 2], ids=["top1", "top2"])
FACTORS = pytest.mark.parametrize("factor", [8.0, 0.5, 1e-4], ids=["ample", "tight", "one"])


def _build(top_k, factor=8.0, seed=0, experts=E):
    """The reference block, its float32 weights, an input, and the port
    block of the same fields."""
    ref = RefMoEMLP(num_experts=experts, mlp_dim=M, capacity_factor=factor,
                    dtype=jnp.float32, router_top_k=top_k)
    x = np.random.default_rng(seed).normal(size=(2, 8, D)).astype(np.float32)
    variables = nn.meta.unbox(dict(ref.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    variables.pop("aux_loss", None)  # the init's own apply sows one
    port = MoEMLP(experts, M, D, capacity_factor=factor, dtype=torch.float32,
                  router_top_k=top_k)
    return ref, variables, x, port


def _weights(variables):
    return {k: torch.tensor(np.asarray(v)) for k, v in variables["params"].items()}


def _ref_apply(ref, variables, x):
    out, state = ref.apply(variables, jnp.asarray(x), mutable=["aux_loss"])
    aux = float(sum(np.sum(np.asarray(leaf)) for leaf in jax.tree.leaves(state["aux_loss"])))
    return np.asarray(out), aux


def _port_apply(port, weights, x):
    out, aux = torch.func.functional_call(port, weights, (torch.tensor(x),))
    return out.detach().numpy(), aux.item()


@TOPK
@FACTORS
def test_block_matches_reference(top_k, factor):
    """Output and aux loss against the reference's block, with ample
    capacity, drops (0.5) and one seat an expert (1e-4)."""
    ref, variables, x, port = _build(top_k, factor)
    want, want_aux = _ref_apply(ref, variables, x)
    got, got_aux = _port_apply(port, _weights(variables), x)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL, rtol=0)
    assert got_aux == pytest.approx(want_aux, rel=AUX_RTOL)


@TOPK
def test_ample_capacity_matches_per_token_reference(top_k):
    """Nothing dropped: the dispatch-tensor block equals the per-token
    gather, the port's and the reference's alike; top-2 differs from top-1."""
    ref, variables, x, port = _build(top_k)
    got, _ = _port_apply(port, _weights(variables), x)
    gather = MoEMLP.reference_forward(_weights(variables), torch.tensor(x), top_k).numpy()
    want = np.asarray(RefMoEMLP.reference_forward(variables, jnp.asarray(x), top_k))
    np.testing.assert_allclose(gather, want, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got, gather, atol=1e-4, rtol=1e-4)  # the reference test's bound
    if top_k == 2:
        one = MoEMLP.reference_forward(_weights(variables), torch.tensor(x), 1).numpy()
        assert np.abs(gather - one).max() > 1e-5


@TOPK
def test_capacity_drops_pass_through(top_k):
    """One seat an expert: overflowing tokens keep their input exactly."""
    _, variables, x, port = _build(top_k, factor=1e-4)
    got, _ = _port_apply(port, _weights(variables), x)
    assert np.isfinite(got).all()
    same = (got == x).all(-1).reshape(-1)
    assert same.sum() > 0
    # Each expert seats at most its capacity's tokens (times top_k choices).
    assert (~same).sum() <= E * moe.capacity(16, E, 1e-4, top_k) * top_k


def test_second_choices_dropped_first():
    """Tight top-2 capacity: per expert every first choice takes its seat
    before any second choice, so a second choice seats only where the
    expert's first choices left room; the output then differs from the
    uncapped gather but stays finite."""
    _, variables, x, port = _build(2, factor=0.5)
    w = _weights(variables)
    tokens = torch.tensor(x).reshape(-1, D)
    cap = moe.capacity(16, E, 0.5, 2)
    _, _, (d1, d2), _ = moe._route(tokens, w["router"], E, 2, 0.5, None)
    first = torch.softmax(tokens @ w["router"], -1).argmax(-1)
    for e in range(E):
        n1 = int((first == e).sum())
        seated1, seated2 = d1[:, e].sum().item(), d2[:, e].sum().item()
        assert seated1 == min(n1, cap)
        assert seated2 == 0 or seated1 == n1  # a second choice only after every first
        slots1 = d1[:, e].nonzero()[:, 1].tolist()
        slots2 = d2[:, e].nonzero()[:, 1].tolist()
        assert not slots2 or max(slots1, default=-1) < min(slots2)
    got, _ = _port_apply(port, w, x)
    gather = MoEMLP.reference_forward(w, torch.tensor(x), 2).numpy()
    assert np.isfinite(got).all() and np.abs(got - gather).max() > 1e-6


@pytest.mark.parametrize("tokens,experts,factor,top_k,want", [
    (16, 4, 1.25, 1, 5), (10, 4, 1.25, 1, 3), (10, 4, 1.25, 2, 6), (16, 4, 1e-4, 1, 1),
    (4096, 8, 1.25, 2, 1280), (7, 3, 1.0, 2, 4),
])
def test_capacity_truncates_as_the_reference_code(tokens, experts, factor, top_k, want):
    """``max(1, int(T / E · factor · top_k))``: ``int`` truncates (10 tokens
    over 4 experts at 1.25 give 3 seats, where ceil would give 4)."""
    assert moe.capacity(tokens, experts, factor, top_k) == want
    assert want == max(1, int(tokens / experts * factor * top_k))


@TOPK
def test_router_ties_go_to_the_first_index(top_k):
    """A zero router: every gate ties at 1/E; ``argmax`` takes expert 0
    (and expert 1 second), in both packages, so the first choices' load is
    all on expert 0 and the aux loss is ``E · 1 · 1/E = 1``."""
    ref, variables, x, port = _build(top_k)
    variables = {"params": {**variables["params"],
                            "router": jnp.zeros_like(variables["params"]["router"])}}
    want, want_aux = _ref_apply(ref, variables, x)
    got, got_aux = _port_apply(port, _weights(variables), x)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL, rtol=0)
    assert got_aux == pytest.approx(want_aux, rel=AUX_RTOL) and got_aux == pytest.approx(1.0)


@TOPK
@FACTORS
def test_gradients_match_jax_grad(top_k, factor):
    """The gradients of ``router``, ``w_in`` and ``w_out`` (and of the input)
    of ``mean(y²) + 0.5·aux`` against ``jax.grad``'s; each is nonzero."""
    ref, variables, x, port = _build(top_k, factor)

    def loss(v, xx):
        out, state = ref.apply(v, xx, mutable=["aux_loss"])
        return jnp.mean(out ** 2) + 0.5 * sum(jnp.sum(a) for a in jax.tree.leaves(state))

    want, want_x = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(x))
    weights = {k: v.requires_grad_() for k, v in _weights(variables).items()}
    xt = torch.tensor(x).requires_grad_()
    y, aux = torch.func.functional_call(port, weights, (xt,))
    ((y ** 2).mean() + 0.5 * aux).backward()
    for k in ("router", "w_in", "w_out"):
        w, g = np.asarray(want["params"][k]), weights[k].grad.numpy()
        assert np.linalg.norm(w) > 0, k
        assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w), k
    w = np.asarray(want_x)
    assert np.linalg.norm(xt.grad.numpy() - w) <= GRAD_RTOL * np.linalg.norm(w)


def test_ep_refuses_indivisible_experts():
    """The reference's message for experts that do not divide over ep."""
    ref = RefMoEMLP(num_experts=4, mlp_dim=M, dtype=jnp.float32, ep_axis="ep", ep_size=3)
    x = jnp.zeros((1, 4, D), jnp.float32)
    with pytest.raises(ValueError) as want:
        jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), x))
    port = MoEMLP(4, M, D, dtype=torch.float32, ep_group=object(), ep_size=3)
    with pytest.raises(ValueError) as got:
        port.to_empty(device="cpu")(torch.zeros(1, 4, D))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="router_top_k must be 1 or 2, got 3"):
        MoEMLP(4, M, D, router_top_k=3).to_empty(device="cpu")(torch.zeros(1, 4, D))


def test_expert_leaves_split_over_ep():
    """``PARAM_AXES``' MoE rows give ``w_in`` and ``w_out`` the reference's
    logical axes, and on a dp=2 x ep=4 mesh every rank's part of each is the
    one the reference places on that device (2 of 8 experts); the router
    has no axes and every rank holds it whole, as on the pipe's ep path."""
    ref = ref_bert.bert_tiny_moe_mlm(seq_len=SEQ, vocab_size=VOCAB, num_experts=8)
    boxed = ref.boxed_init(jax.random.PRNGKey(0))["params"]
    flat = dict(jax.tree_util.tree_flatten_with_path(
        nn.get_partition_spec(boxed), is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0])
    experts = 0
    for path, spec in flat.items():
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        if ".moe_mlp." in name:
            want = None if name.endswith(".router") else tuple(spec)
            assert port_bert.param_axes(name) == want, name
            assert moe.is_expert_leaf(name) == (want is not None), name
            experts += want is not None
    assert experts == 2 * 2  # w_in and w_out of both layers
    mesh_axes = {"dp": 2, "ep": 4}
    ref_mesh = ref_make_mesh(mesh_axes, devices=jax.devices()[:8])
    ref_sh = ref_infer(ref_mesh, boxed)
    weights = params_from_jax(jax.tree.map(np.asarray, nn.meta.unbox(boxed)), device="cpu")
    port_sh = infer_variable_shardings(make_mesh(mesh_axes, devices=range(8)), weights,
                                       port_bert.param_axes)
    for leaf in ("w_in", "w_out"):
        name = f"layer_0.moe_mlp.{leaf}"
        want = ref_sh["layer_0"]["moe_mlp"][leaf].devices_indices_map(weights[name].shape)
        for d, dev in enumerate(ref_mesh.devices.reshape(-1)):
            got = port_sh[name].index(weights[name].shape, d)
            assert weights[name][got].shape == weights[name][want[dev]].shape, (name, d)
            assert torch.equal(weights[name][got], weights[name][want[dev]]), (name, d)
    router = weights["layer_0.moe_mlp.router"]
    for d in range(8):
        assert torch.equal(router[port_sh["layer_0.moe_mlp.router"].index(router.shape, d)],
                           router), d
    assert weights["layer_0.moe_mlp.w_in"][port_sh["layer_0.moe_mlp.w_in"].index(
        weights["layer_0.moe_mlp.w_in"].shape, 5)].shape == (2, 128, 512)


def _pair(top_k, dtype="float32", dropout_rate=0.0, experts=E):
    """(reference, port) ``bert_tiny_moe_mlm`` of the same config. The port
    runs flash attention (its plain version on the CPU), the reference
    dense attention: the same softmax attention in float32 (the Pallas
    kernel in interpret mode adds only compile time; ``tests/test_torch_bert.py``
    holds the two flash paths together)."""
    ref = ref_bert.bert_tiny_moe_mlm(seq_len=SEQ, vocab_size=VOCAB, num_experts=experts,
                                     top_k=top_k)
    ref = ref_bert._make(dataclasses.replace(
        ref.config, use_flash_attention=False, dtype=getattr(jnp, dtype),
        dropout_rate=dropout_rate), SEQ, ref.name)
    port = port_bert.bert_tiny_moe_mlm(seq_len=SEQ, vocab_size=VOCAB, num_experts=experts,
                                       top_k=top_k)
    port = port_bert._make(dataclasses.replace(
        port.config, use_flash_attention=True, dtype=getattr(torch, dtype),
        dropout_rate=dropout_rate), SEQ, port.name)
    return ref, port


def _bridge(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _tokens(seed, n=4):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(n, SEQ)).astype(np.int32)


@TOPK
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_tiny_moe_logits_and_aux_match_reference(top_k, dtype):
    """Eval logits, and a training apply's logits and summed aux loss (the
    reference's sown ``aux_loss`` collection, the port's ``new_state``)."""
    ref, port = _pair(top_k, dtype)
    variables = ref.init(0)
    x = _tokens(1)
    want = np.asarray(ref.apply(variables, jnp.asarray(x))[0])
    state = _bridge(variables)
    got = TrainedModel(port, state).predict(x)
    assert got.shape == want.shape == (4, SEQ, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL[dtype], rtol=0)
    want_logits, sown = ref.apply(variables, jnp.asarray(x), train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
    want_aux = sum(float(np.sum(np.asarray(a))) for a in jax.tree.leaves(sown["aux_loss"]))
    logits, new_state = port.apply(state, torch.tensor(x), train=True, rng=0)
    assert set(new_state) == {"aux_loss"} and new_state["aux_loss"].ndim == 0
    np.testing.assert_allclose(logits.float().detach().numpy(), np.asarray(want_logits),
                               atol=LOGIT_ATOL[dtype], rtol=0)
    rtol = AUX_RTOL if dtype == "float32" else 1e-2
    assert new_state["aux_loss"].item() == pytest.approx(want_aux, rel=rtol)
    assert want_aux >= 2 * 0.99  # two layers, each at least 1 (uniform routing)


def test_aux_loss_returned_and_added():
    """The reference's ``test_moe_aux_loss_sown_and_added``: a training
    apply returns the aux loss (an eval apply does not, nor does ``init``),
    the step adds it at ``aux_loss_weight`` and strips it from the state."""
    port = port_bert.bert_tiny_moe_mlm(seq_len=8, vocab_size=64, num_experts=4)
    variables = port.init(0, device="cpu")
    assert not any("aux" in k for k in variables)
    _, state = port.apply(variables, torch.zeros(2, 8, dtype=torch.int32), train=True, rng=0)
    assert float(state["aux_loss"]) >= 2 * 0.99
    assert port.apply(variables, torch.zeros(2, 8, dtype=torch.int32))[1] == {}
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 64, size=(4, 8)))
    batch = {"features": tokens, "label": tokens}
    losses = []
    for weight in (0.0, 0.5):
        params = {k: v.clone().requires_grad_() for k, v in variables.items()}
        s = TrainState(params, {}, get_optimizer("sgd", 0.0)(list(params.values())))
        s, m = make_train_step(port, "categorical_crossentropy", metrics=(),
                               aux_loss_weight=weight)(s, batch)
        losses.append(float(m["loss"]))
        assert s.model_state == {}
    assert losses[1] > losses[0]


def _ref_steps(ref, params, batches):
    tx = ref_get_optimizer("adagrad")
    state = RefTrainState(params=params, model_state={}, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    step = ref_make_train_step(ref, tx, "fused_categorical_crossentropy", donate=False)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, _bridge(state.params)


def _assert_weights_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=WEIGHT_ATOL,
                                   rtol=0, err_msg=k)


@TOPK
def test_train_steps_match_reference(top_k):
    """Three train steps (adagrad, fused loss, aux weight 0.01) from the
    reference's init: each step's loss (task + aux) and the weights."""
    ref, port = _pair(top_k)
    params = ref.init(0)["params"]
    rng = np.random.default_rng(2)
    batches = [{"features": rng.integers(0, VOCAB, size=(4, SEQ)).astype(np.int32),
                "label": rng.integers(0, VOCAB, size=(4, SEQ)).astype(np.int32)}
               for _ in range(3)]
    want_losses, want_weights = _ref_steps(ref, params, batches)
    weights = {k: v.clone().requires_grad_() for k, v in _bridge(params).items()}
    state = TrainState(weights, {}, get_optimizer("adagrad")(list(weights.values())))
    step = make_train_step(port, "fused_categorical_crossentropy")
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_weights_close(state.params, want_weights)


@TOPK
def test_single_trainer_and_evaluate_match_reference(top_k):
    """``SingleTrainer.train`` (two steps) from the weights the reference's
    trainer initialises, then ``evaluate`` on held-out rows."""
    ref, port = _pair(top_k)
    params = ref.init(jax.random.split(jax.random.PRNGKey(0))[0])
    weights = _bridge(params["params"])
    port.init = lambda seed=0, device=None: {k: v.clone() for k, v in weights.items()}
    rows = _tokens(3, n=8)
    cols = {"features": rows, "label": np.roll(rows, -1, axis=1)}
    val = {"features": _tokens(4), "label": _tokens(5)}
    kw = dict(loss="fused_categorical_crossentropy", batch_size=4)
    ref_tr = RefSingleTrainer(ref, **kw)
    want = ref_tr.train(RefDataset(cols))
    tr = SingleTrainer(port, device="cpu", **kw)
    got = tr.train(Dataset(cols))
    assert len(tr.get_history()) == len(ref_tr.get_history()) == 2
    for h, w in zip(tr.get_history(), ref_tr.get_history()):
        np.testing.assert_allclose(h["loss"], w["loss"], rtol=LOSS_RTOL)
        assert h["accuracy"] == pytest.approx(w["accuracy"], abs=1e-6)
    _assert_weights_close(got.variables, _bridge(want.variables["params"]))
    want_eval = ref_tr.evaluate(want, RefDataset(val))
    got_eval = tr.evaluate(got, Dataset(val))
    np.testing.assert_allclose(got_eval["loss"], want_eval["loss"], rtol=LOSS_RTOL)
    assert got_eval["accuracy"] == pytest.approx(want_eval["accuracy"], abs=1e-6)


def test_bridge_round_trip():
    """``moe_mlp/{router,w_in,w_out}`` keep their names and layouts both
    ways: the reference's tree comes back leaf for leaf, and the port's
    state_dict has exactly the module's keys."""
    ref, port = _pair(2)
    variables = jax.tree.map(np.asarray, ref.init(0))
    state = params_from_jax(variables, device="cpu")
    assert state.keys() == port.module.state_dict().keys()
    assert state["layer_1.moe_mlp.w_out"].shape == (E, 512, 128)
    back = params_to_jax(state, port.module)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


def test_port_init_draws_the_reference_distributions():
    """lecun-normal MoE leaves: fan-in ``D`` for the router, ``E·D`` and
    ``E·M`` for the experts (flax's fans of a 3-d kernel)."""
    state = port_bert.bert_tiny_moe_mlm(num_experts=8).init(3, device="cpu")
    for leaf, fan_in in (("router", 128), ("w_in", 8 * 128), ("w_out", 8 * 512)):
        t = state[f"layer_0.moe_mlp.{leaf}"]
        assert abs(t.std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, leaf


def _chunk_routes(x, router, p, top_k, factor, monkeypatch, bases="row"):
    """The routing of each of ``p`` sp ranks' columns of ``x`` ``[B, S, D]``
    (rank ``m`` holds columns ``m·S/p … (m+1)·S/p − 1``) in one process: the
    sp collectives stand in for by the other chunks' per-row counts and gate
    sums, computed here. ``bases="rank"``: the per-rank base a data group
    gives (every choice of the ranks before this one first), in place of the
    per-row one. Returns each rank's ``(dispatch, aux)``."""
    from distkeras_tpu_torch.parallel.distributed import AxisRing

    B, S, D = x.shape
    s = S // p
    chunks = [x[:, m * s:(m + 1) * s] for m in range(p)]

    def counts(chunk):  # [B, k, E] per-row choice counts of one rank
        gates = torch.softmax(chunk.reshape(-1, D).float() @ router, -1)
        first = F.one_hot(gates.argmax(-1), E).float()
        picks = [first]
        if top_k == 2:
            picks.append(F.one_hot((gates * (1 - first)).argmax(-1), E).float())
        return torch.stack([o.view(B, s, E).sum(1) for o in picks], 1), gates.sum(0)

    rows, probs = zip(*(counts(c) for c in chunks))
    if bases == "row":
        monkeypatch.setattr(moe, "_gather", lambda t, group, n: torch.stack(rows))
    monkeypatch.setattr(moe, "_sum_prob", lambda prob, group, ring: sum(probs))
    out = []
    for m, chunk in enumerate(chunks):
        ring = AxisRing(p, m, group="sp")
        if bases == "rank":  # every row of the ranks before, then this rank's
            ahead = sum((rows[r].sum(0) for r in range(m)), torch.zeros(top_k, E))
            total = sum(r.sum(0) for r in rows)
            monkeypatch.setattr(moe, "_row_bases", lambda r, g, q, a=ahead, t=total: (
                a[None] + torch.cumsum(r, 0) - r, t))
        dispatch, _, _, aux = moe._route(chunk.reshape(-1, D), router, E, top_k, factor,
                                         None, ring, rows=B)
        out.append((dispatch.view(B, s, E, -1), aux))
    return out


@TOPK
@pytest.mark.parametrize("stripe", [False, True], ids=["contiguous", "striped"])
def test_column_chunks_with_row_bases_seat_the_whole_batch(top_k, stripe, monkeypatch):
    """A ``[B, S]`` batch split into ``p`` column chunks (sp ranks), each
    routed with per-row bases (the choices of every earlier row on every
    rank, then of its row on the ranks before it), seats every assignment
    where the whole batch's routing seats it, exactly: the reference's
    row-major order over the global ``[B, S]``. Striped: the chunks of the
    striped sequence against the whole striped sequence, the order the
    reference routes its striped trunk in. The capacity (0.5) drops
    assignments, so the order decides which. The per-rank base a data group
    uses (rank order) seats them elsewhere."""
    from distkeras_tpu_torch.ops.ring_flash import stripe_shard

    p, B, S = 4, 3, 16
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(B, S, D, generator=gen)
    router = torch.randn(D, E, generator=gen)
    if stripe:
        x = stripe_shard(x, p, 1)
    whole, _, _, whole_aux = moe._route(x.reshape(-1, D), router, E, top_k, 0.5, None,
                                        rows=B)
    whole = whole.view(B, S, E, -1)
    assert 0 < whole.sum() < B * S * top_k  # some assignments find no seat
    chunks = _chunk_routes(x, router, p, top_k, 0.5, monkeypatch)
    got = torch.cat([d for d, _ in chunks], dim=1)
    assert torch.equal(got, whole)
    for _, aux in chunks:
        assert aux.item() == pytest.approx(whole_aux.item(), rel=1e-6)
    by_rank = torch.cat([d for d, _ in _chunk_routes(x, router, p, top_k, 0.5, monkeypatch,
                                                     bases="rank")], dim=1)
    assert not torch.equal(by_rank, whole)


def test_row_bases_without_a_split_are_the_rank_order():
    """Rows on one rank with no data group: each row's base is the count of
    the rows before it, so routing ``B`` rows at once equals routing the
    flattened ``B·S`` tokens as one row."""
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randn(4 * 8, D, generator=gen)
    router = torch.randn(D, E, generator=gen)
    for top_k in (1, 2):
        by_row = moe._route(tokens, router, E, top_k, 0.5, None, rows=4)
        flat = moe._route(tokens, router, E, top_k, 0.5, None)
        assert torch.equal(by_row[0], flat[0]) and torch.equal(by_row[3], flat[3])
