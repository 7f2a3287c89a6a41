"""ResNet-18/50 against the reference's flax ResNet.

``resnet18`` at 32x32 with 10 classes, so that flax's asymmetric ``"SAME"``
padding matters at every strided layer (the 7x7 stem pads 2 and 3, each
stride-2 3x3 convolution 0 and 1, max pooling 0 and 1 with -inf). Weights
are drawn from a numpy seed for every leaf of the reference's tree (BN
scales around 1, so that no residual branch is switched off) and bridged
across, ``batch_stats`` included.

Tolerance. Each output (the logits; the change of all the running
statistics together, ``new - old``) is held, in L2 norm, to a multiple of
the reference's own distance from a float64 run of the same weights (the
port with ``dtype=float64``, whose BatchNorm then runs in float64), and
never below 1e-5 of its norm; ``python tests/test_torch_resnet.py``
prints these distances for four input seeds. At batch 2 the train-mode
BatchNorm of the last stages normalises over 2 values (1x1 spatial),
which amplifies rounding: the reference's float32 logits sit 0.3-4.8%
from the exact ones, so float32 train mode and both eval cases allow 4x
the reference's distance (the port reached at most 2x). bfloat16 train
mode (resnet50's default dtype, the path AEASGD trains) is held at batch
16, where BatchNorm is well conditioned, to 1x: there the reference's
logits sit 4.2-5.6% from exact and its statistic changes 0.69-0.74%, the
port 2.9-3.9% and 0.45-0.49% from the reference. Planted in a copy of the
port, BatchNorm statistics taken before the float32 upcast fail the
bfloat16 train case, flax's biased running variance replaced by the
unbiased one fails every train case, and zero logits fail every case
(each allowance is under half the norm of the output it bounds). A
float32 train step at batch 16 is held to 1e-4 of each tensor's scale
outright.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.checkpoint import load_weights_file as ref_load_weights_file
from distkeras_tpu.checkpoint import save_weights_file as ref_save_weights_file
from distkeras_tpu.models import resnet as ref_resnet
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.ops.losses import get_optimizer as ref_get_optimizer
from distkeras_tpu.training.step import TrainState as RefTrainState
from distkeras_tpu.training.step import make_train_step as ref_make_train_step
from distkeras_tpu_torch.models import resnet
from distkeras_tpu_torch.models.core import TrainedModel
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.training.step import TrainState, make_train_step
from distkeras_tpu_torch.utils.bridge import params_from_jax, params_to_jax
from torch_time_limit import time_limited

SIZE, CLASSES = 32, 10
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _ref_model(dtype):
    return RefModel.from_flax(
        ref_resnet.ResNet(stage_sizes=(2, 2, 2, 2), block_cls=ref_resnet.BasicBlock,
                          num_classes=CLASSES, dtype=dtype),
        input_shape=(SIZE, SIZE, 3))


@pytest.fixture(scope="module")
def weights():
    return _draw_weights()


def _draw_weights():
    """Reference variables with every leaf drawn from a numpy seed."""
    abstract = jax.eval_shape(_ref_model(jnp.float32).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            x = 1 + 0.2 * rng.normal(size=leaf.shape)
        elif "var" in name:
            x = rng.uniform(0.5, 1.5, size=leaf.shape)
        elif "kernel" in name:
            x = rng.normal(size=leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        else:
            x = 0.1 * rng.normal(size=leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, abstract)


def _images(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _port_apply(variables, x, dtype, train):
    model = resnet.resnet18(CLASSES, SIZE, dtype=dtype)
    out, new_state = model.apply(variables, torch.from_numpy(x).to(dtype), train=train)
    return out.detach().double().numpy(), {k: v.double().numpy() for k, v in new_state.items()}


def _ref_apply(variables, x, dtype, train):
    out, new_state = _ref_model(dtype).apply(variables, jnp.asarray(x), train=train)
    stats = params_from_jax({"params": {}, **jax.tree.map(np.asarray, new_state)}, device="cpu")
    return np.asarray(out, np.float64), {k: v.double().numpy() for k, v in stats.items()}


def _allowed(want, exact, factor):
    n = np.linalg.norm
    allowed = max(1e-5 * n(exact), factor * n(want - exact))
    assert allowed < 0.5 * n(want), (allowed, n(want))
    return allowed


def _cat(stats: dict) -> np.ndarray:
    return np.concatenate([stats[k].ravel() for k in sorted(stats)])


# dtype, train, batch, multiple of the reference's distance from float64.
CASES = {"float32-eval": ("float32", False, 2, 4), "float32-train": ("float32", True, 2, 4),
         "bfloat16-eval": ("bfloat16", False, 2, 4), "bfloat16-train": ("bfloat16", True, 16, 1)}


def _outputs(weights, case, seed=1):
    """``[(name, got, want, exact)]``: the logits and, in train mode, the
    change of the running statistics, from the port, the reference and
    the port in float64."""
    dtype, train, batch, _ = CASES[case]
    jdt, tdt = DTYPES[dtype]
    x = _images(batch, seed)
    bridged = params_from_jax(weights, device="cpu")
    exact, exact_stats = _port_apply({k: v.double() for k, v in bridged.items()}, x,
                                     torch.float64, train)
    got, got_stats = _port_apply(bridged, x, tdt, train)
    want, want_stats = _ref_apply(weights, x, jdt, train)
    assert got.shape == want.shape == (batch, CLASSES)
    assert got_stats.keys() == want_stats.keys() == exact_stats.keys()
    assert len(got_stats) == (40 if train else 0)
    outputs = [("logits", got, want, exact)]
    if train:
        old = {k: bridged[k].double().numpy() for k in want_stats}
        outputs.append(("stats change", *(_cat({k: s[k] - old[k] for k in s})
                                          for s in (got_stats, want_stats, exact_stats))))
    return outputs


@pytest.mark.parametrize("case", list(CASES))
@time_limited(timeout=300)
def test_resnet18_matches_reference(weights, case):
    factor = CASES[case][3]
    for name, got, want, exact in _outputs(weights, case):
        err, allowed = np.linalg.norm(got - want), _allowed(want, exact, factor)
        assert err <= allowed, (name, err, allowed)


@time_limited(timeout=300)
def test_resnet18_train_step_matches_reference(weights):
    """One sgd step at batch 16 in float32, where train-mode BatchNorm is
    well conditioned: logits-driven parameters and the new running
    statistics within 1e-4 of their scale."""
    x = _images(16, seed=2)
    y = np.random.default_rng(3).integers(0, CLASSES, size=16).astype(np.int32)
    ref_model = _ref_model(jnp.float32)
    opt = ref_get_optimizer("sgd", 0.1)
    ref_state = RefTrainState.create(ref_model, opt, rng=0)
    ref_state = ref_state.replace(params=weights["params"],
                                  model_state={"batch_stats": weights["batch_stats"]},
                                  opt_state=opt.init(weights["params"]))
    ref_step = ref_make_train_step(ref_model, opt, "categorical_crossentropy", donate=False)
    ref_state, ref_m = ref_step(ref_state, {"features": x, "label": y})
    want = params_from_jax(jax.tree.map(np.asarray, {"params": ref_state.params,
                                                     **ref_state.model_state}), device="cpu")

    model = resnet.resnet18(CLASSES, SIZE, dtype=torch.float32)
    bridged = params_from_jax(weights, device="cpu")
    model.init = lambda seed=0, device=None: {k: v.clone() for k, v in bridged.items()}
    state = TrainState.create(model, get_optimizer("sgd", 0.1), 0, "cpu")
    assert set(state.model_state) == {k for k in bridged if k.endswith((".mean", ".var"))}
    step = make_train_step(model, "categorical_crossentropy")
    state, m = step(state, {"features": torch.from_numpy(x), "label": torch.from_numpy(y)})
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    got = state.variables
    assert got.keys() == want.keys()
    for k in want:
        scale = want[k].abs().max().item() + 1e-6
        err = (got[k].detach() - want[k]).abs().max().item()
        assert err <= 1e-4 * scale, (k, err, scale)


@time_limited(timeout=300)
def test_resnet18_weight_files_cross_both_ways(weights, tmp_path):
    """``batch_stats`` ride the weight file both ways, bitwise."""
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    model = resnet.resnet18(CLASSES, SIZE)
    TrainedModel(model, params_from_jax(weights, device="cpu")).save_weights(port_path)
    back = ref_load_weights_file(port_path)
    assert jax.tree.structure(back) == jax.tree.structure(weights)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(weights)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ref_save_weights_file(ref_path, weights)
    trained = TrainedModel(model, model.init(0, device="cpu"))
    trained.load_weights(ref_path)
    want = params_from_jax(weights, device="cpu")
    assert trained.variables.keys() == want.keys() == model.module.state_dict().keys()
    for k in want:
        assert torch.equal(trained.variables[k], want[k]), k
    # And the bridge alone, both ways.
    exported = params_to_jax(want, model.module)
    assert jax.tree.structure(exported) == jax.tree.structure(weights)


def test_same_padding_is_flax_s():
    assert resnet._same_pads(224, 7, 2) == (2, 3)
    assert resnet._same_pads(56, 3, 2) == (0, 1)
    assert resnet._same_pads(112, 3, 2) == (0, 1)
    assert resnet._same_pads(56, 3, 1) == (1, 1)
    assert resnet._same_pads(56, 1, 2) == (0, 0)
    for size in (1, 7, 32, 33, 224):
        for kernel, stride in ((7, 2), (3, 2), (3, 1), (1, 2)):
            lo, hi = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
            assert resnet._same_pads(size, kernel, stride) == (lo, hi)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_shapes_match_reference(name):
    """Every parameter and BatchNorm statistic of the full-width model (224,
    1000 classes) has the reference's name and shape (``jax.eval_shape``:
    no JAX forward at full width)."""
    ref_model = getattr(ref_resnet, name)()
    abstract = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    want = {k: tuple(v.shape) for k, v in params_from_jax(zeros, device="cpu").items()}
    port = getattr(resnet, name)()
    got = {k: tuple(v.shape) for k, v in port.module.state_dict().items()}
    assert got == want
    assert port.count_params() == ref_model.count_params()
    assert port.input_shape == ref_model.input_shape == (224, 224, 3)
    assert port.flops_per_example == ref_model.flops_per_example


if __name__ == "__main__":
    # The distances the tolerances above come from, relative to the exact
    # (float64) output's norm, over four input seeds:
    #   python tests/test_torch_resnet.py
    variables = _draw_weights()
    n = np.linalg.norm
    for case in CASES:
        for seed in (1, 2, 3, 4):
            for name, got, want, exact in _outputs(variables, case, seed):
                print(f"{case:15s} seed {seed} {name:12s} reference-exact "
                      f"{n(want - exact) / n(exact):.3g}  port-reference "
                      f"{n(got - want) / n(exact):.3g}", flush=True)
