"""The MLP/CNN models, the conv weight bridge and the data transformers,
against the reference.

Logits on bridged weights: in float32 both packages compute the same sums
in another order (1e-5 absolute at logits of magnitude ~1-2; 1.5e-6 seen).
In bfloat16 (the models' default) each hidden layer rounds its output to
bf16 after accumulating in another order, so a unit may land one bf16 ulp
apart: the logits are held to one ulp at magnitude 1-2 (8e-3), and to 1e-3
on average (here every rounding agreed: 5e-7 seen). The transformers are
numpy on both sides: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.data import transformers as ref_tf
from distkeras_tpu.data.dataset import Dataset as RefDataset
from distkeras_tpu.models import cnn as ref_cnn
from distkeras_tpu.models import mlp as ref_mlp
from distkeras_tpu_torch.data import transformers as port_tf
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import cnn, mlp
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.utils.bridge import params_from_jax, params_to_jax

INPUT_SHAPES = {
    "mnist_mlp": (784,),
    "higgs_mlp": (28,),
    "mnist_cnn": (28, 28, 1),
    "cifar10_cnn": (32, 32, 3),
}
F32_ATOL, BF16_ATOL, BF16_MEAN_ATOL = 1e-5, 8e-3, 1e-3


def _flax_module(name, f32):
    """The reference's flax module for ``name``, in float32 if asked."""
    base = {
        "mnist_mlp": lambda: ref_mlp.MLP(features=(500, 300), num_classes=10),
        "higgs_mlp": lambda: ref_mlp.MLP(features=(500, 500, 500), num_classes=2),
        "mnist_cnn": lambda: ref_cnn.CNN(conv_features=(32, 64), dense_features=(128,),
                                         num_classes=10),
        "cifar10_cnn": lambda: ref_cnn.CNN(conv_features=(64, 128, 256), dense_features=(256,),
                                           num_classes=10, dropout_rate=0.1),
    }[name]()
    return dataclasses.replace(base, compute_dtype=jnp.float32) if f32 else base


def _port_model(name, f32):
    """The port's model for ``name``, every layer computing in float32 if
    asked."""
    model = getattr(cnn if "cnn" in name else mlp, name)()
    if not f32:
        return model

    def module_fn():
        module = model.module_fn()
        for m in module.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float32
        return module

    return Model(module_fn, name=model.name, input_shape=model.input_shape,
                 output_dim=model.output_dim, flops_per_example=model.flops_per_example)


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("name", list(INPUT_SHAPES))
def test_logits_match_reference(name, f32):
    shape = INPUT_SHAPES[name]
    module = _flax_module(name, f32)
    x = np.random.default_rng(0).normal(size=(4, *shape)).astype(np.float32)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(module.apply(variables, jnp.asarray(x)))
    port = _port_model(name, f32)
    weights = params_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    init = port.init(0, device="cpu")
    assert weights.keys() == init.keys()
    assert all(weights[k].shape == init[k].shape for k in init)
    got, _ = port.apply(weights, torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err = np.abs(got.numpy() - want)
    if f32:
        assert err.max() <= F32_ATOL
    else:
        assert err.max() <= BF16_ATOL and err.mean() <= BF16_MEAN_ATOL
    assert port.count_params() == sum(np.size(v) for v in jax.tree.leaves(variables))
    assert port.flops_per_example == getattr(ref_cnn if "cnn" in name else ref_mlp,
                                             name)().flops_per_example


def test_init_draws_flax_like_weights():
    """lecun-normal kernels (std sqrt(1/fan_in)), zero biases, as flax."""
    w = cnn.cifar10_cnn().init(0, device="cpu")
    assert float(w["Conv_0.weight"].std()) == pytest.approx((1 / 27) ** 0.5, rel=0.1)
    assert float(w["Dense_0.weight"].std()) == pytest.approx((1 / 4096) ** 0.5, rel=0.1)
    assert not w["Conv_2.bias"].any() and not w["Dense_1.bias"].any()


def test_conv_bridge_both_ways():
    """A flax Conv kernel [kh, kw, in, out] becomes a Conv2d weight
    [out, in, kh, kw] and comes back unchanged, next to the dense ones."""
    module = _flax_module("mnist_cnn", False)
    variables = module.init(jax.random.PRNGKey(1), jnp.zeros((1, 28, 28, 1)))
    tree = jax.tree.map(np.asarray, variables)
    weights = params_from_jax(tree, device="cpu")
    k = tree["params"]["Conv_1"]["kernel"]
    assert weights["Conv_1.weight"].shape == (64, 32, 3, 3)
    np.testing.assert_array_equal(weights["Conv_1.weight"][5, 7].numpy(), k[:, :, 7, 5])
    back = params_to_jax(weights, cnn.mnist_cnn().module)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _dataset_pair(cols):
    return RefDataset(cols), Dataset(cols)


@pytest.mark.parametrize("make", [
    lambda m: m.OneHotTransformer(4, input_col="label", output_col="onehot"),
    lambda m: m.MinMaxTransformer(0.0, 1.0, 0, 255, input_col="pixels"),
    lambda m: m.MinMaxTransformer(-1.0, 1.0, input_col="features"),
    lambda m: m.MinMaxTransformer(input_col="features", per_feature=True),
    lambda m: m.StandardScaleTransformer(input_col="features"),
    lambda m: m.ReshapeTransformer("pixels", "image", (4, 4, 1)),
    lambda m: m.DenseTransformer(input_col="pixels"),
    lambda m: m.LabelIndexTransformer(input_col="prediction"),
    lambda m: m.LabelIndexTransformer(input_col="score"),
    lambda m: m.TransformerPipeline([m.ReshapeTransformer("pixels", "image", (16,)),
                                     m.MinMaxTransformer(input_col="image")]),
], ids=["onehot", "minmax", "minmax_fitted", "minmax_per_feature", "standard", "reshape",
        "dense", "label_index", "label_index_1d", "pipeline"])
def test_transformers_match_reference(make):
    rng = np.random.default_rng(0)
    cols = {"label": rng.integers(0, 4, size=12).astype(np.float32),
            "pixels": rng.integers(0, 256, size=(12, 16)).astype(np.uint8),
            "features": (rng.normal(size=(12, 5)) * [1, 10, 100, 0.1, 3]).astype(np.float32),
            "prediction": rng.normal(size=(12, 3)).astype(np.float32),
            "score": rng.uniform(size=12).astype(np.float32)}
    ref_ds, port_ds = _dataset_pair(cols)
    want = make(ref_tf).transform(ref_ds)
    got = make(port_tf).transform(port_ds)
    assert got.columns == want.columns
    for c in want.columns:
        assert got[c].dtype == want[c].dtype and got[c].shape == want[c].shape
        np.testing.assert_array_equal(got[c], want[c])


def test_onehot_rejects_out_of_range_labels():
    with pytest.raises(ValueError, match="out of range"):
        port_tf.OneHotTransformer(3).transform(Dataset({"label": np.array([0, 3])}))
