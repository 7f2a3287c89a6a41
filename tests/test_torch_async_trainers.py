"""The async parameter-server trainers against the reference.

One worker is deterministic, so the port's DOWNPOUR, ADAG, AEASGD, EAMSGD
and DynSGD, with ``overlap_window`` on and off, must end on the reference
trainer's center from the same bridged weights and the same seeded shuffle:
a float32 MLP (the reference's ``MLP`` with ``compute_dtype=float32``) and
``bert_tiny_mlm`` with the fused loss (its Pallas kernels in interpret mode,
the port's plain versions). Tolerance: the same float32 arithmetic in
another order over a few dozen adagrad steps, 1e-6 absolute on the center
(weights ~0.1-1) and 1e-5 relative on each step's loss. With several
workers the order of commits depends on the threads, so those runs are held
to the reference's acceptance instead (accuracy > 0.85 on the toy task).
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as ref
import distkeras_tpu_torch as dk
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.models.core import Model as RefModel
from distkeras_tpu.models.mlp import MLP as RefMLP
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops.launches import count_launch
from distkeras_tpu_torch.utils.bridge import params_from_jax
from torch_time_limit import time_limited

TRAINERS = ["DOWNPOUR", "ADAG", "AEASGD", "EAMSGD", "DynSGD"]
CENTER_ATOL, LOSS_RTOL = 1e-6, 1e-5
D = 16


def _toy(n=512, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(D,))
    x = rng.normal(size=(n, D)).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


def _bridge(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _port_mlp(weights=None, dtype=torch.float32):
    model = Model(lambda: MLP(D, (32,), 2, compute_dtype=dtype), input_shape=(D,), output_dim=2)
    if weights is not None:
        model.init = lambda seed=0, device=None: {k: v.clone() for k, v in weights.items()}
    return model


@pytest.fixture(scope="module")
def mlp_pair():
    ref_model = RefModel.from_flax(
        RefMLP(features=(32,), num_classes=2, compute_dtype=jnp.float32),
        input_shape=(D,), output_dim=2)
    params = ref_model.init(jax.random.split(jax.random.PRNGKey(0))[0])["params"]
    return ref_model, _bridge(params)


def _kwargs(name, overlap):
    kw = dict(worker_optimizer="adagrad", num_workers=1, batch_size=8, num_epoch=2,
              communication_window=3, overlap_window=overlap)
    if name in ("AEASGD", "EAMSGD"):
        kw.update(rho=2.0, learning_rate=0.05)
    return kw


def _assert_run_matches(tr, got, ref_tr, want):
    assert len(tr.history) == len(ref_tr.history)
    for h, w in zip(tr.history, ref_tr.history):
        assert h["worker"] == w["worker"] == 0
        np.testing.assert_allclose(h["loss"], w["loss"], rtol=LOSS_RTOL)
    assert tr.parameter_server.num_commits == ref_tr.parameter_server.num_commits
    want_w = _bridge(want.variables["params"])
    assert got.variables.keys() == want_w.keys()
    for k in want_w:
        np.testing.assert_allclose(got.variables[k].numpy(), want_w[k].numpy(),
                                   atol=CENTER_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name", TRAINERS)
@time_limited
def test_one_worker_matches_reference(mlp_pair, name, overlap):
    ref_model, weights = mlp_pair
    x, y = _toy(96)
    ref_tr = getattr(ref, name)(ref_model, **_kwargs(name, overlap))
    want = ref_tr.train(ref.Dataset.from_arrays(features=x, label=y), shuffle=True)
    tr = getattr(dk, name)(_port_mlp(weights), device="cpu", **_kwargs(name, overlap))
    got = tr.train(dk.Dataset.from_arrays(features=x, label=y), shuffle=True)
    assert got.device == torch.device("cpu")
    _assert_run_matches(tr, got, ref_tr, want)
    assert len(tr.window_times) == 1 and len(tr.window_times[0]) == 8


@time_limited
def test_dynsgd_bert_tiny_matches_reference():
    """DynSGD on bert_tiny_mlm (float32, flash attention on, dropout 0) with
    the fused cross-entropy: two windows of two steps, from the weights the
    reference's trainer initialises."""
    seq, vocab = 32, 256
    ref_model = ref_bert.bert_tiny_mlm(seq_len=seq, vocab_size=vocab)
    ref_model = ref_bert._make(dataclasses.replace(
        ref_model.config, use_flash_attention=True, dtype=jnp.float32, dropout_rate=0.0),
        seq, "bert_tiny_mlm")
    port_model = port_bert.bert_tiny_mlm(seq_len=seq, vocab_size=vocab)
    port_model = port_bert._make(dataclasses.replace(
        port_model.config, use_flash_attention=True, dtype=torch.float32, dropout_rate=0.0),
        seq, "bert_tiny_mlm")
    weights = _bridge(ref_model.init(jax.random.split(jax.random.PRNGKey(0))[0])["params"])
    port_model.init = lambda seed=0, device=None: {k: v.clone() for k, v in weights.items()}
    rng = np.random.default_rng(1)
    cols = {"features": rng.integers(0, vocab, size=(16, seq)).astype(np.int32),
            "label": rng.integers(0, vocab, size=(16, seq)).astype(np.int32)}
    kw = dict(loss="fused_categorical_crossentropy", num_workers=1, batch_size=4,
              communication_window=2)
    ref_tr = ref.DynSGD(ref_model, **kw)
    want = ref_tr.train(ref.Dataset(cols))
    tr = dk.DynSGD(port_model, device="cpu", **kw)
    got = tr.train(dk.Dataset(cols))
    assert len(tr.history) == 4
    _assert_run_matches(tr, got, ref_tr, want)


def _accuracy(trained, x, y):
    return float((trained.predict(x).argmax(-1) == y).mean())


@pytest.mark.parametrize("num_workers", [2, 4])
@time_limited
def test_downpour_workers_learn(num_workers):
    """The reference's acceptance: the center learns the toy task, every
    worker committed, and the history is tagged per worker."""
    x, y = _toy()
    tr = dk.DOWNPOUR(_port_mlp(dtype=torch.bfloat16), worker_optimizer="adam",
                     learning_rate=0.01, num_workers=num_workers, batch_size=16, num_epoch=6,
                     communication_window=4, device="cpu")
    trained = tr.train(dk.Dataset.from_arrays(features=x, label=y))
    assert _accuracy(trained, x, y) > 0.85
    steps = (512 // num_workers // 16) * 6
    assert len(tr.history) == steps * num_workers
    assert {h["worker"] for h in tr.history} == set(range(num_workers))
    assert tr.parameter_server.num_commits == num_workers * -(-steps // 4)
    status = tr.training_health.statusz()
    assert [row["worker"] for row in status["workers"]] == list(range(num_workers))
    assert all(row["commits"] == -(-steps // 4) for row in status["workers"])
    assert status["ps"]["num_commits"] == tr.parameter_server.num_commits
    assert "staleness" in status and status["memory"] == []


@pytest.mark.parametrize("name", TRAINERS)
@time_limited
def test_worker_params_are_the_optimizers(name):
    """Every new value (the start from the center, the rebase, the elastic
    pull) is written into the tensors the optimizer steps: after train(),
    each worker's parameters are the optimizer's own objects, and it holds
    state for each."""
    x, y = _toy(128)
    kw = dict(rho=2.0, learning_rate=0.05) if name in ("AEASGD", "EAMSGD") else {}
    tr = getattr(dk, name)(_port_mlp(), worker_optimizer="adam", num_workers=2, batch_size=8,
                           communication_window=2, device="cpu", **kw)
    tr.train(dk.Dataset.from_arrays(features=x, label=y))
    for w, state in enumerate(tr.worker_states):
        params = list(state.params.values())
        opts = [state.optimizer] + ([state.optimizer.base] if name == "EAMSGD" else [])
        for opt in opts:
            group = opt.param_groups[0]["params"]
            assert len(group) == len(params) and all(p is q for p, q in zip(params, group))
            assert all(p in opt.state and opt.state[p] for p in params)
        assert state.step == len([h for h in tr.history if h["worker"] == w])


@time_limited
def test_feed_compression_and_over_partitioning():
    """The host-feed path (device_cache off), bf16 commit deltas and
    parallelism_factor 2: still learns, and each worker ran its two
    partitions."""
    x, y = _toy()
    tr = dk.ADAG(_port_mlp(dtype=torch.bfloat16), worker_optimizer="adam", learning_rate=0.01,
                 num_workers=2, batch_size=16, num_epoch=4, communication_window=4,
                 parallelism_factor=2, compress_deltas=True, device_cache=False, device="cpu")
    trained = tr.train(dk.Dataset.from_arrays(features=x, label=y))
    assert _accuracy(trained, x, y) > 0.85
    assert len(tr.history) == 2 * 2 * (128 // 16) * 4
    assert tr._device_cache_budget(0) == 256 * 1024 * 1024


@pytest.mark.parametrize("kwargs, item", [
    # devices_per_worker > 1 (A10f) is ported: tests/test_torch_islands.py
    ({"transport": "smoke-signals"}, "unknown transport"),
])
def test_unported_arguments_raise(kwargs, item):
    with pytest.raises(ValueError, match=item):
        dk.DOWNPOUR(_port_mlp(), device="cpu", **kwargs)


@time_limited
def test_publisher_raises(tmp_path):
    """The weight publisher is ported: an async trainer publishes the PS
    center from its publisher thread and once more at the end, the
    manifest names the final center, and the reference reads the file as
    its own weight tree."""
    from distkeras_tpu.checkpoint import load_weights_file as ref_load
    from distkeras_tpu.checkpoint import read_manifest as ref_manifest
    from distkeras_tpu_torch.deploy import PublishPolicy, WeightPublisher

    tr = dk.DynSGD(_port_mlp(), device="cpu", num_workers=1, communication_window=2)
    tr.publisher = WeightPublisher(str(tmp_path), PublishPolicy(every_steps=1))
    x, y = _toy(64)
    trained = tr.train(dk.Dataset.from_arrays(features=x, label=y))
    manifest = ref_manifest(str(tmp_path))
    assert manifest is not None and tr.publisher.stats()["published"] >= 1
    tree = ref_load(manifest["path"])
    got = _bridge(tree["params"])
    for name, want in trained.variables.items():
        assert torch.equal(got[name], want.cpu()), name


def test_constructor_defaults_match_reference():
    for name in TRAINERS:
        got = getattr(dk, name)(_port_mlp(), device="cpu")
        want = getattr(ref, name)(RefModel.from_flax(RefMLP(features=(4,), num_classes=2),
                                                     input_shape=(D,), output_dim=2))
        assert got.communication_window == want.communication_window, name
        assert (got.num_workers, got.batch_size, got.overlap_window, got.device_cache,
                got.track_health) == (want.num_workers, want.batch_size, want.overlap_window,
                                      want.device_cache, want.track_health)
        for attr in ("rho", "learning_rate", "momentum"):
            assert getattr(got.protocol, attr, None) == getattr(want.protocol, attr, None)


@time_limited
def test_model_apply_is_thread_safe():
    """``functional_call`` swaps weights into the module for the call, so
    threads applying one Model with different weights must each use their
    own module: eight threads at a short switch interval get what one
    thread gets."""
    model = _port_mlp()
    x = torch.from_numpy(_toy(64)[0])
    weights = [model.init(s, device="cpu") for s in range(8)]
    want = [model.apply(w, x)[0] for w in weights]
    errors = []

    def run(i):
        for _ in range(50):
            if not torch.equal(model.apply(weights[i], x)[0], want[i]):
                errors.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors


def test_launch_counter_is_exact_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    per_thread, n_threads = 5000, 8

    def run():
        for _ in range(per_thread):
            count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == per_thread * n_threads
