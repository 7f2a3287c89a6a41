"""The port's fused softmax cross-entropy, forward and backward, and its loss
and optimizer registries against the reference's (Pallas kernels in
interpret mode on the CPU, optax).

Ragged shapes (T = 37 rows, V = 1000 columns) exercise the reference's
padding of T with dummy rows and V with -1e30 columns, which the port
replaces with masks. Tolerances: rtol 1e-5 on the float32 mean loss (the
same float32 logsumexp summed in another order); 1e-5 too for bfloat16
logits, since both sides widen them to float32 before any arithmetic.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.ops.losses import LOSSES as REF_LOSSES
from distkeras_tpu.ops.losses import get_optimizer as ref_get_optimizer
from distkeras_tpu.ops.pallas.fused_xent import fused_softmax_xent as ref_xent
from distkeras_tpu_torch.ops import fused_xent
from distkeras_tpu_torch.ops.fused_xent import (
    _xent_plan,
    fused_softmax_xent,
    xent_forward,
    xent_forward_reference,
    xent_grad,
    xent_grad_reference,
    xent_stats,
    xent_stats_reference,
)
from distkeras_tpu_torch.utils import build
from distkeras_tpu_torch.ops.losses import LOSSES, get_loss, get_optimizer

RTOL = 1e-5


def _data(seed, T, V):
    rng = np.random.default_rng(seed)
    logits = np.asarray(rng.normal(size=(T, V)) * 3, np.float32)
    labels = rng.integers(0, V, size=T).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,V", [(37, 1000), (64, 512)])
def test_xent_matches_reference(dtype, T, V):
    logits, labels = _data(0, T, V)
    ref = float(ref_xent(jnp.asarray(logits, dtype), labels))
    x = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = float(fused_softmax_xent(x, torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_xent_sequence_shaped_inputs():
    rng = np.random.default_rng(1)
    logits = np.asarray(rng.normal(size=(2, 16, 300)), np.float32)
    labels = rng.integers(0, 300, size=(2, 16)).astype(np.int32)
    ref = float(ref_xent(logits, labels, block_t=8, block_v=64))
    got = float(fused_softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_fused_loss_one_hot_falls_back():
    """One-hot targets take plain categorical CE on both sides."""
    logits, labels = _data(2, 12, 40)
    onehot = np.eye(40, dtype=np.float32)[labels]
    ref = float(REF_LOSSES["fused_categorical_crossentropy"](logits, onehot))
    got = float(get_loss("fused_categorical_crossentropy")(
        torch.from_numpy(logits), torch.from_numpy(onehot)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_registry_matches_reference(name):
    rng = np.random.default_rng(3)
    if name in ("binary_crossentropy", "mse", "mean_squared_error", "mae",
                "mean_absolute_error"):
        preds = np.asarray(rng.normal(size=(16, 1)), np.float32)
        targets = (rng.random((16,)) > 0.5).astype(np.float32)
    else:
        preds, targets = _data(4, 16, 10)
    ref = float(REF_LOSSES[name](preds, targets))
    got = float(get_loss(name)(torch.from_numpy(preds), torch.from_numpy(targets)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        get_loss("nope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_gradient_matches_reference(dtype):
    """The gradient of fused_softmax_xent (the plain K5 and K6) against
    jax.grad through the reference's Pallas kernels, at an odd vocabulary
    (which the reference pads with -1e30 columns) and with labels out of
    range on both sides of it (which pick no column). Held element by
    element, so that the many small entries count as much as the label
    column: float32 to 1e-5 relative (the same float32 softmax summed in
    another order); bfloat16 to 2**-7 relative, one bfloat16 rounding of the
    same float32 values. The absolute floor, 1e-15, lies far below the
    smallest entry (about 3e-12 here)."""
    logits, labels = _data(5, 37, 1000)
    labels[:3] = [-1, 4096, -7]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.grad(lambda x: ref_xent(x, labels))(jnp.asarray(logits, jdt)),
                      np.float32)
    x = torch.from_numpy(logits).to(tdt).requires_grad_()
    (got,) = torch.autograd.grad(fused_softmax_xent(x, torch.from_numpy(labels)), (x,))
    assert got.dtype == tdt
    rtol = RTOL if dtype == "float32" else 2**-7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-15)
    # Out-of-range rows: softmax only, no -1 anywhere.
    assert (got[:3].float() >= 0).all()


def test_xent_stats_and_grad_plain_versions():
    """K5's and K6's plain versions against numpy, row by row."""
    logits, labels = _data(9, 6, 50)
    labels[0] = 50  # out of range: no onehot
    g = np.linspace(0.5, 2.0, 6).astype(np.float32)
    m, s = xent_stats(torch.from_numpy(logits))
    np.testing.assert_allclose(m.numpy(), logits.max(1), rtol=0)
    np.testing.assert_allclose(s.numpy(), np.exp(logits - logits.max(1, keepdims=True)).sum(1),
                               rtol=1e-6)
    d = xent_grad(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(g), m, s)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[np.arange(1, 6), labels[1:]] -= 1
    np.testing.assert_allclose(d.numpy(), p * g[:, None], rtol=1e-5, atol=1e-7)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors K4, K5 (and the backward through them) and K6 run
    their plain versions: no kernel is looked up, no library is built or
    loaded (there is no nvcc here), Triton is not imported, nothing is
    counted; int32 and int64 labels give the same result."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(fused_xent, "_kernel", refuse)
    monkeypatch.setattr(fused_xent, "_triton_grad_kernel", refuse)
    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setitem(sys.modules, "triton", None)
    logits, labels = (torch.from_numpy(a) for a in _data(6, 9, 33))
    g = torch.full((9,), 1 / 9)
    wrappers = (xent_forward, xent_stats, xent_grad)
    before = [w.launches for w in wrappers]
    want = xent_forward_reference(logits, labels)
    for y in (labels, labels.long()):
        assert torch.equal(xent_forward(logits, y), want)
    m, s = xent_stats(logits)
    assert all(torch.equal(a, b) for a, b in zip((m, s), xent_stats_reference(logits)))
    assert torch.equal(xent_grad(logits, labels, g, m, s),
                       xent_grad_reference(logits, labels, g, m, s))
    x = logits.clone().requires_grad_()
    (d,) = torch.autograd.grad(fused_softmax_xent(x, labels), (x,))
    assert torch.equal(d, xent_grad_reference(logits, labels, g, m, s))
    assert [w.launches for w in wrappers] == before


# Phase 2 of chip_smoke.py: the main path's shapes (bert_base and gpt_small
# logits, a 1F1B microbatch's, MoE's), then the schedules' edges.
_PHASE2_SHAPES = [(4096, 30522, 4), (4096, 30522, 2), (4096, 50257, 4), (1024, 30522, 4),
                  (2048, 1024, 4), (4096, 50257, 2), (1, 30522, 4), (37, 1000, 4),
                  (1024, 30522, 2), (512, 30522, 4)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("T,V,es", _PHASE2_SHAPES + [(1, 1024, 4), (333, 100, 2)])
def test_xent_plan_picks_schedule_and_caps_grid(T, V, es, sms):
    """K4's and K5's schedule: one warp a row, 8 rows a block, for rows of
    at most 16 KB (V = 1024, 1000, 100), one block a row above (30522,
    50257); the grid at least one block, within its cap of blocks an SM, and
    no larger than the rows need. The kernel's blocks walk the rows until
    none is left, so any such grid covers them; the card tests compare every
    row with the plain version."""
    plan = _xent_plan(T, V, es, sms)
    assert plan.narrow == (V * es <= 16384)
    assert plan.narrow == (V in (1024, 1000, 100))
    cap = sms * (8 if plan.narrow else 4)
    assert plan.grid == max(1, min(-(-T // (8 if plan.narrow else 1)), cap))
    assert 1 <= plan.grid <= cap
    if (T, V, es) == (2048, 1024, 4) and sms == 132:
        assert plan.grid == 256  # one wave: 2048 rows, 8 a block


def test_xent_plan_at_the_narrow_limit():
    """16 KB rows are narrow, one element more is wide, for each width."""
    for es in (2, 4):
        assert _xent_plan(64, 16384 // es, es).narrow
        assert not _xent_plan(64, 16384 // es + 1, es).narrow


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw", "adagrad",
                                  "adadelta", "rmsprop"])
def test_optimizers_match_optax(name):
    """Five updates from the same fixed gradients, default learning rates,
    against the reference's optax transformation of the same name. One
    gradient is zero at first, where adagrad's accumulator rule matters.
    float32 to 1e-6: the same update rules, rounded in another order."""
    rng = np.random.default_rng(10)
    p0 = {"w": np.asarray(rng.normal(size=(4, 3)), np.float32), "b": np.zeros(3, np.float32)}
    grads = [{k: np.asarray(rng.normal(size=v.shape), np.float32) for k, v in p0.items()}
             for _ in range(5)]
    grads[0]["b"][:] = 0
    tx = ref_get_optimizer(name)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)
    port = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p0.items()}
    opt = get_optimizer(name)(list(port.values()))
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        for k, t in port.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(port[k].detach().numpy(), np.asarray(params[k]),
                                   atol=1e-6, rtol=0)


def test_optimizer_learning_rate_and_unknown_name():
    assert get_optimizer("adam", 0.5)([torch.zeros(1, requires_grad=True)]).defaults["lr"] == 0.5
    assert get_optimizer("SGD")([torch.zeros(1, requires_grad=True)]).defaults["lr"] == 0.01
    custom = get_optimizer(torch.optim.SGD)
    assert custom is torch.optim.SGD
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("lamb")


def test_chip_smoke_ptxas_summary_names_every_kernel():
    """Phase 1 of ``chip_smoke.py`` reads each kernel's registers and spills
    from nvcc's ptxas report, under a name with its template arguments, for
    kernels at namespace scope and in nvcc's renamed anonymous namespace;
    a report with no kernel found fails the phase."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    anon = "_ZN54_INTERNAL_3c8f1a2b_17_fused_xent_fwd_cu_9e1f2a3b16xent_rows_kernel"
    report = "\n".join([
        "ptxas info    : Compiling entry function '_Z16flash_fwd_kernelILi64EEvPK13__nv_bfloat16"
        "S2_S2_PS0_Pfiiiif' for 'sm_90a'",
        "ptxas info    : Function properties for _Z16flash_fwd_kernelILi64EEvPK13__nv_bfloat16",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, 1024 bytes smem",
        f"ptxas info    : Compiling entry function '{anon}I13__nv_bfloat16Lb0ElLi256EEEvPKT_' for"
        " 'sm_90a'",
        f"ptxas info    : Function properties for {anon}I13__nv_bfloat16Lb0ElLi256EEEvPKT_",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 57 registers",
        f"ptxas info    : Compiling entry function '{anon}IfLb1EiLi32EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
    ])
    assert chip_smoke.ptxas_summary(report) == {
        "flash_fwd_kernel<64>": "0 bytes spill stores, 0 bytes spill loads, 168 registers",
        "xent_rows_kernel<bf16, 0, int64, 256>":
            "8 bytes spill stores, 8 bytes spill loads, 57 registers",
        "xent_rows_kernel<float, 1, int32, 32>": "40 registers",
    }
    assert chip_smoke.ptxas_summary("ptxas info    : 0 bytes gmem") == {}
