"""``tracing.py``: the step timer, the card's peak rate, the step's flop
count and the deprecated shims, against the reference.

- ``StepTimer.summary`` equals the reference's key for key and value for
  value (tolerance 0) on the same tick times, fed through a patched clock.
- ``device_peak_flops()`` is None on the CPU; by card name it gives the
  published dense bf16 rate (989.4e12 for the H100 SXM).
- ``compiled_step_flops`` of a tiny bert train step (dense attention) is
  held against the reference's XLA count of the same step on the CPU. The
  port counts matrix products only (``FlopCounterMode``); XLA counts the
  elementwise work too, so the ratio port / reference lies in
  [FLOPS_RATIO_LO, 1]; measured 0.9169 on this step (157286400 against
  171538688; bert_tiny_mlm, seq 16, vocab 64, batch 4, adam). The count leaves the step's weights, optimizer
  state and the global generator as they were.
- Every shim warns and forwards to the telemetry module.
"""

import dataclasses
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import tracing as ref_tracing
from distkeras_tpu.models import bert as ref_bert
from distkeras_tpu.ops.losses import get_optimizer as ref_get_optimizer
from distkeras_tpu.training.step import TrainState as RefTrainState
from distkeras_tpu.training.step import make_train_step as ref_make_train_step
from distkeras_tpu_torch import tracing
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.ops.losses import get_optimizer
from distkeras_tpu_torch.training.step import TrainState, make_train_step
from distkeras_tpu_torch.utils.bridge import params_from_jax

FLOPS_RATIO_LO = 0.85
TICKS = [0.0, 0.5, 0.512, 0.531, 0.540, 0.590, 0.602, 0.611, 0.660, 0.671, 0.702]


def _summaries(monkeypatch, **kw):
    out = []
    for mod in (ref_tracing, tracing):
        clock = iter(TICKS)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        t = mod.StepTimer()
        t.start()
        dts = [t.tick() for _ in TICKS[1:]]
        out.append((t.summary(**kw), dts, list(t.step_times)))
    return out


@pytest.mark.parametrize("kw", [{}, {"batch_size": 32}, {"batch_size": 8, "flops_per_example": 1e9},
                                {"batch_size": 8, "flops_per_step": 3e12, "num_chips": 2},
                                {"skip_warmup": 0}, {"skip_warmup": 20}],
                         ids=["plain", "batch", "per_example", "per_step", "no_warmup",
                              "all_warmup"])
def test_step_timer_summary_equals_reference(monkeypatch, kw):
    (want, want_dts, want_times), (got, dts, times) = _summaries(monkeypatch, **kw)
    assert dts == want_dts and times == want_times
    assert got == want
    assert "mfu" not in got  # no card: no peak rate
    assert got["steps"] == (10.0 if kw.get("skip_warmup") in (0, 20) else 9.0)


def test_step_timer_first_tick_and_empty():
    t = tracing.StepTimer()
    assert t.tick() == 0.0 and t.step_times == [] and t.summary() == {}


def test_step_timer_mfu_on_a_known_card(monkeypatch):
    monkeypatch.setattr(tracing, "device_peak_flops", lambda device=None: 989.4e12)
    clock = iter(TICKS)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    t = tracing.StepTimer()
    t.start()
    for _ in TICKS[1:]:
        t.tick()
    s = t.summary(batch_size=32, flops_per_step=5e12)
    assert s["train_tflops_per_sec"] == pytest.approx(5.0 / s["step_time_mean_s"], rel=1e-12)
    assert s["mfu"] == pytest.approx(5e12 / s["step_time_mean_s"] / 989.4e12, rel=1e-12)


def test_device_peak_flops(monkeypatch):
    assert tracing.device_peak_flops() is None
    assert tracing.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756.0e12),
                       ("NVIDIA A100-SXM4-80GB", 312.0e12), ("Some Other Card", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        assert tracing.device_peak_flops("cuda:0") == want, name
    assert tracing.device_peak_flops("cpu") is None


def _tiny():
    ref = ref_bert.bert_tiny_mlm(seq_len=16, vocab_size=64)
    ref = ref_bert._make(dataclasses.replace(ref.config, dtype=jnp.float32,
                                             use_flash_attention=False), 16, "bert_tiny_mlm")
    port = port_bert.bert_tiny_mlm(seq_len=16, vocab_size=64)
    port = port_bert._make(dataclasses.replace(port.config, dtype=torch.float32,
                                               use_flash_attention=False), 16, "bert_tiny_mlm")
    return ref, port


def test_compiled_step_flops_against_xla_and_leaves_state_alone():
    ref, port = _tiny()
    rng = np.random.default_rng(0)
    batch = {"features": rng.integers(0, 64, size=(4, 16)).astype(np.int32),
             "label": rng.integers(0, 64, size=(4, 16)).astype(np.int32)}
    params = ref.init(0)["params"]
    tx = ref_get_optimizer("adam")
    ref_state = RefTrainState(params=params, model_state={}, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    ref_step = ref_make_train_step(ref, tx, "categorical_crossentropy", donate=False)
    want = ref_tracing.compiled_step_flops(ref_step, ref_state, batch)

    weights = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in weights.items()}
    state = TrainState(leaves, {}, get_optimizer("adam")(list(leaves.values())))
    step = make_train_step(port, "categorical_crossentropy")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    rng_before = torch.random.get_rng_state()
    got = tracing.compiled_step_flops(step, state, tbatch)

    assert want and got
    ratio = got / want
    assert FLOPS_RATIO_LO <= ratio <= 1.0, (got, want, ratio)
    assert state.step == 0 and not state.optimizer.state
    for k, v in state.params.items():
        assert torch.equal(v.detach(), weights[k]) and v.grad is None, k
    assert torch.equal(torch.random.get_rng_state(), rng_before)
    # the count is the step's: the same again, and a real step still runs
    assert tracing.compiled_step_flops(step, state, tbatch) == got
    state, m = step(state, tbatch)
    assert state.step == 1 and np.isfinite(float(m["loss"]))


def test_compiled_step_flops_counts_kernel_launches():
    """A kernel launch adds its plain version's flops to the count (the
    wrappers report them through ``count_launch``)."""
    from distkeras_tpu_torch.ops import launches

    def fake_kernel():
        launches.count_launch(fake_kernel, 1234.0)

    fake_kernel.launches = 0

    def step(x):
        fake_kernel()
        return x @ x

    x = torch.ones(4, 4)
    assert tracing.compiled_step_flops(step, x) == 1234.0 + 2 * 4 * 4 * 4
    assert fake_kernel.launches == 1
    assert tracing.compiled_step_flops(lambda: None) is None
    assert tracing.compiled_step_flops(lambda: 1 / 0) is None


@pytest.mark.parametrize("name", ["span", "enable_tracing", "disable_tracing", "active_tracer",
                                  "Tracer", "trace", "profile_trace"])
def test_shims_warn_and_forward(name):
    from distkeras_tpu_torch.telemetry import device, spans

    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = getattr(tracing, name)
    want = device.profile_trace if name in ("trace", "profile_trace") else getattr(spans, name)
    assert got is want
    with pytest.raises(AttributeError):
        tracing.no_such_name  # noqa: B018
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tracing.StepTimer and tracing.MetricStream  # not shims: no warning
