"""The port's flash attention, forward and backward, against the reference's
Pallas kernels.

The reference runs in interpret mode on the CPU (as tests/test_flash_attention.py
runs it); the port runs its plain version, which is what its wrapper takes
for CPU tensors. Inputs are float32 from a seeded numpy generator.

Tolerances: 2e-5 absolute for float32 outputs. The two sides compute the
same float32 function in a different order (the reference's online softmax
over 16-32 key blocks against the port's one-pass softmax), so they agree
to a few float32 ulps of the O(1) outputs; lse the same. bfloat16 inputs
get 2e-2: ``P`` is rounded to bfloat16 relative to a per-block running max
in the reference and to the row max in the port, a difference of up to one
bfloat16 ulp (2^-8) in each weight.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.attention import dot_product_attention as ref_dense
from distkeras_tpu.ops.pallas.flash_attention import _flash_forward as ref_flash_forward
from distkeras_tpu.ops.pallas.flash_attention import dkv_call as ref_dkv_call
from distkeras_tpu.ops.pallas.flash_attention import dq_call as ref_dq_call
from distkeras_tpu.ops.pallas.flash_attention import flash_attention as ref_flash
from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.flash_attention import (
    dkv_call,
    dq_call,
    flash_attention,
    flash_forward,
    flash_forward_reference,
)

F32_TOL = 2e-5
BF16_TOL = 2e-2
BF16_BWD_TOL = 3e-2


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.normal(size=shape), dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_reference(causal):
    q, k, v = _qkv(0, (2, 64, 2, 16))
    ref = ref_flash(q, k, v, causal=causal, block_q=32, block_k=16)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          block_q=32, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_return_lse_matches_reference(causal):
    q, k, v = _qkv(1, (1, 32, 3, 8))
    ref_out, ref_lse = ref_flash(q, k, v, causal=causal, block_q=16,
                                 block_k=16, return_lse=True)
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                               block_q=16, block_k=16, return_lse=True)
    assert lse.shape == (1, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("causal_shift", [0, 1])
def test_flash_forward_causal_shift_matches_reference(causal_shift):
    """``causal_shift=1`` (strict causal, the striped ring layout) through the
    reference's ``_flash_forward``, including its fully masked row 0."""
    rng = np.random.default_rng(2)
    q, k, v = [np.asarray(rng.normal(size=(3, 64, 16)), np.float32) for _ in range(3)]
    ref_out, ref_lse = ref_flash_forward(q, k, v, True, 32, 32, True,
                                         causal_shift=causal_shift)
    out, lse = flash_forward(*map(torch.from_numpy, (q, k, v)), causal=True,
                             causal_shift=causal_shift)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=F32_TOL, rtol=0)
    # Row 0 of the strict mask sees no key: lse is -1e30 on both sides.
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=F32_TOL, rtol=1e-6)


@pytest.mark.parametrize("causal_shift", [0, 1])
def test_chip_smoke_sdpa_yardstick_matches_reference(causal_shift):
    """The one PyTorch call ``chip_smoke.py`` times beside K1 (SDPA; under
    ``causal_shift=1`` with a float additive -1e30 mask) computes the
    reference's ``_flash_forward``, row 0's uniform average included, so its
    time is a fair yardstick. float32 on the CPU, 2e-5 as above."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rng = np.random.default_rng(7)
    q, k, v = [np.asarray(rng.normal(size=(2, 3, 64, 16)), np.float32) for _ in range(3)]
    ref_out, _ = ref_flash_forward(*(x.reshape(6, 64, 16) for x in (q, k, v)), True, 32, 32,
                                   True, causal_shift=causal_shift)
    got = chip_smoke.sdpa_call(*map(torch.from_numpy, (q, k, v)), True, causal_shift)()
    np.testing.assert_allclose(got.reshape(6, 64, 16).numpy(), np.asarray(ref_out),
                               atol=F32_TOL, rtol=0)


def test_flash_bfloat16_matches_reference():
    q, k, v = _qkv(3, (2, 64, 2, 32))
    ref = ref_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    causal=True, block_q=32, block_k=32)
    out = flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          causal=True, block_q=32, block_k=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=BF16_TOL, rtol=0)


def test_flash_rejects_ragged_seq():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, (1, 100, 1, 8)))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, block_q=64, block_k=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradient_matches_reference(dtype, causal):
    """dQ, dK, dV of the port's flash_attention (the plain forward, Δ, the
    plain K2 and K3) against jax.grad through the reference's Pallas
    kernels. float32 to 2e-5 as above; bfloat16 to 3e-2: on top of the
    forward's rounding of P, the port rounds P to bfloat16 for Pᵀ·dO where
    the reference keeps it in float32, one bfloat16 ulp (2^-8) of each
    weight, and the gradients are bfloat16 of magnitude up to ~3."""
    q, k, v = _qkv(5, (2, 64, 2, 16))
    g = np.asarray(np.random.default_rng(6).normal(size=q.shape), np.float32)
    jdt = getattr(jnp, dtype)

    def ref_loss(q, k, v):
        out = ref_flash(q, k, v, causal=causal, block_q=32, block_k=16)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g, jdt).astype(jnp.float32))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, block_q=32, block_k=16)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(out.dtype))
    tol = F32_TOL if dtype == "float32" else BF16_BWD_TOL
    for a, b in zip(got, want):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=tol, rtol=0)


def _backward_inputs(seed, BH, Sq, Skv, D, causal, shift):
    """float32 q/k/v/dO, the lse the forward gives (-1e30 for a row that sees
    no key) and a delta, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    q, do = (np.asarray(rng.normal(size=(BH, Sq, D)), np.float32) for _ in range(2))
    k, v = (np.asarray(rng.normal(size=(BH, Skv, D)), np.float32) for _ in range(2))
    s = np.einsum("bqd,bkd->bqk", q, k) * np.float32(D**-0.5)
    if causal:
        keep = np.arange(Sq)[:, None] >= np.arange(Skv)[None, :] + shift
        s = np.where(keep, s, np.float32(-1e30))
    m = s.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True))).astype(np.float32)
    delta = np.asarray(rng.normal(size=(BH, Sq, 1)), np.float32)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv", [(64, 64), (64, 32), (32, 64)])
@pytest.mark.parametrize("causal,shift", [(False, 0), (True, 0), (True, 1)])
def test_dq_dkv_calls_match_reference(dtype, Sq, Skv, causal, shift):
    """The port's dq_call/dkv_call (plain versions on the CPU) against the
    reference's, which the ring-attention hops call with S_q != S_kv and
    shift 1. Under shift 1 row 0 sees no key: lse -1e30, P = 1 for every key
    on both sides. float32 to 2e-5; bfloat16 to 3e-2 (see above)."""
    q, k, v, do, lse, delta = _backward_inputs(7, 3, Sq, Skv, 16, causal, shift)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tlse, tdelta = torch.from_numpy(lse), torch.from_numpy(delta)
    want_dq = ref_dq_call(jq, jk, jv, jdo, lse, delta, causal, 32, True, causal_shift=shift)
    want_dk, want_dv = ref_dkv_call(jk, jv, jq, jdo, lse, delta, causal, 32, True,
                                    causal_shift=shift)
    got_dq = dq_call(tq, tk, tv, tdo, tlse, tdelta, causal, shift)
    got_dk, got_dv = dkv_call(tk, tv, tq, tdo, tlse, tdelta, causal, shift)
    tol = F32_TOL if dtype == "float32" else BF16_BWD_TOL
    for a, b in ((got_dq, want_dq), (got_dk, want_dk), (got_dv, want_dv)):
        assert a.dtype == tdt and a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("causal,mask", [(False, False), (True, False), (False, True)])
def test_dense_attention_matches_reference(causal, mask):
    q, k, v = _qkv(6, (2, 24, 2, 8))
    m = np.random.default_rng(7).random((2, 1, 24, 24)) > 0.3 if mask else None
    ref = ref_dense(q, k, v, mask=m, causal=causal)
    out = dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                mask=None if m is None else torch.from_numpy(m),
                                causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)



def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, (4, 48, 16)))
    before = flash_forward.launches
    out, lse = flash_forward(q, k, v, causal=True)
    want_out, want_lse = flash_forward_reference(q, k, v, causal=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert flash_forward.launches == before


@pytest.mark.parametrize("B", [1, 2])
def test_flash_attention_hands_the_kernels_contiguous_rows(monkeypatch, B):
    """At batch 1 the fold of [B, S, H, D] to [BH, S, D] is a strided view;
    the CUDA kernels take contiguous rows only, so the fold copies it."""
    import distkeras_tpu_torch.ops.flash_attention as fa

    seen = []
    real = fa.flash_forward

    def spy(q, k, v, *args):
        seen.extend(x.is_contiguous() for x in (q, k, v))
        return real(q, k, v, *args)

    monkeypatch.setattr(fa, "flash_forward", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, (B, 32, 2, 8)))
    fa.flash_attention(q, k, v)
    assert seen == [True, True, True]
