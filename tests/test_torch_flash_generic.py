"""The flash functions of the generic route (float32, float16 and bfloat16
at any head dim the Hopper kernels do not take) against the reference's
Pallas kernels, and the choice of route.

The reference runs in interpret mode on the CPU, as tests/test_flash_attention.py
runs it; the port runs the plain versions its wrappers take for CPU tensors,
which compute what K1g-K3g compute on the card (``csrc/flash_attention_generic.cu``,
``csrc/flash_attention_generic_bwd.cu``).
Inputs come from a seeded numpy generator: B = 1, H = 2, S = 32, the
reference's blocks 16, so its online softmax rescales once.

Tolerances, each of the largest magnitude of the reference's result (at
least 1): float32 and bfloat16 at ``test_torch_flash_attention.py``'s
F32_TOL, BF16_TOL and BF16_BWD_TOL, for the reasons given there. float16
gets 2.5e-3 forward: ``P`` is rounded to float16 against a per-block
running max in the reference and the row max in the port, one float16 ulp
(2^-11 relative) of each weight, and O's own rounding is one float16 ulp
(9.8e-4) at 1-2; 8e-3 backward, two float16 ulps (2^-10 relative) of the
largest gradient, for the same roundings of P and dS (the reference keeps P
in float32 for dV).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas.flash_attention import _flash_forward as ref_flash_forward
from distkeras_tpu.ops.pallas.flash_attention import dkv_call as ref_dkv_call
from distkeras_tpu.ops.pallas.flash_attention import dq_call as ref_dq_call
from distkeras_tpu.ops.pallas.flash_attention import flash_attention as ref_flash
from distkeras_tpu_torch.ops.flash_attention import (
    _check_kernel_inputs,
    dkv_call,
    dq_call,
    flash_attention,
    flash_forward,
    kernel_route,
)
from test_torch_flash_attention import BF16_BWD_TOL, BF16_TOL, F32_TOL

F16_TOL = 2.5e-3
F16_BWD_TOL = 8e-3
TOL = {"float32": (F32_TOL, F32_TOL), "bfloat16": (BF16_TOL, BF16_BWD_TOL),
       "float16": (F16_TOL, F16_BWD_TOL)}

# (dtype, head dim): every D the generic route pads to 16, 64, 128 and 256,
# and D above 256, which the kernels take in column chunks.
CASES = [("float32", 8), ("float32", 36), ("float32", 128), ("float32", 256),
         ("float32", 320), ("bfloat16", 8), ("bfloat16", 36), ("bfloat16", 128),
         ("bfloat16", 256), ("bfloat16", 512), ("float16", 12), ("float16", 128)]
MASKS = [(False, 0), (True, 0), (True, 1)]
BLOCK = 16


def _arrays(seed, n, shape):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.normal(size=shape), np.float32) for _ in range(n)]


def _both(arrays, dtype):
    """The same values as JAX arrays and as torch tensors of ``dtype``."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, tol, np.abs(want).max())


@pytest.mark.parametrize("dtype,D", CASES)
@pytest.mark.parametrize("causal,shift", MASKS)
def test_forward_matches_reference(dtype, D, causal, shift):
    """O and lse of flash_forward against the reference's ``_flash_forward``;
    under shift 1 row 0 sees no key: lse -1e30 on both sides."""
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(D, 3, (2, 32, D)), dtype)
    want_out, want_lse = ref_flash_forward(jq, jk, jv, causal, BLOCK, BLOCK, True,
                                           causal_shift=shift)
    out, lse = flash_forward(tq, tk, tv, causal=causal, causal_shift=shift)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    _close(out, want_out, TOL[dtype][0])
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=F32_TOL, rtol=1e-6)


def _stats(q, k, causal, shift, seed):
    """The float32 lse the forward gives (-1e30 for a row that sees no key)
    and a delta, in numpy."""
    D = q.shape[-1]
    s = np.einsum("bqd,bkd->bqk", q, k) * np.float32(D**-0.5)
    if causal:
        keep = np.arange(q.shape[1])[:, None] >= np.arange(k.shape[1])[None, :] + shift
        s = np.where(keep, s, np.float32(-1e30))
    m = s.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True))).astype(np.float32)
    delta = _arrays(seed, 1, q.shape[:2] + (1,))[0]
    return lse, delta


@pytest.mark.parametrize("dtype,D,Sq,Skv", [(dt, D, 32, 32) for dt, D in CASES]
                         + [("float32", 36, 16, 48), ("bfloat16", 36, 48, 16),
                            ("float16", 12, 16, 48)])
@pytest.mark.parametrize("causal,shift", MASKS)
def test_dq_dkv_calls_match_reference(dtype, D, Sq, Skv, causal, shift):
    """dq_call and dkv_call against the reference's, S_q = S_kv and, as the
    ring's hops call them, S_q != S_kv; under shift 1 row 0's P is 1 for
    every key on both sides."""
    q, do = _arrays(D + 1, 2, (2, Sq, D))
    k, v = _arrays(D + 2, 2, (2, Skv, D))
    lse, delta = _stats(q, k, causal, shift, D + 3)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both([q, k, v, do], dtype)
    want_dq = ref_dq_call(jq, jk, jv, jdo, lse, delta, causal, BLOCK, True, causal_shift=shift)
    want_dk, want_dv = ref_dkv_call(jk, jv, jq, jdo, lse, delta, causal, BLOCK, True,
                                    causal_shift=shift)
    tlse, tdelta = torch.from_numpy(lse), torch.from_numpy(delta)
    got_dq = dq_call(tq, tk, tv, tdo, tlse, tdelta, causal, shift)
    got_dk, got_dv = dkv_call(tk, tv, tq, tdo, tlse, tdelta, causal, shift)
    for got, want in ((got_dq, want_dq), (got_dk, want_dk), (got_dv, want_dv)):
        assert got.dtype == tq.dtype and got.shape == want.shape
        _close(got, want, TOL[dtype][1])


@pytest.mark.parametrize("dtype,D", CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_gradient_matches_reference(dtype, D, causal):
    """dQ, dK, dV of flash_attention (``[B, S, H, D]``) against jax.grad
    through the reference's flash_attention."""
    q, k, v, g = _arrays(D + 4, 4, (1, 32, 2, D))
    jdt = getattr(jnp, dtype)

    def ref_loss(q, k, v):
        out = ref_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g, jdt).astype(jnp.float32))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK, block_k=BLOCK)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(out.dtype))
    for a, b in zip(got, want):
        assert a.dtype == tq.dtype
        _close(a, b, TOL[dtype][1])


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 32, "hopper"), (torch.bfloat16, 64, "hopper"),
    (torch.bfloat16, 1, "generic"), (torch.bfloat16, 36, "generic"),
    (torch.bfloat16, 128, "generic"), (torch.bfloat16, 256, "generic"),
    (torch.float32, 64, "generic"), (torch.float32, 8, "generic"),
    (torch.float32, 256, "generic"), (torch.float16, 32, "generic"),
    (torch.float16, 12, "generic"), (torch.float32, 257, "generic"),
    (torch.bfloat16, 512, "generic"),
])
def test_kernel_route(dtype, D, route):
    """bf16 at D 32 and 64 takes the Hopper kernels; every other float
    dtype and head dim the generic ones, above 256 in column chunks."""
    assert kernel_route(dtype, D) == route


def test_kernel_route_takes_the_generic_kernels_for_unaligned_bf16():
    """The Hopper kernels' TMA maps need 16-byte aligned tensors."""
    assert kernel_route(torch.bfloat16, 64, aligned=False) == "generic"
    rows = torch.zeros(2 * 16 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 64)
    assert rows.data_ptr() % 16 and rows.is_contiguous()
    assert _check_kernel_inputs(q=rows, k=rows, v=rows) == "generic"
    whole = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    assert _check_kernel_inputs(q=whole, k=whole, v=whole) == "hopper"


@pytest.mark.parametrize("dtype,D,error,match", [
    (torch.float16, 0, ValueError, "head dims of 1 or more"),
    (torch.int32, 64, TypeError, "float32, float16 or bfloat16"),
    (torch.float64, 64, TypeError, "float32, float16 or bfloat16"),
])
def test_kernel_route_refuses(dtype, D, error, match):
    with pytest.raises(error, match=match):
        kernel_route(dtype, D)


def test_kernel_inputs_of_two_dtypes_are_refused():
    q = torch.zeros(2, 16, 64)
    with pytest.raises(TypeError, match="one dtype"):
        _check_kernel_inputs(q=q, k=q.bfloat16(), v=q)
