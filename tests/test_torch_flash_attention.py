"""The port's flash-attention forward against the reference's Pallas kernel.

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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.attention import dot_product_attention as ref_dense
from distkeras_tpu.ops.pallas.flash_attention import _flash_forward as ref_flash_forward
from distkeras_tpu.ops.pallas.flash_attention import flash_attention as ref_flash
from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_forward,
    flash_forward_reference,
)

F32_TOL = 2e-5
BF16_TOL = 2e-2


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


def test_flash_backward_is_not_ported():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(5, (1, 16, 1, 8)))
    out = flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


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
