"""The port's hand-written kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere. They
import neither JAX nor the reference package, so they also run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

import pytest
import torch

from distkeras_tpu_torch.ops.flash_attention import flash_forward, flash_forward_reference
from distkeras_tpu_torch.ops.fused_xent import xent_forward, xent_forward_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("causal,shift", [(False, 0), (True, 0), (True, 1)])
def test_flash_kernel_matches_plain(gen, D, causal, shift):
    """bf16 q/k/v at a ragged length (200, not a multiple of the 64-row
    tiles). O to 2e-2: the two round P to bf16 against different maxima;
    lse to 1e-3, float32 summed in another order."""
    q, k, v = (torch.randn(24, 200, D, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    before = flash_forward.launches
    out, lse = flash_forward(q, k, v, causal=causal, causal_shift=shift)
    torch.cuda.synchronize()
    assert flash_forward.launches == before + 1
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal, shift)
    assert (out.float() - ref_out.float()).abs().max().item() < 2e-2
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)


def test_flash_kernel_rejects_float32(gen):
    q = torch.randn(2, 64, 64, device="cuda", generator=gen)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_forward(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("V", [30522, 50257, 100])
def test_xent_kernel_matches_plain(gen, dtype, V):
    """Per-row loss at ragged vocabularies, labels including out-of-range
    ones (which pick nothing). 1e-5 relative: both reduce in float32, in
    another order."""
    logits = (torch.randn(333, V, device="cuda", generator=gen) * 3).to(dtype)
    labels = torch.randint(-2, V + 2, (333,), device="cuda", generator=gen)
    before = xent_forward.launches
    got = xent_forward(logits, labels)
    torch.cuda.synchronize()
    assert xent_forward.launches == before + 1
    torch.testing.assert_close(got, xent_forward_reference(logits, labels),
                               rtol=1e-5, atol=1e-4)


def test_xent_kernel_takes_row_strided_logits(gen):
    wide = torch.randn(64, 1100, device="cuda", generator=gen)
    logits = wide[:, :1000]
    labels = torch.randint(0, 1000, (64,), device="cuda", generator=gen)
    torch.testing.assert_close(xent_forward(logits, labels),
                               xent_forward_reference(logits, labels), rtol=1e-5, atol=1e-4)
