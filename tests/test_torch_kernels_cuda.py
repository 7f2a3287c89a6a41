"""The port's hand-written kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere. They
import neither JAX nor the reference package, so they also run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

import threading

import pytest
import torch

from distkeras_tpu_torch.ops.flash_attention import (
    dkv_call,
    dq_call,
    flash_attention,
    flash_dkv_reference,
    flash_dq_reference,
    flash_forward,
    flash_forward_reference,
)
from distkeras_tpu_torch.ops.fused_xent import (
    fused_softmax_xent,
    xent_forward,
    xent_forward_reference,
    xent_grad,
    xent_grad_reference,
    xent_stats,
    xent_stats_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("D", [32, 64])
def test_hopper_building_blocks(gen, D):
    """The TMA loads (64- or 128-byte swizzle by D) and the wgmma forms the
    kernels use, alone: s = q k^T with both operands K-major in shared
    memory, o = p v with A from registers and B MN-major through the
    transpose bit, against float32 matmuls of the same bf16 values (exact
    products, summed in another order)."""
    from distkeras_tpu_torch.ops.flash_attention import _kernel, _launch

    q, k, v = (torch.randn(64, D, device="cuda", generator=gen).bfloat16() for _ in range(3))
    p = torch.randn(64, 64, device="cuda", generator=gen).bfloat16()
    s = torch.empty(64, 64, device="cuda")
    o = torch.empty(64, D, device="cuda")
    _launch(_kernel("flash_attention_fwd", "hopper_selftest_bf16", 6, 1), "hopper_selftest",
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), s.data_ptr(),
            o.data_ptr(), D, 0.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(o, p.float() @ v.float(), rtol=1e-5, atol=1e-4)


# Lengths below one 64-row tile and not a multiple of 8, one and two tiles
# exactly, and ragged past them.
_LENGTHS = [1, 17, 64, 127, 128, 200, 256]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", _LENGTHS)
@pytest.mark.parametrize("causal,shift", [(False, 0), (True, 0), (True, 1)])
def test_flash_kernel_matches_plain(gen, D, S, causal, shift):
    """bf16 q/k/v of B = 1, H = 12 at every edge of the tiles; under shift 1
    row 0 sees no key and averages every V row. O to 2e-2: the two round P
    to bf16 against different maxima; lse to 1e-3, float32 summed in
    another order (and exactly -1e30 for row 0 under shift 1)."""
    q, k, v = (torch.randn(12, S, D, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    before = flash_forward.launches
    out, lse = flash_forward(q, k, v, causal=causal, causal_shift=shift)
    torch.cuda.synchronize()
    assert flash_forward.launches == before + 1
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal, shift)
    assert (out.float() - ref_out.float()).abs().max().item() < 2e-2
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    if causal and shift:
        assert torch.equal(lse[:, 0], ref_lse[:, 0])  # -1e30, as the reference's


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


def _backward_inputs(gen, BH, Sq, Skv, D, causal, shift):
    """bf16 q/k/v/dO and the float32 lse and delta the forward would give,
    computed densely (S_q may differ from S_kv)."""
    q, do = (torch.randn(BH, Sq, D, device="cuda", generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(BH, Skv, D, device="cuda", generator=gen).bfloat16() for _ in range(2))
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * D**-0.5
    if causal:
        keep = (torch.arange(Sq, device="cuda")[:, None]
                >= torch.arange(Skv, device="cuda")[None, :] + shift)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.matmul(torch.softmax(s, dim=-1), v.float()).bfloat16()
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    return q, k, v, do, lse, delta


def _close(got, want):
    """bf16 gradients: both round P and dS to bf16 before the products, but
    from exps computed by different code, so a weight near a rounding
    boundary may land one bf16 ulp apart; 1e-2 of the largest value."""
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * max(scale, 1e-3), (err, scale)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("Sq,Skv", [(S, S) for S in _LENGTHS]
                         + [(96, 200), (200, 72), (17, 256), (256, 17)])
@pytest.mark.parametrize("causal,shift", [(False, 0), (True, 0), (True, 1)])
def test_flash_backward_kernels_match_plain(gen, D, Sq, Skv, causal, shift):
    """K2 and K3 (B = 1, H = 12) at every edge of the 64-query and 128-key
    tiles, S_q != S_kv both ways, and under shift 1 the fully masked row 0,
    whose P is 1 for every key."""
    q, k, v, do, lse, delta = _backward_inputs(gen, 12, Sq, Skv, D, causal, shift)
    n_dq, n_dkv = dq_call.launches, dkv_call.launches
    dq = dq_call(q, k, v, do, lse, delta, causal, shift)
    dk, dv = dkv_call(k, v, q, do, lse, delta, causal, shift)
    torch.cuda.synchronize()
    assert (dq_call.launches, dkv_call.launches) == (n_dq + 1, n_dkv + 1)
    _close(dq, flash_dq_reference(q, k, v, do, lse, delta, causal, shift))
    want_dk, want_dv = flash_dkv_reference(k, v, q, do, lse, delta, causal, shift)
    _close(dk, want_dk)
    _close(dv, want_dv)


@pytest.mark.parametrize("B,S,causal,shift", [(32, 128, False, 0), (8, 512, True, 0),
                                               (8, 512, True, 1)])
def test_flash_dq_kernel_at_main_path_shapes(gen, B, S, causal, shift):
    """K2 at the main path's shapes (H = 12, D = 64): bert_base and gpt_small
    causal, shift 0 and 1, each 768 work items, more than the card's
    resident blocks, so that every persistent block walks several items and
    refills its (Q, dO) slots. Two launches on the same inputs give
    bitwise-equal dQ: each item owns its rows, and nothing is summed
    across blocks."""
    q, k, v, do, lse, delta = _backward_inputs(gen, B * 12, S, S, 64, causal, shift)
    n_dq = dq_call.launches
    dq = dq_call(q, k, v, do, lse, delta, causal, shift)
    again = dq_call(q, k, v, do, lse, delta, causal, shift)
    torch.cuda.synchronize()
    assert dq_call.launches == n_dq + 2
    _close(dq, flash_dq_reference(q, k, v, do, lse, delta, causal, shift))
    assert torch.equal(dq, again)


@pytest.mark.parametrize("B", [1, 2])
def test_flash_attention_gradient_on_the_card(gen, B):
    """The autograd path end to end: forward K1, backward K2 and K3, against
    the same function through the plain versions on the card. At B = 1 the
    fold of [B, S, H, D] to [BH, S, D] is a strided view that must be made
    contiguous for the kernels."""
    q, k, v = (torch.randn(B, 256, 4, 64, device="cuda", generator=gen).bfloat16()
               .requires_grad_() for _ in range(3))
    g = torch.randn(B, 256, 4, 64, device="cuda", generator=gen).bfloat16()
    grads = torch.autograd.grad(flash_attention(q, k, v, causal=True), (q, k, v), g)

    def fold(x):
        return x.detach().permute(0, 2, 1, 3).reshape(B * 4, 256, 64).contiguous()

    qf, kf, vf, gf = map(fold, (q, k, v, g))
    out, lse = flash_forward_reference(qf, kf, vf, True)
    delta = (gf.float() * out.float()).sum(-1, keepdim=True)
    want = (flash_dq_reference(qf, kf, vf, gf, lse, delta, True),
            *flash_dkv_reference(kf, vf, qf, gf, lse, delta, True))
    for got, w in zip(grads, want):
        _close(fold(got), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [30522, 50257, 100])
def test_xent_backward_kernels_match_plain(gen, dtype, V):
    """K5 and K6 at ragged vocabularies, labels including out-of-range ones.
    m exactly (a max); s and the f32 gradient to 1e-4 relative (float32 exps
    from different code, summed in another order); bf16 gradients one bf16
    rounding of the same float32 values. The gradient is held element by
    element, with an absolute floor (1e-15) far below its smallest entries."""
    logits = (torch.randn(333, V, device="cuda", generator=gen) * 3).to(dtype)
    labels = torch.randint(-2, V + 2, (333,), device="cuda", generator=gen)
    g = torch.rand(333, device="cuda", generator=gen) / 333
    n_stats, n_grad = xent_stats.launches, xent_grad.launches
    m, s = xent_stats(logits)
    d = xent_grad(logits, labels, g, m, s)
    torch.cuda.synchronize()
    assert (xent_stats.launches, xent_grad.launches) == (n_stats + 1, n_grad + 1)
    want_m, want_s = xent_stats_reference(logits)
    assert torch.equal(m, want_m)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=0)
    want = xent_grad_reference(logits, labels, g, want_m, want_s)
    assert d.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(d, want, rtol=1e-4, atol=1e-15)
    else:
        torch.testing.assert_close(d.float(), want.float(), rtol=1.6e-2, atol=1e-15)


def test_xent_gradient_on_the_card(gen):
    """fused_softmax_xent's gradient through K4, K5 and K6 against the plain
    versions' on the same logits."""
    logits = (torch.randn(256, 30522, device="cuda", generator=gen) * 3).requires_grad_()
    labels = torch.randint(0, 30522, (256,), device="cuda", generator=gen)
    (got,) = torch.autograd.grad(fused_softmax_xent(logits, labels), (logits,))
    m, s = xent_stats_reference(logits.detach())
    g = torch.full((256,), 1 / 256, device="cuda")
    want = xent_grad_reference(logits.detach(), labels, g, m, s)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-15)


def test_kernels_from_two_threads_on_two_streams(gen):
    """What the async trainers do: two threads, each on its own CUDA stream,
    run the flash forward and backward (K1-K3) and the fused cross-entropy
    forward and backward (K4-K6) on their own bert_base-shaped inputs, ten
    rounds each. Every result equals a one-thread run of the same inputs
    bit for bit, and each wrapper's launch count grows by exactly the
    launches made."""
    rounds = 10
    inputs = []
    for _ in range(2):
        q, k, v = (torch.randn(32 * 12, 128, 64, device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        logits = torch.randn(512, 30522, device="cuda", generator=gen) * 3
        labels = torch.randint(0, 30522, (512,), device="cuda", generator=gen)
        inputs.append((q, k, v, logits, labels))

    def run(q, k, v, logits, labels):
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        out, _ = flash_forward(*qkv)
        grads = torch.autograd.grad(out.float().square().sum(), qkv)
        x = logits.detach().requires_grad_()
        loss = fused_softmax_xent(x, labels)
        (dx,) = torch.autograd.grad(loss, (x,))
        return [out, *grads, loss, dx]

    want = [run(*inp) for inp in inputs]
    torch.cuda.synchronize()
    wrappers = (flash_forward, dq_call, dkv_call, xent_forward, xent_stats, xent_grad)
    before = [w.launches for w in wrappers]
    results = [[], []]
    errors = []

    def worker(i):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for _ in range(rounds):
                    results[i].append(run(*inputs[i]))
                stream.synchronize()
        except BaseException as e:  # reported on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for i in range(2):
        assert len(results[i]) == rounds
        for got in results[i]:
            for g, w in zip(got, want[i]):
                assert torch.equal(g, w)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2 * rounds] * 6
