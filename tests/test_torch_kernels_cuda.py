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


def test_flash_kernel_takes_float32_on_the_generic_route(gen):
    """float32 at the Hopper kernels' head dim goes to K1g: both counts move,
    and the result is the plain version's to float32 rounding."""
    q, k, v = (torch.randn(2, 64, 64, device="cuda", generator=gen) for _ in range(3))
    before = flash_forward.launches, flash_forward.generic.launches
    out, lse = flash_forward(q, k, v)
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_forward.generic.launches) == tuple(
        n + 1 for n in before)
    ref_out, ref_lse = flash_forward_reference(q, k, v)
    _close_generic(out, ref_out, torch.float32, backward=False)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)


# The generic route (K1g-K3g) against the plain versions: every dtype, head
# dims padded to 16, 64, 128 and 256 (36 and 80 ragged inside their tiles,
# rows of 72-160 bytes in bf16, not 16-byte multiples), 320 and 512 in
# column chunks, and lengths below one 64-row tile, ragged past one and two
# tiles. Tolerances, of the largest magnitude of the plain version's result
# (at least 1): float32 2e-5 (the same float32 products summed in another
# order; exps by different code; K2g/K3g take their products in 3xTF32,
# hi.hi + hi.lo + lo.hi of a TF32 hi and the rest lo, which leaves out lo.lo
# and lo's truncation to TF32 bits, within about 2^-20 = 9.5e-7 of each
# product); bfloat16 2e-2 forward (P rounded against different maxima: the online
# softmax's running max against the row's max), 1e-2 backward (P and dS
# rounded from exps by different code, one bf16 ulp apart near a rounding
# boundary); float16 2.5e-3 forward (one float16 ulp, 2^-11 relative, of P,
# and O's own rounding, one ulp at 1-2) and 2e-3 backward (one float16 ulp,
# 2^-10 relative at most, of the largest gradient, and P's and dS's
# roundings). lse, float32 in every case, to 1e-5 of its magnitude (at least 1).
_GENERIC_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
_GENERIC_DIMS = [8, 36, 80, 128, 256, 320, 512]
_GENERIC_LENGTHS = [1, 17, 127, 200]
_GENERIC_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 1e-2),
                torch.float16: (2.5e-3, 2e-3)}


def _close_generic(got, want, dtype, backward):
    assert got.dtype == want.dtype == dtype
    scale = max(want.float().abs().max().item(), 1.0)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _GENERIC_TOL[dtype][backward] * scale, (err, scale)


@pytest.mark.parametrize("dtype", _GENERIC_DTYPES)
@pytest.mark.parametrize("D", _GENERIC_DIMS)
@pytest.mark.parametrize("S", _GENERIC_LENGTHS)
@pytest.mark.parametrize("causal,shift", [(False, 0), (True, 0), (True, 1)])
def test_flash_generic_kernel_matches_plain(gen, dtype, D, S, causal, shift):
    """K1g (B = 1, H = 3); under shift 1 row 0 sees no key, averages every V
    row and gets lse exactly -1e30, as the plain version's."""
    q, k, v = (torch.randn(3, S, D, device="cuda", generator=gen).to(dtype) for _ in range(3))
    before = flash_forward.launches, flash_forward.generic.launches
    out, lse = flash_forward(q, k, v, causal=causal, causal_shift=shift)
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_forward.generic.launches) == tuple(
        n + 1 for n in before)
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal, shift)
    _close_generic(out, ref_out, dtype, backward=False)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    if causal and shift:
        assert torch.equal(lse[:, 0], ref_lse[:, 0])


# (T, V) for K4 and K5: ragged vocabularies on both schedules (narrow rows
# up to 16 KB, one warp each; wider rows a block each), the main path's
# shapes at their widest, one row, and a part-full last block.
_XENT_SHAPES = [(333, 30522), (333, 50257), (333, 100), (4096, 50257), (1, 30522), (1, 1024),
                (37, 1000), (2048, 1024)]


def _xent_labels(gen, T, V, label_dtype):
    """Labels in [-2, V + 2); int64 ones every 7th moved up by 2^32."""
    labels = torch.randint(-2, V + 2, (T,), device="cuda", generator=gen, dtype=label_dtype)
    if label_dtype == torch.int64:
        labels[::7] += 2**32
    return labels


@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("T,V", _XENT_SHAPES)
def test_xent_kernel_matches_plain(gen, dtype, T, V, label_dtype):
    """Per-row loss at ragged vocabularies, int32 and int64 labels (read as
    they are) including out-of-range ones (which pick nothing, int64 ones
    of 2^32 and more too). 1e-5 relative: both reduce in float32, in
    another order."""
    logits = (torch.randn(T, V, device="cuda", generator=gen) * 3).to(dtype)
    labels = _xent_labels(gen, T, V, label_dtype)
    before = xent_forward.launches
    got = xent_forward(logits, labels)
    torch.cuda.synchronize()
    assert xent_forward.launches == before + 1
    torch.testing.assert_close(got, xent_forward_reference(logits, labels),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("T,V,pad,col,dtype", [
    (64, 1000, 100, 0, torch.float32),    # 16-byte aligned rows
    (64, 1000, 3, 1, torch.float32),      # rows start 4 bytes past 16
    (64, 30522, 7, 3, torch.bfloat16),    # wide rows, 6 bytes past 16, odd stride
    (300, 50257, 9, 5, torch.float32),    # wide rows, 4 bytes past 16
])
def test_xent_kernel_takes_row_strided_logits(gen, T, V, pad, col, dtype):
    """K4 and K5 on a view of columns ``col .. col + V`` of a ``[T, V +
    pad]`` buffer: row stride V + pad, rows starting where the view says,
    the bytes around each row in the buffer never counted."""
    wide = (torch.randn(T, V + pad, device="cuda", generator=gen) * 3).to(dtype)
    logits = wide[:, col:col + V]
    labels = torch.randint(0, V, (T,), device="cuda", generator=gen)
    torch.testing.assert_close(xent_forward(logits, labels),
                               xent_forward_reference(logits, labels), rtol=1e-5, atol=1e-4)
    m, s = xent_stats(logits)
    want_m, want_s = xent_stats_reference(logits)
    assert torch.equal(m, want_m)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=0)


def _backward_inputs(gen, BH, Sq, Skv, D, causal, shift, dtype=torch.bfloat16):
    """q/k/v/dO of ``dtype`` (bf16 by default) and the float32 lse and delta
    the forward would give, computed densely (S_q may differ from S_kv)."""
    q, do = (torch.randn(BH, Sq, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(BH, Skv, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * D**-0.5
    if causal:
        keep = (torch.arange(Sq, device="cuda")[:, None]
                >= torch.arange(Skv, device="cuda")[None, :] + shift)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.matmul(torch.softmax(s, dim=-1), v.float()).to(dtype)
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


@pytest.mark.parametrize("dtype", _GENERIC_DTYPES)
@pytest.mark.parametrize("D", _GENERIC_DIMS)
@pytest.mark.parametrize("Sq,Skv", [(S, S) for S in _GENERIC_LENGTHS]
                         + [(17, 200), (200, 17), (1, 127)])
@pytest.mark.parametrize("causal,shift", [(False, 0), (True, 0), (True, 1)])
def test_flash_generic_backward_kernels_match_plain(gen, dtype, D, Sq, Skv, causal, shift):
    """K2g and K3g (B = 1, H = 3), S_q != S_kv both ways; under shift 1 the
    fully masked row 0, whose P is 1 for every key."""
    q, k, v, do, lse, delta = _backward_inputs(gen, 3, Sq, Skv, D, causal, shift, dtype)
    n_dq, n_dkv = dq_call.generic.launches, dkv_call.generic.launches
    dq = dq_call(q, k, v, do, lse, delta, causal, shift)
    dk, dv = dkv_call(k, v, q, do, lse, delta, causal, shift)
    torch.cuda.synchronize()
    assert (dq_call.generic.launches, dkv_call.generic.launches) == (n_dq + 1, n_dkv + 1)
    _close_generic(dq, flash_dq_reference(q, k, v, do, lse, delta, causal, shift), dtype, True)
    want_dk, want_dv = flash_dkv_reference(k, v, q, do, lse, delta, causal, shift)
    _close_generic(dk, want_dk, dtype, True)
    _close_generic(dv, want_dv, dtype, True)


# The generic kernels' staging on views at element offset 1 of a flat buffer
# (bases 2 or 4 bytes off a 16-byte boundary, so the copies go by 4 or 2
# bytes): bf16 at D=64, which the Hopper route leaves to the generic one for
# its alignment alone, D=36 in each dtype and float16 at D=128; S=200 under
# each mask, and S=1000 under the strict causal mask (16 query tiles, dealt
# longest first). The tolerances are _GENERIC_TOL's.
_UNALIGNED = [(torch.bfloat16, 64), (torch.float32, 36), (torch.bfloat16, 36),
              (torch.float16, 36), (torch.float16, 128)]
_UNALIGNED_MASKS = [(200, False, 0), (200, True, 0), (200, True, 1), (1000, True, 1)]


def _offset_view(x):
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:].copy_(x.reshape(-1))
    view = flat[1:].view(x.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype,D", _UNALIGNED)
@pytest.mark.parametrize("S,causal,shift", _UNALIGNED_MASKS)
def test_flash_generic_kernel_takes_unaligned_views(gen, dtype, D, S, causal, shift):
    """K1g on inputs whose bases are not 16-byte aligned; under shift 1 row
    0's lse is exactly -1e30."""
    q, k, v = (_offset_view(torch.randn(3, S, D, device="cuda", generator=gen).to(dtype))
               for _ in range(3))
    before = flash_forward.generic.launches
    out, lse = flash_forward(q, k, v, causal=causal, causal_shift=shift)
    torch.cuda.synchronize()
    assert flash_forward.generic.launches == before + 1
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal, shift)
    _close_generic(out, ref_out, dtype, backward=False)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    if shift:
        assert bool((lse[:, 0] == -1e30).all())


@pytest.mark.parametrize("dtype,D", _UNALIGNED)
@pytest.mark.parametrize("S,causal,shift", _UNALIGNED_MASKS)
def test_flash_generic_backward_kernels_take_unaligned_views(gen, dtype, D, S, causal, shift):
    """K2g and K3g on inputs whose bases are not 16-byte aligned."""
    q, k, v, do, lse, delta = _backward_inputs(gen, 3, S, S, D, causal, shift, dtype)
    q, k, v, do = map(_offset_view, (q, k, v, do))
    n_dq, n_dkv = dq_call.generic.launches, dkv_call.generic.launches
    dq = dq_call(q, k, v, do, lse, delta, causal, shift)
    dk, dv = dkv_call(k, v, q, do, lse, delta, causal, shift)
    torch.cuda.synchronize()
    assert (dq_call.generic.launches, dkv_call.generic.launches) == (n_dq + 1, n_dkv + 1)
    _close_generic(dq, flash_dq_reference(q, k, v, do, lse, delta, causal, shift), dtype, True)
    want_dk, want_dv = flash_dkv_reference(k, v, q, do, lse, delta, causal, shift)
    _close_generic(dk, want_dk, dtype, True)
    _close_generic(dv, want_dv, dtype, True)


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


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_float32_gradient_on_the_card(gen, causal):
    """The autograd path in float32 (the generic route: K1g, then K2g and
    K3g) against the plain versions on the card, to 2e-5 of the largest
    gradient; one launch of each kernel, on the generic route."""
    q, k, v = (torch.randn(2, 256, 4, 64, device="cuda", generator=gen).requires_grad_()
               for _ in range(3))
    g = torch.randn(2, 256, 4, 64, device="cuda", generator=gen)
    wrappers = (flash_forward, dq_call, dkv_call)
    before = [(w.launches, w.generic.launches) for w in wrappers]
    grads = torch.autograd.grad(flash_attention(q, k, v, causal=causal), (q, k, v), g)
    torch.cuda.synchronize()
    assert [(w.launches, w.generic.launches) for w in wrappers] == [
        (a + 1, b + 1) for a, b in before]

    def fold(x):
        return x.detach().permute(0, 2, 1, 3).reshape(8, 256, 64).contiguous()

    qf, kf, vf, gf = map(fold, (q, k, v, g))
    out, lse = flash_forward_reference(qf, kf, vf, causal)
    delta = (gf * out).sum(-1, keepdim=True)
    want = (flash_dq_reference(qf, kf, vf, gf, lse, delta, causal),
            *flash_dkv_reference(kf, vf, qf, gf, lse, delta, causal))
    for got, w in zip(grads, want):
        _close_generic(fold(got), w, torch.float32, backward=True)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_of_one_hop_in_float32_is_flash_on_the_card(gen, causal):
    """The flash ring at sp=1 in float32 (the long-context example's path):
    K1g, the float32 merge and K2g/K3g give flash attention's output and
    gradients bit for bit, one generic launch of each kernel."""
    from distkeras_tpu_torch.ops.ring_flash import ring_flash_attention
    from distkeras_tpu_torch.parallel.mesh import make_mesh

    q, k, v = (torch.randn(1, 512, 4, 128, device="cuda", generator=gen).requires_grad_()
               for _ in range(3))
    g = torch.randn(1, 512, 4, 128, device="cuda", generator=gen)
    want = flash_attention(q, k, v, causal=causal)
    want_grads = torch.autograd.grad(want, (q, k, v), g)
    wrappers = (flash_forward.generic, dq_call.generic, dkv_call.generic)
    counts = [w.launches for w in wrappers]
    got = ring_flash_attention(q, k, v, make_mesh({"sp": 1}, devices=[0]), causal=causal)
    grads = torch.autograd.grad(got, (q, k, v), g)
    assert [w.launches for w in wrappers] == [n + 1 for n in counts]
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_of_one_hop_is_flash_on_the_card(gen, causal):
    """The flash ring at sp=1 (no process group): K1, the float32 merge into
    (0, -inf) and K2/K3 give flash attention's output and gradients bit for
    bit, one launch of each kernel."""
    from distkeras_tpu_torch.ops.ring_flash import ring_flash_attention
    from distkeras_tpu_torch.parallel.mesh import make_mesh

    q, k, v = (torch.randn(2, 256, 4, 64, device="cuda", generator=gen).bfloat16()
               .requires_grad_() for _ in range(3))
    g = torch.randn(2, 256, 4, 64, device="cuda", generator=gen).bfloat16()
    want = flash_attention(q, k, v, causal=causal)
    want_grads = torch.autograd.grad(want, (q, k, v), g)
    counts = [flash_forward.launches, dq_call.launches, dkv_call.launches]
    got = ring_flash_attention(q, k, v, make_mesh({"sp": 1}, devices=[0]), causal=causal)
    grads = torch.autograd.grad(got, (q, k, v), g)
    assert [flash_forward.launches, dq_call.launches, dkv_call.launches] == [
        n + 1 for n in counts]
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,V", _XENT_SHAPES)
def test_xent_backward_kernels_match_plain(gen, dtype, T, V, label_dtype):
    """K5 and K6 at ragged vocabularies, labels including out-of-range ones
    (int64 ones of 2^32 and more pick no column, not the one they would
    wrap to in int32).
    m exactly (a max); s and the f32 gradient to 1e-4 relative (float32 exps
    from different code, summed in another order); bf16 gradients one bf16
    rounding of the same float32 values. The gradient is held element by
    element, with an absolute floor (1e-15) far below its smallest entries."""
    logits = (torch.randn(T, V, device="cuda", generator=gen) * 3).to(dtype)
    labels = _xent_labels(gen, T, V, label_dtype)
    g = torch.rand(T, device="cuda", generator=gen) / T
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
