"""The frozen counts against hand counts at small shapes."""

from __future__ import annotations

import itertools

import pytest

from perfbench import counts


@pytest.mark.parametrize("S", [1, 2, 5, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shift", [0, 1])
def test_attended_pairs_by_enumeration(S, causal, shift):
    if causal and shift:
        # Strict triangle, and row 0 (which sees no key) weighs every key.
        want = sum(1 for q, k in itertools.product(range(S), repeat=2) if k <= q - 1) + S
    elif causal:
        want = sum(1 for q, k in itertools.product(range(S), repeat=2) if k <= q)
    else:
        want = S * S
    assert counts.attended_pairs(S, causal, shift) == want


def _cfg(causal, h=4, m=16, L=2, V=10, heads=2):
    return {"hidden_size": h, "intermediate_size": m, "num_hidden_layers": L,
            "vocab_size": V, "num_attention_heads": heads, "causal": causal,
            "dtype": "bfloat16"}


@pytest.mark.parametrize("causal", [False, True])
def test_model_flops_by_hand(causal):
    h, m, L, V, B, S = 4, 16, 2, 10, 3, 5
    # A product [a, b] x [b, c] is 2abc FLOPs. A token: Q, K, V, O (h x h
    # each), MLP in and out (h x m each), the head (h x V).
    token = L * (4 * 2 * h * h + 2 * 2 * h * m) + 2 * h * V
    pairs = S * (S + 1) // 2 if causal else S * S
    row = S * token + L * (2 * pairs * h + 2 * pairs * h)  # QK^T and PV
    assert counts.model_flops_per_step(_cfg(causal), B, S) == 3 * B * row


def test_model_flops_at_published_sizes():
    bert = {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
            "vocab_size": 30522, "causal": False}
    gpt = dict(bert, vocab_size=50257, causal=True)
    assert counts.model_flops_per_step(bert, 256, 128) == pytest.approx(21.77e12, rel=1e-3)
    assert counts.model_flops_per_step(gpt, 32, 1024) == pytest.approx(26.14e12, rel=1e-3)


def test_flash_bounds_by_hand():
    B, S, H, D = 2, 4, 3, 8
    BH, t = B * H, B * H * S * D * 2  # one bf16 [BH, S, D] tensor's bytes
    got = counts.flash_bounds_s(B, S, H, D, True, "bfloat16")
    pairs = 10
    hbm, peak = counts.HBM_BYTES_PER_S, counts.BF16_TENSOR_FLOPS
    assert got["K1"] == max((4 * t + BH * S * 4) / hbm, 4 * BH * pairs * D / peak)
    assert got["K2"] == max((5 * t + 2 * BH * S * 4) / hbm, 6 * BH * pairs * D / peak)
    assert got["K3"] == max((6 * t + 2 * BH * S * 4) / hbm, 8 * BH * pairs * D / peak)
    f32 = counts.flash_bounds_s(B, S, H, D, True, "float32")
    assert f32["K1"] >= got["K1"]


def test_xent_bounds_by_hand():
    T, V = 6, 7
    got = counts.xent_bounds_s(T, V, "float32", 4)
    hbm = counts.HBM_BYTES_PER_S
    assert got["K4"] == pytest.approx((T * V * 4 + T * 4 + T * 4) / hbm)
    assert got["K5"] == pytest.approx((T * V * 4 + 2 * T * 4) / hbm)
    assert got["K6"] == pytest.approx((2 * T * V * 4 + T * 16) / hbm)


def test_step_bounds_sum_the_families():
    cfg = _cfg(True)
    got = counts.step_bounds_s(cfg, 3, 5)
    flash = counts.flash_bounds_s(3, 5, 2, 2, True, "bfloat16")
    xent = counts.xent_bounds_s(15, 10, "float32", 4)
    assert got["flash"] == pytest.approx(2 * sum(flash.values()))
    assert got["xent"] == pytest.approx(sum(xent.values()))


def test_peaks_by_card_name():
    assert counts.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert counts.peak_flops("NVIDIA H100 PCIe") == 756.0e12
    assert counts.peak_flops("cpu") is None
