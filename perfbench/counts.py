"""The benchmark's own counts: model FLOPs, kernel bytes and operations, and
the card's published peaks.

These are the yardstick, frozen with the benchmark: they follow the model's
mathematics and the kernels' inputs and outputs, never how the program
computes them. Nothing here imports the program.

- Model FLOPs count the matrix products the model needs, forward and
  backward (3x the forward), and no recomputation: the layers' projections
  and MLP, QK^T and PV over the query-key pairs the mask needs (the causal
  triangle under a causal mask), and the tied head.
- A kernel's bound is the larger of its bytes over the memory's rate and its
  operations over the peak of its dtype, each input read once and each
  output written once (the byte and pair counts are those the repository's
  kernel smoke test uses).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16/fp16 tensor-core peak
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores

# Published dense bf16 peaks by card name, first match wins: "NVIDIA H100
# 80GB HBM3" is the SXM card.
PEAK_FLOPS = (
    ("h100 pcie", 756.0e12),
    ("h100 nvl", 835.5e12),
    ("h100", 989.4e12),
    ("h200", 989.4e12),
    ("gh200", 989.4e12),
    ("a100", 312.0e12),
)


def peak_flops(device_name: str) -> float | None:
    """The card's published dense bf16 rate in FLOP/s, or None for a card
    not in the table."""
    name = device_name.lower()
    for key, flops in PEAK_FLOPS:
        if key in name:
            return flops
    return None


def attended_pairs(S: int, causal: bool, shift: int = 0) -> int:
    """Query-key pairs the attention needs: all of them, the causal
    triangle, or the strict triangle plus row 0, which under shift 1 sees no
    key and so weighs every key equally."""
    if not causal:
        return S * S
    return S * (S + 1) // 2 if shift == 0 else S * (S - 1) // 2 + S


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time the card could take: bytes at the memory's rate or
    operations at the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_ops)


def model_flops_per_step(cfg: dict, batch: int, seq: int) -> float:
    """Matrix-product FLOPs of one training step (forward and backward) of
    the bert-family model ``cfg`` over ``batch`` rows of ``seq`` tokens."""
    h, m = cfg["hidden_size"], cfg["intermediate_size"]
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    per_token = L * (2 * 4 * h * h + 2 * 2 * h * m) + 2 * h * V
    per_row = seq * per_token + L * 2 * 2 * attended_pairs(seq, cfg["causal"]) * h
    return 3.0 * batch * per_row


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def flash_peak(dtype: str) -> float:
    """The data sheet's peak for products in ``dtype``: the tensor cores'
    in 16 bits, float32's in float32 (whatever a kernel builds its float32
    products from)."""
    return F32_FLOPS if dtype == "float32" else BF16_TENSOR_FLOPS


def flash_bounds_s(B: int, S: int, H: int, D: int, causal: bool, dtype: str) -> dict:
    """Bounds of K1 (forward), K2 (dQ) and K3 (dK, dV) over ``[B*H, S, D]``
    inputs: K1 reads Q, K, V and writes O (and the float32 lse); K2 reads Q,
    K, V, dO and writes dQ (and reads lse and delta); K3 reads K, V, Q, dO
    and writes dK, dV (and reads lse and delta)."""
    BH = B * H
    tensor = BH * S * D * _DTYPE_BYTES[dtype]
    stats = 2 * BH * S * 4
    pairs = attended_pairs(S, causal)
    peak = flash_peak(dtype)
    return {
        "K1": bound_s(4 * tensor + BH * S * 4, 4.0 * BH * pairs * D, peak),
        "K2": bound_s(5 * tensor + stats, 6.0 * BH * pairs * D, peak),
        "K3": bound_s(6 * tensor + stats, 8.0 * BH * pairs * D, peak),
    }


def xent_bounds_s(T: int, V: int, logits_dtype: str, label_bytes: int) -> dict:
    """Bounds of K4 (loss), K5 (row max and sum) and K6 (dlogits) over
    ``[T, V]`` logits: K4 reads the logits and labels and writes a float32
    loss a row; K5 reads the logits and writes two float32 statistics a row;
    K6 reads the logits, labels, upstream gradient and statistics and writes
    dlogits in the logits' dtype."""
    es = _DTYPE_BYTES[logits_dtype]
    return {
        "K4": bound_s(T * V * es + T * label_bytes + T * 4, 4.0 * T * V, F32_FLOPS),
        "K5": bound_s(T * V * es + 2 * T * 4, 4.0 * T * V, F32_FLOPS),
        "K6": bound_s(2 * T * V * es + T * (label_bytes + 12), 5.0 * T * V, F32_FLOPS),
    }


def step_bounds_s(cfg: dict, batch: int, seq: int, label_bytes: int = 4) -> dict:
    """Each hand kernel family's summed bound over one training step: the
    flash kernels once a layer, the loss kernels once a step."""
    heads = cfg["num_attention_heads"]
    D = cfg["hidden_size"] // heads
    flash = flash_bounds_s(batch, seq, heads, D, cfg["causal"], cfg["dtype"])
    # The logits widen to float32 where the head adds its float32 bias.
    xent = xent_bounds_s(batch * seq, cfg["vocab_size"], "float32", label_bytes)
    return {"flash": cfg["num_hidden_layers"] * sum(flash.values()),
            "xent": sum(xent.values())}
