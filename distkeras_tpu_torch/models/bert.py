"""BERT encoder family (masked LM) and the GPT-style causal LMs.

Counterpart of ``distkeras_tpu/models/bert.py``, the non-decode path: the
same config fields, module names and parameter layout (so the reference's
weights carry across through :mod:`distkeras_tpu_torch.utils.bridge`), and
the same numerics:

- weights are float32; each ``Dense`` casts its input and weights to
  ``cfg.dtype`` (bfloat16 by default) for the matmul, as flax's
  ``nn.Dense(dtype=...)`` does;
- LayerNorm runs in float32 with epsilon 1e-6 (flax's default, not torch's
  1e-5) and returns float32;
- GELU is the tanh approximation (flax ``nn.gelu``'s default);
- the residual stream stays in ``cfg.dtype``;
- the tied head multiplies in ``cfg.dtype`` (flax ``Embed.attend`` promotes
  both sides) and adds the float32 ``mlm_bias``, so logits are float32.

Dropout keeps flax's semantics (keep with probability ``1 - rate``, scale
by ``1 / (1 - rate)``, in the input's dtype) and draws its masks from
``torch.Generator``s seeded inside the forward from the ``rng`` seed the
caller passes, one derived seed per dropout site, so a recompute under
``torch.utils.checkpoint`` draws the same masks.

Attention takes the flash kernel (:mod:`distkeras_tpu_torch.ops.flash_attention`)
when ``use_flash_attention`` is set and no mask is given, else dense
attention. Decode, sequence and tensor parallelism, paged KV and MoE come
with later slices and raise here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.flash_attention import flash_attention
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = [
    "BertConfig", "Bert", "EncoderLayer", "SelfAttention", "dropout",
    "bert_base_mlm", "bert_tiny_mlm", "gpt_tiny", "gpt_small",
]

# Config fields of later slices: a set value raises, naming the slice.
_LATER_SLICES = {
    "decode": "the generation slice",
    "paged_blocks": "the serving-engine slice",
    "tp_mesh": "the multi-device slice",
    "ring_mesh": "the multi-device slice",
    "moe_experts": "the remaining-models slice",
}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_seq_len: int = 512
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    use_flash_attention: bool = False
    moe_experts: int = 0
    moe_top_k: int = 1
    causal: bool = False
    ring_mesh: object = None
    ring_axis: str = "sp"
    sp_impl: str = "ring"
    decode: bool = False
    decode_slots: bool = False
    decode_cache_len: int = 0
    paged_blocks: int = 0
    page_tokens: int = 16
    page_table_blocks: int = 0
    tp_mesh: object = None

    def __post_init__(self):
        for name, where in _LATER_SLICES.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"BertConfig.{name} is not ported yet: it comes with {where}")


def dropout(x, rate: float, seed: int | None):
    """flax ``nn.Dropout`` in train mode: keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``, in x's dtype. The keep
    mask comes from a ``torch.Generator`` on x's device seeded with ``seed``."""
    if rate == 0.0:
        return x
    if seed is None:
        raise ValueError("dropout in train mode needs a seed: apply(..., train=True, rng=seed)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _lecun_normal_(weight: torch.Tensor, generator) -> None:
    """flax ``lecun_normal``: truncated normal (±2σ), variance 1/fan_in."""
    fan_in = weight.shape[1]  # torch Linear weight is [out, in]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` with float32 weights and its matmul in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def init_weights(self, generator) -> None:
        _lecun_normal_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _layer_norm(hidden: int) -> nn.LayerNorm:
    return nn.LayerNorm(hidden, eps=1e-6)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Dense(h, h, cfg.dtype)
        self.key = Dense(h, h, cfg.dtype)
        self.value = Dense(h, h, cfg.dtype)
        self.out = Dense(h, h, cfg.dtype)

    def forward(self, x, mask=None):
        cfg = self.cfg
        B, S = x.shape[0], x.shape[1]
        shape = (B, S, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
        q = self.query(x).reshape(shape)
        k = self.key(x).reshape(shape)
        v = self.value(x).reshape(shape)
        if cfg.use_flash_attention and mask is None:
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = dot_product_attention(q, k, v, mask=mask, causal=cfg.causal)
        return self.out(out.reshape(B, S, cfg.hidden_size))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = _layer_norm(cfg.hidden_size)
        self.attention = SelfAttention(cfg)
        self.ln_mlp = _layer_norm(cfg.hidden_size)
        self.mlp_in = Dense(cfg.hidden_size, cfg.mlp_dim, cfg.dtype)
        self.mlp_out = Dense(cfg.mlp_dim, cfg.hidden_size, cfg.dtype)

    def forward(self, x, mask=None, train: bool = False, rng: int | None = None):
        p = self.cfg.dropout_rate if train else 0.0
        y = self.attention(self.ln_attn(x.float()), mask=mask)
        x = x + dropout(y, p, None if rng is None else fold_in(rng, 0))
        y = self.mlp_in(self.ln_mlp(x.float()))
        y = self.mlp_out(F.gelu(y, approximate="tanh"))
        return x + dropout(y, p, None if rng is None else fold_in(rng, 1)).to(x.dtype)


class Bert(nn.Module):
    """BERT encoder with a tied-embedding MLM head.

    Input: integer token ids ``[B, S]``. Output: float32 vocab logits
    ``[B, S, V]``. Submodules are named as the reference's flax modules
    (``token_embed``, ``pos_embed``, ``layer_{i}``, ``ln_final``,
    ``mlm_bias``)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.max_seq_len, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg))
        self.ln_final = _layer_norm(cfg.hidden_size)
        self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def init_weights(self, generator) -> None:
        """Initial weights as the reference draws them (in distribution):
        normal(0.02) embeddings, lecun-normal dense kernels, zero biases,
        unit LayerNorm scales."""
        nn.init.normal_(self.token_embed.weight, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        nn.init.zeros_(self.mlm_bias)
        for module in self.modules():
            if isinstance(module, Dense):
                module.init_weights(generator)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def forward(self, token_ids, train: bool = False, rng: int | None = None):
        """``rng``: the integer seed of this forward's dropout masks (needed
        when ``train`` and ``dropout_rate > 0``); site ``i`` draws from
        ``fold_in(rng, i)``."""
        cfg = self.cfg
        S = token_ids.shape[1]
        table = self.token_embed.weight
        x = F.embedding(token_ids.long(), table).to(cfg.dtype)
        x = x + self.pos_embed[:, :S].to(cfg.dtype)

        def site(i):
            return None if rng is None else fold_in(rng, i)

        x = dropout(x, cfg.dropout_rate if train else 0.0, site(0))
        for i, layer in enumerate(self.layers()):
            x = layer(x, train=train, rng=site(i + 1))
        x = self.ln_final(x.float())
        # The vocab rows are padded to a multiple of 8 so that the product's
        # rows stay 16-byte aligned: with 30522 or 50257 columns cuBLAS
        # otherwise takes an unaligned kernel several times slower. The pad
        # columns are dropped before the bias.
        w = F.pad(table.to(cfg.dtype), (0, 0, 0, -cfg.vocab_size % 8))
        logits = torch.matmul(x.to(cfg.dtype), w.t())[..., : cfg.vocab_size]
        return torch.add(logits, self.mlm_bias)  # widens to float32 in the add


def _bert_flops(cfg: BertConfig, seq_len: int) -> float:
    per_token = cfg.num_layers * 2 * (4 * cfg.hidden_size**2 + 2 * cfg.hidden_size * cfg.mlp_dim)
    attn = cfg.num_layers * 2 * 2 * seq_len * cfg.hidden_size
    head = 2 * cfg.hidden_size * cfg.vocab_size
    return float(seq_len * (per_token + attn + head))


def _make(cfg: BertConfig, seq_len: int, name: str) -> Model:
    m = Model(
        lambda: Bert(cfg),
        name=name,
        input_shape=(seq_len,),
        output_dim=cfg.vocab_size,
        flops_per_example=_bert_flops(cfg, seq_len),
    )
    m.config = cfg
    return m


def bert_base_mlm(seq_len: int = 128, vocab_size: int = 30522) -> Model:
    return _make(BertConfig(vocab_size=vocab_size), seq_len, "bert_base_mlm")


def bert_tiny_mlm(seq_len: int = 64, vocab_size: int = 1024,
                  dropout_rate: float = 0.1) -> Model:
    cfg = BertConfig(
        vocab_size=vocab_size, hidden_size=128, num_layers=2, num_heads=4,
        mlp_dim=512, max_seq_len=max(seq_len, 64),
        dropout_rate=dropout_rate,
    )
    return _make(cfg, seq_len, "bert_tiny_mlm")


def gpt_tiny(seq_len: int = 64, vocab_size: int = 1024) -> Model:
    """Decoder-only causal LM (GPT-style): the same stack with causal
    masking and the tied LM head."""
    cfg = BertConfig(
        vocab_size=vocab_size, hidden_size=128, num_layers=2, num_heads=4,
        mlp_dim=512, max_seq_len=max(seq_len, 64), causal=True,
    )
    return _make(cfg, seq_len, "gpt_tiny")


def gpt_small(seq_len: int = 512, vocab_size: int = 50257) -> Model:
    """GPT-2-small-shaped causal LM (124M params)."""
    cfg = BertConfig(
        vocab_size=vocab_size, hidden_size=768, num_layers=12, num_heads=12,
        mlp_dim=3072, max_seq_len=max(seq_len, 512), causal=True,
    )
    return _make(cfg, seq_len, "gpt_small")
