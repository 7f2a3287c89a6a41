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
attention. Sequence and tensor parallelism, paged KV and MoE come with later
slices and raise here.

Decode mode (``decode=True``, reference ``bert.py:297-404, :527-551``) keeps
dense K/V caches ``[B, L, H, D]`` (``L = decode_cache_len or max_seq_len``)
and position counters, a scalar each or, with ``decode_slots``, one per
batch row. The cache is a flat dict of tensors under the reference's cache
paths in the port's dotted form (``layer_{i}.attention.cached_key``,
``cached_value``, ``cache_index``; ``pos_index`` at the top). It goes in
with the weights, ``model.apply({**params, **cache}, tokens)``, and the
updated cache comes back as the apply's ``new_state``; a leaf not given
starts at zeros, as a flax cache variable does. Every write and index moves
on the device: no step reads a counter back to the host. The attention
``out`` and ``mlp_out`` projections then form their product in float32,
round it to the compute dtype and add the bias there (two roundings, the
reference's ``_F32AccumDense``).
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
    "BertConfig", "Bert", "EncoderLayer", "SelfAttention", "dropout", "decode_cache",
    "bert_base_mlm", "bert_tiny_mlm", "gpt_tiny", "gpt_small",
]

# Config fields of later slices: a set value raises, naming the slice.
_LATER_SLICES = {
    "paged_blocks": "the paged serving slice (ROADMAP.md §A item A7b)",
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


class _F32AccumDense(Dense):
    """The decode-mode ``attention.out`` and ``mlp_out`` projections
    (reference ``_F32AccumDense``): the product accumulates in float32 and
    is rounded once to the compute dtype, and the bias is added after, in
    that dtype. Names and shapes are ``Dense``'s, so weights carry over."""

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def _reduce_dense(cfg: "BertConfig", in_features: int, out_features: int) -> Dense:
    return (_F32AccumDense if cfg.decode else Dense)(in_features, out_features, cfg.dtype)


def _cache_leaf(module: nn.Module, name: str, shape, dtype, device) -> torch.Tensor:
    """The cache leaf ``name`` given to this apply, or zeros of ``shape``
    when none was (the module's own placeholder is empty)."""
    leaf = getattr(module, name)
    if leaf.numel() == 0:
        return torch.zeros(shape, dtype=dtype, device=device)
    return leaf


def _register_cache(module: nn.Module, *names: str) -> None:
    # Empty, non-persistent placeholders: the cache never enters the
    # state_dict, and an apply swaps the given leaves in by name.
    for name in names:
        module.register_buffer(name, torch.empty(0), persistent=False)


def _pos_window(pos_embed, starts, S: int, max_seq_len: int):
    """Per-row positional window ``[B, S, H]``: row ``b`` takes positions
    ``starts[b] .. starts[b] + S - 1``, each clipped to the table on its own
    (reference ``_pos_window``)."""
    pos_ids = starts[:, None].long() + torch.arange(S, device=starts.device)[None, :]
    return pos_embed[0][pos_ids.clamp(0, max_seq_len - 1)]


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
        self.out = _reduce_dense(cfg, h, h)
        if cfg.decode:
            _register_cache(self, "cached_key", "cached_value", "cache_index")

    def forward(self, x, mask=None, new_cache: dict | None = None):
        """``new_cache`` (decode mode): receives this layer's updated cache
        leaves under their names."""
        cfg = self.cfg
        B, S = x.shape[0], x.shape[1]
        shape = (B, S, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
        q = self.query(x).reshape(shape)
        k = self.key(x).reshape(shape)
        v = self.value(x).reshape(shape)
        if cfg.decode:
            out = self._decode_attention(q, k, v, new_cache)
        elif cfg.use_flash_attention and mask is None:
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = dot_product_attention(q, k, v, mask=mask, causal=cfg.causal)
        return self.out(out.reshape(B, S, cfg.hidden_size))

    def _decode_attention(self, q, k, v, new_cache: dict):
        """KV-cache attention (reference ``_decode_attention``, dense
        branch). One path serves prefill (S = prompt length) and one-token
        steps: the new K/V are written at the cache index, the queries
        attend to the whole cache under ``key position <= query position``,
        and the index advances by S. The write start is clamped to
        ``[0, L - S]``, as ``lax.dynamic_update_slice`` clamps it; with
        slots each row writes at its own index, which advances as
        ``min(idx + S, L)``."""
        cfg = self.cfg
        B, S, H, D = q.shape
        L = cfg.decode_cache_len or cfg.max_seq_len
        dev = q.device
        ck = _cache_leaf(self, "cached_key", (B, L, H, D), cfg.dtype, dev)
        cv = _cache_leaf(self, "cached_value", (B, L, H, D), cfg.dtype, dev)
        idx = _cache_leaf(self, "cache_index", (B,) if cfg.decode_slots else (),
                          torch.int32, dev)
        steps = torch.arange(S, device=dev)
        rows = idx.long().expand(B)  # per-row write index
        write = (rows.clamp(0, max(L - S, 0))[:, None] + steps[None, :])[:, :, None, None]
        write = write.expand(B, S, H, D)
        ck = ck.scatter(1, write, k.to(ck.dtype))
        cv = cv.scatter(1, write, v.to(cv.dtype))
        k_pos = torch.arange(L, device=dev)
        if cfg.decode_slots:
            new_idx = torch.clamp(idx + S, max=L)
            q_pos = idx.long()[:, None] + steps[None, :]  # [B, S]
            mask = k_pos[None, None, None, :] <= q_pos[:, None, :, None]  # [B, 1, S, L]
        else:
            new_idx = idx + S
            q_pos = idx.long() + steps  # [S]
            mask = (k_pos[None, :] <= q_pos[:, None])[None, None]  # [1, 1, S, L]
        new_cache["cached_key"] = ck
        new_cache["cached_value"] = cv
        new_cache["cache_index"] = new_idx
        return dot_product_attention(q, ck, cv, mask=mask)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = _layer_norm(cfg.hidden_size)
        self.attention = SelfAttention(cfg)
        self.ln_mlp = _layer_norm(cfg.hidden_size)
        self.mlp_in = Dense(cfg.hidden_size, cfg.mlp_dim, cfg.dtype)
        self.mlp_out = _reduce_dense(cfg, cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x, mask=None, train: bool = False, rng: int | None = None,
                new_cache: dict | None = None):
        p = self.cfg.dropout_rate if train else 0.0
        y = self.attention(self.ln_attn(x.float()), mask=mask, new_cache=new_cache)
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
        if cfg.decode:
            _register_cache(self, "pos_index")

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
        ``fold_in(rng, i)``. In decode mode returns ``(logits, new_cache)``."""
        cfg = self.cfg
        B, S = token_ids.shape[0], token_ids.shape[1]
        table = self.token_embed.weight
        x = F.embedding(token_ids.long(), table).to(cfg.dtype)
        new_cache = None
        if cfg.decode:
            # Positions advance with the caches (reference bert.py:527-551).
            new_cache = {}
            pi = _cache_leaf(self, "pos_index", (B,) if cfg.decode_slots else (),
                             torch.int32, x.device)
            if cfg.decode_slots:
                pos = _pos_window(self.pos_embed, pi, S, cfg.max_seq_len)  # [B, S, H]
                new_cache["pos_index"] = torch.clamp(pi + S, max=cfg.max_seq_len)
            else:
                # lax.dynamic_slice clamps the window into the table; a
                # plain slice past its end would silently shorten.
                start = pi.long().clamp(0, cfg.max_seq_len - S)
                pos = self.pos_embed[:, start + torch.arange(S, device=x.device)]
                new_cache["pos_index"] = pi + S
            x = x + pos.to(cfg.dtype)
        else:
            x = x + self.pos_embed[:, :S].to(cfg.dtype)

        def site(i):
            return None if rng is None else fold_in(rng, i)

        x = dropout(x, cfg.dropout_rate if train else 0.0, site(0))
        for i, layer in enumerate(self.layers()):
            layer_cache = None if new_cache is None else {}
            x = layer(x, train=train, rng=site(i + 1), new_cache=layer_cache)
            if layer_cache:
                new_cache.update({f"layer_{i}.attention.{k}": v for k, v in layer_cache.items()})
        x = self.ln_final(x.float())
        # The vocab rows are padded to a multiple of 8 so that the product's
        # rows stay 16-byte aligned: with 30522 or 50257 columns cuBLAS
        # otherwise takes an unaligned kernel several times slower. The pad
        # columns are dropped before the bias.
        w = F.pad(table.to(cfg.dtype), (0, 0, 0, -cfg.vocab_size % 8))
        logits = torch.matmul(x.to(cfg.dtype), w.t())[..., : cfg.vocab_size]
        logits = torch.add(logits, self.mlm_bias)  # widens to float32 in the add
        return logits if new_cache is None else (logits, new_cache)


def decode_cache(cfg: BertConfig, batch_size: int, device) -> dict[str, torch.Tensor]:
    """The zero decode cache of ``cfg`` for ``batch_size`` rows, keyed as
    :class:`Bert` reads and returns it."""
    L = cfg.decode_cache_len or cfg.max_seq_len
    D = cfg.hidden_size // cfg.num_heads
    idx_shape = (batch_size,) if cfg.decode_slots else ()
    cache = {"pos_index": torch.zeros(idx_shape, dtype=torch.int32, device=device)}
    for i in range(cfg.num_layers):
        prefix = f"layer_{i}.attention."
        for name in ("cached_key", "cached_value"):
            cache[prefix + name] = torch.zeros((batch_size, L, cfg.num_heads, D),
                                               dtype=cfg.dtype, device=device)
        cache[prefix + "cache_index"] = torch.zeros(idx_shape, dtype=torch.int32, device=device)
    return cache


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
