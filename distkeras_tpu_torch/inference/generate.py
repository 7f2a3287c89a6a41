"""Autoregressive generation with KV caches for the causal-LM family.

Counterpart of ``distkeras_tpu/inference/generate.py``. The decode-mode
twin of a model (``BertConfig.decode``: dense K/V caches ``[B, L, H, D]``
written at a cache index, same weights) runs the prompt in ONE prefill
forward, then one forward per new token, each feeding the previous step's
cache back in. Everything stays on the weights' device: the next token is
chosen there and fed back without a host round trip, and the tokens come to
the host once, at the end. The loop is eager torch under
``torch.inference_mode()``; the reference's ``lax.scan`` has no counterpart
here.

Sampling: greedy (argmax at bfloat16 resolution, lowest id on a tie),
temperature and top-k, drawn from a ``torch.Generator`` on the device
seeded with ``seed``; the draws differ from ``jax.random``'s. Decode never
takes the flash kernel, as in the reference: the products are
``F.linear``/``torch.matmul`` and attention is the dense
:func:`~distkeras_tpu_torch.ops.attention.dot_product_attention`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from distkeras_tpu_torch.models.bert import Bert, BertConfig, decode_cache
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["generate", "beam_search", "Generator", "accept_prefix_length",
           "cache_with_index", "greedy_accept_length", "greedy_ids", "sample_rows"]

_PAGED = ("paged_blocks", "page_tokens", "page_table_blocks")


@functools.lru_cache(maxsize=8)
def _decode_model(dec_cfg: BertConfig) -> Model:
    # One specification (a meta module) per decode config, not one per call.
    return Model(lambda: Bert(dec_cfg), name="decode")


def _decode_module(model, slots: bool = False, **overrides):
    """Decode-mode twin of ``model`` (same weights, KV-cache attention) and
    its config. ``slots=True`` gives each batch row its own cache and
    position index; ``overrides`` are other BertConfig replacements
    (``decode_cache_len``). The paged geometry is not ported."""
    cfg = getattr(model, "config", None)
    if not isinstance(cfg, BertConfig):
        raise ValueError(
            "generate() needs a causal model from the distkeras_tpu_torch.models."
            f"bert zoo (gpt_tiny/gpt_small/...); got {getattr(model, 'name', model)!r}"
        )
    if not cfg.causal:
        raise ValueError(
            f"model {model.name!r} is not causal (BertConfig.causal=False); "
            "generation requires a decoder LM"
        )
    paged = sorted(set(overrides) & set(_PAGED))
    if paged:
        raise NotImplementedError(
            f"paged decode ({', '.join(paged)}) is not ported yet: it comes with the "
            "paged serving slice (ROADMAP.md §A item A7b)")
    dec_cfg = dataclasses.replace(
        cfg, decode=True, decode_slots=slots, dropout_rate=0.0,
        ring_mesh=None, use_flash_attention=False, **overrides,
    )
    return _decode_model(dec_cfg), dec_cfg


def _trained_len(model, dec_cfg) -> int:
    # `or`, not a getattr default: input_shape may be None.
    shape = getattr(model, "input_shape", None) or (dec_cfg.max_seq_len,)
    return shape[0]


def _context_limit(model, dec_cfg) -> int:
    """Decodable context bound: the TRAINED length, not the cache's
    capacity; positions past what training touched hold randomly
    initialised positional embeddings."""
    return min(dec_cfg.max_seq_len, _trained_len(model, dec_cfg))


def _check_context(model, dec_cfg, prompt, max_new_tokens: int):
    """Shared validation of generate() and beam_search(), with the
    reference's messages."""
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be [B, S0]; got {tuple(prompt.shape)}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    S0 = prompt.shape[1]
    trained_len = _trained_len(model, dec_cfg)
    limit = _context_limit(model, dec_cfg)
    if S0 + max_new_tokens > limit:
        raise ValueError(
            f"prompt ({S0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"{limit} (= min(max_seq_len {dec_cfg.max_seq_len}, trained "
            f"context {trained_len})); positions past the trained context "
            f"have untrained positional embeddings — build the model with a "
            f"larger seq_len to decode further"
        )


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "batch-parallel decoding over a mesh is not ported yet: it comes with the "
            "multi-device slice (ROADMAP.md §A item A10)")


def _empty_cache(dec_cfg: BertConfig, batch_size: int, device) -> dict[str, torch.Tensor]:
    """The zero cache of the decode config for ``batch_size`` rows."""
    return decode_cache(dec_cfg, batch_size, device)


def cache_with_index(cache: dict, index) -> dict:
    """``cache`` with every 1-D index leaf (the per-row cache and position
    counters of a slots cache) set to ``index`` (a number, or one per
    row); the K/V leaves pass through untouched. The one way offsets move
    in a decode cache: a prefill continues at position ``index`` when the
    cache rows before it hold that prefix's K/V."""
    out = {}
    for name, leaf in cache.items():
        if leaf.ndim == 1:
            value = torch.as_tensor(index, device=leaf.device).to(leaf.dtype)
            leaf = value.expand(leaf.shape).clone()
        out[name] = leaf
    return out


def greedy_ids(logits: torch.Tensor) -> torch.Tensor:
    """THE greedy token selection: argmax over the logits rounded to
    bfloat16, the lowest index winning a tie (``torch.argmax`` returns the
    first maximum). Rounding makes the choice blind to sub-bf16 noise, so
    a one-token step, a prefill window and a batched row pick the same
    token."""
    return torch.argmax(logits.to(torch.bfloat16), dim=-1).to(torch.int32)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor, generator: torch.Generator,
                top_k: int | None) -> torch.Tensor:
    """Per-row sampling over ``[B, V]`` logits: rows with ``temps <= 0``
    take :func:`greedy_ids`; the others sample at their own temperature,
    with optional top-k filtering (the k-th largest scaled logit and every
    logit equal to it stay). The draw is the Gumbel-max form of a
    categorical draw, as ``jax.random.categorical``'s, from ``generator``."""
    logits = logits.float()
    greedy = greedy_ids(logits)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, -torch.inf)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def accept_prefix_length(match: torch.Tensor) -> torch.Tensor:
    """Length of each row's all-True prefix of ``match`` (bool ``[B, K]``):
    int32 ``[B]`` in ``[0, K]``, stopping at the first False."""
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def greedy_accept_length(drafts: torch.Tensor, target_greedy: torch.Tensor) -> torch.Tensor:
    """Longest prefix of ``drafts`` equal to ``target_greedy`` (int ``[B,
    K]``) per row: the strict token-equality form of the speculative accept
    rule."""
    return accept_prefix_length(drafts == target_greedy)


def _prepare(model, variables, prompt, max_new_tokens, device):
    dec, dec_cfg = _decode_module(model)
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32, device=dev)
    _check_context(model, dec_cfg, prompt, max_new_tokens)
    params = {k: v.to(dev) for k, v in variables.items()}
    return dec, dec_cfg, params, prompt


def _step(dec: Model, params: dict, cache: dict, tokens: torch.Tensor):
    """One decode forward: the last position's logits and the new cache."""
    logits, cache = dec.apply({**params, **cache}, tokens)
    return logits[:, -1], cache


def generate(
    model,
    variables,
    prompt,
    max_new_tokens: int,
    temperature: float = 1.0,
    top_k: int | None = None,
    greedy: bool = False,
    seed: int = 0,
    mesh=None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Generate ``max_new_tokens`` continuations of ``prompt`` ``[B, S0]``
    on ``device`` (CUDA unless ``"cpu"`` is asked for; the weights move
    there). Returns an int32 ``[B, max_new_tokens]`` array of token ids.
    ``seed`` seeds the sampling generator on the device. ``mesh`` (the
    reference's batch-parallel decoding) is not ported and raises."""
    _refuse_mesh(mesh)
    dec, dec_cfg, params, prompt = _prepare(model, variables, prompt, max_new_tokens, device)
    if top_k is not None and not 1 <= top_k <= dec_cfg.vocab_size:
        raise ValueError(f"top_k={top_k} outside [1, vocab_size={dec_cfg.vocab_size}]")
    B, dev = prompt.shape[0], prompt.device
    gen = None
    if not greedy:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        temps = torch.full((B,), float(temperature), dtype=torch.float32, device=dev)

    def choose(logits):
        return greedy_ids(logits) if greedy else sample_rows(logits, temps, gen, top_k)

    with torch.inference_mode():
        # Prefill: one forward over the whole prompt fills every cache.
        logits, cache = _step(dec, params, _empty_cache(dec_cfg, B, dev), prompt)
        tokens = [choose(logits)]
        for _ in range(max_new_tokens - 1):
            logits, cache = _step(dec, params, cache, tokens[-1][:, None])
            tokens.append(choose(logits))
        return torch.stack(tokens, dim=1).cpu().numpy()


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, descending, the
    lower index first on a tie (a stable sort; ``torch.topk`` does not
    promise the order of equal values)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def beam_search(
    model,
    variables,
    prompt,
    max_new_tokens: int,
    num_beams: int = 4,
    mesh=None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-length beam search: keep the ``num_beams`` highest total
    log-probability continuations per batch item. Each beam carries its own
    KV cache; reordering gathers every cache leaf with a batch dimension
    along the flattened beam axis (the scalar index leaves stay shared).

    Returns ``(sequences, scores)``: int32 ``[B, num_beams,
    max_new_tokens]`` sorted by score, and float32 ``[B, num_beams]`` total
    log-probabilities; ``sequences[:, 0]`` is the best beam. No EOS
    handling. ``device`` and ``mesh`` as in :func:`generate`."""
    _refuse_mesh(mesh)
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    dec, dec_cfg, params, prompt = _prepare(model, variables, prompt, max_new_tokens, device)
    K, (B, _), N, dev = num_beams, prompt.shape, max_new_tokens, prompt.device

    def apply(cache, tokens):
        logits, cache = _step(dec, params, cache, tokens)
        return torch.log_softmax(logits.float(), dim=-1), cache

    def gather(cache, rows):
        return {k: c[rows] if c.ndim > 0 else c for k, c in cache.items()}

    with torch.inference_mode():
        # Prefill on the un-replicated batch, then fan each item out to K beams.
        logp, cache = apply(_empty_cache(dec_cfg, B, dev), prompt)  # [B, V]
        V = logp.shape[-1]
        scores, toks = _top_k(logp, K)  # [B, K]
        cache = gather(cache, torch.arange(B, device=dev).repeat_interleave(K))
        hist = torch.zeros((B, K, N), dtype=torch.int32, device=dev)
        hist[:, :, 0] = toks
        tok = toks
        for i in range(1, N):
            logp, cache = apply(cache, tok.reshape(B * K, 1).to(torch.int32))  # [B*K, V]
            cand = scores[:, :, None] + logp.reshape(B, K, V)
            scores, idx = _top_k(cand.reshape(B, K * V), K)  # [B, K]
            parent = idx // V
            tok = (idx % V).to(torch.int32)
            cache = gather(cache, (torch.arange(B, device=dev)[:, None] * K + parent).reshape(-1))
            hist = torch.take_along_dim(hist, parent[:, :, None], dim=1)
            hist[:, :, i] = tok
        return hist.cpu().numpy(), scores.cpu().numpy()


class Generator:
    """Stateful wrapper around :func:`generate` holding the model and its
    weights, placed once on ``device`` (CUDA unless ``"cpu"`` is asked
    for)."""

    def __init__(self, model, variables, device: str | torch.device | None = None):
        self.model = model
        self.device = resolve_device(device)
        self.variables = {k: v.to(self.device) for k, v in variables.items()}

    def __call__(self, prompt, max_new_tokens: int, **kw) -> np.ndarray:
        return generate(self.model, self.variables, prompt, max_new_tokens,
                        device=self.device, **kw)

    def beam(self, prompt, max_new_tokens: int, num_beams: int = 4):
        return beam_search(self.model, self.variables, prompt, max_new_tokens,
                           num_beams=num_beams, device=self.device)
