"""Weights of a bert-family configuration, made from the seed.

The benchmark makes the weights and hands the same ones to the program and
to the plain reference. They are float32 (the master weights the program
trains), drawn on the device from one ``torch.Generator`` in one call and
cut into leaves: normal(0, initializer_range) embeddings, a normal clipped
to two deviations and scaled to variance 1/fan_in for the dense kernels
(a truncated lecun normal), zero biases, unit LayerNorm scales. The leaves
carry the names the bert family's layout documents (``token_embed.weight``,
``pos_embed``, ``layer_{i}.attention.query.weight``, ...), a dense kernel as
``[out, in]``.
"""

from __future__ import annotations

import math

import torch

# The truncated normal's standard deviation at (-2, 2), by which flax's
# lecun_normal divides so that the clipped draw keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def leaf_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight of ``cfg`` by name, in a fixed order."""
    h, m = cfg["hidden_size"], cfg["intermediate_size"]
    V, P = cfg["vocab_size"], cfg["max_position_embeddings"]
    shapes: dict[str, tuple[int, ...]] = {"token_embed.weight": (V, h), "pos_embed": (1, P, h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layer_{i}."
        shapes[p + "ln_attn.weight"] = shapes[p + "ln_attn.bias"] = (h,)
        for name in ("query", "key", "value", "out"):
            shapes[p + f"attention.{name}.weight"] = (h, h)
            shapes[p + f"attention.{name}.bias"] = (h,)
        shapes[p + "ln_mlp.weight"] = shapes[p + "ln_mlp.bias"] = (h,)
        shapes[p + "mlp_in.weight"], shapes[p + "mlp_in.bias"] = (m, h), (m,)
        shapes[p + "mlp_out.weight"], shapes[p + "mlp_out.bias"] = (h, m), (h,)
    shapes["ln_final.weight"] = shapes["ln_final.bias"] = (h,)
    shapes["mlm_bias"] = (V,)
    return shapes


def _kind(name: str) -> str:
    if name in ("token_embed.weight", "pos_embed"):
        return "embed"
    if name.endswith("ln_attn.weight") or name.endswith("ln_mlp.weight") \
            or name == "ln_final.weight":
        return "one"
    if name.endswith(".weight"):
        return "dense"
    return "zero"


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The float32 weights of ``cfg`` from ``seed``, on ``device``."""
    shapes = leaf_shapes(cfg)
    drawn = [n for n in shapes if _kind(n) in ("embed", "dense")]
    total = sum(math.prod(shapes[n]) for n in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind = _kind(name)
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            x = flat[at:at + n].view(shape)
            at += n
            if kind == "embed":
                out[name] = x * cfg["initializer_range"]
            else:
                std = shape[1] ** -0.5 / _TRUNC_STD
                out[name] = x.clamp(-2.0, 2.0) * std
    return out
