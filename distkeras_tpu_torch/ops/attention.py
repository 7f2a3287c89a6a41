"""Dense attention: counterpart of ``distkeras_tpu/ops/attention.py``
``dot_product_attention``, the path attention takes when flash is off or a
mask is given. Ring attention and the paged decode ops come with later
slices."""

from __future__ import annotations

import torch

__all__ = ["dot_product_attention"]


def dot_product_attention(q, k, v, mask=None, causal: bool = False):
    """Standard attention. ``q/k/v: [B, S, H, D]`` -> ``[B, S, H, D]``.

    The score and value products run in the input dtype (their results
    rounded to it, as the reference's einsums are); the softmax runs in
    float32. ``mask`` broadcasts against ``[B, H, S_q, S_k]``."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        S_q, S_k = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((S_q, S_k), dtype=torch.bool, device=q.device).tril(S_k - S_q)
        scores = torch.where(keep, scores, torch.full_like(scores, -1e30))
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    weights = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
