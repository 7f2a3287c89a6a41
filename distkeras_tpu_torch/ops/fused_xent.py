"""Fused softmax cross-entropy forward: a Triton kernel and its plain version.

Counterpart of ``distkeras_tpu/ops/pallas/fused_xent.py``. The Triton kernel
replaces the Pallas ``_fwd_kernel`` launched by ``_call_fwd``: per row of
``[T, V]`` logits, ``loss = log(sum(exp(x - m))) + m - x[label]`` in float32.

What bounds it on the H100: it reads every logit once and does a handful of
float32 operations on each (max, subtract, exp, add), so the logits' bytes
bound it: 500 MB of f32 logits at T = 4096, V = 30522 take about 149 us at
3.35 TB/s. The Pallas kernel carried the running max and sum in scratch
across a sequential vocab grid axis; Hopper runs blocks in no order, so here
one program owns one row and loops over the vocabulary inside itself, with
the running max and sum in registers (an online logsumexp: one chunk
maximum, one exp per logit), and reads the label's logit with one masked
load. The ragged vocab edge (30522, 50257) is masked, not padded, so no
padded copy of the logits is made.

:func:`xent_forward` dispatches on the tensor's device and counts kernel
launches in its ``launches`` attribute. The backward kernels
(``_stats_kernel``, ``_grad_kernel``) belong to the training slice, so
differentiating through :func:`fused_softmax_xent` raises.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["fused_softmax_xent", "xent_forward", "xent_forward_reference"]

_BLOCK_V = 4096
_NUM_WARPS = 8


def xent_forward_reference(logits, labels):
    """Plain version: ``logits [T, V]``, integer ``labels [T]`` -> float32
    per-row loss ``[T]``. A label outside ``[0, V)`` picks nothing (0), as
    the reference kernel's iota compare does."""
    x = logits.float()
    V = x.shape[-1]
    m = x.amax(dim=-1)
    s = torch.exp(x - m[:, None]).sum(dim=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < V)
    picked = x.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    return torch.log(s) + m - picked


@functools.cache
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def xent_fwd_kernel(logits_ptr, labels_ptr, loss_ptr, V, stride_row,
                        BLOCK_V: tl.constexpr):
        row = tl.program_id(0)
        base = logits_ptr + row.to(tl.int64) * stride_row
        cols = tl.arange(0, BLOCK_V)
        # Rank-0 float32 carries for the running max and sum.
        m = tl.max(tl.full([BLOCK_V], -1e30, tl.float32), axis=0)
        s = tl.sum(tl.zeros([BLOCK_V], tl.float32), axis=0)
        for start in range(0, V, BLOCK_V):
            idx = start + cols
            x = tl.load(base + idx, mask=idx < V, other=float("-inf")).to(tl.float32)
            m_new = tl.maximum(m, tl.max(x, axis=0))
            s = s * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new), axis=0)
            m = m_new
        label = tl.load(labels_ptr + row)
        valid = (label >= 0) & (label < V)
        picked = tl.load(base + label, mask=valid, other=0.0).to(tl.float32)
        tl.store(loss_ptr + row, tl.log(s) + m - picked)

    return xent_fwd_kernel


def _xent_forward_cuda(logits, labels):
    if logits.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"the xent kernel takes f32/bf16/f16 logits, got {logits.dtype}")
    if logits.ndim != 2 or logits.stride(1) != 1:
        raise ValueError("the xent kernel takes [T, V] logits with contiguous rows")
    if labels.device != logits.device or labels.shape != logits.shape[:1]:
        raise ValueError(f"labels must be [T] on {logits.device}, got {labels.shape} on {labels.device}")
    T, V = logits.shape
    labels = labels.to(torch.int32).contiguous()
    loss = torch.empty(T, dtype=torch.float32, device=logits.device)
    if T:
        with torch.cuda.device(logits.device):
            _triton_kernel()[(T,)](logits, labels, loss, V, logits.stride(0),
                                   BLOCK_V=_BLOCK_V, num_warps=_NUM_WARPS)
        xent_forward.launches += 1
    return loss


class _XentForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        if logits.device.type == "cpu":
            return xent_forward_reference(logits, labels)
        if logits.device.type == "cuda":
            return _xent_forward_cuda(logits, labels)
        raise ValueError(f"fused xent runs on cpu or cuda, not {logits.device}")

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "fused xent backward (stats and grad kernels) comes with the training slice")


def xent_forward(logits, labels):
    """Per-row loss ``[T]`` (float32) of ``[T, V]`` logits: the plain version
    for CPU tensors, the Triton kernel for CUDA tensors."""
    return _XentForward.apply(logits, labels)


xent_forward.launches = 0


def fused_softmax_xent(logits, labels):
    """Mean cross-entropy over tokens. ``logits``: ``[..., V]``; ``labels``:
    integer ids of the leading shape. Registered in the loss registry as
    ``"fused_categorical_crossentropy"``."""
    V = logits.shape[-1]
    return xent_forward(logits.reshape(-1, V), labels.reshape(-1)).mean()
