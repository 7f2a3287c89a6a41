"""Fused softmax cross-entropy, forward and backward: Triton kernels and
their plain versions.

Counterpart of ``distkeras_tpu/ops/pallas/fused_xent.py``. Three Triton
kernels replace the three Pallas kernels, per row of ``[T, V]`` logits:

- K4, the ``_fwd_kernel`` launched by ``_call_fwd``:
  ``loss = log(sum(exp(x - m))) + m - x[label]`` in float32;
- K5, the ``_stats_kernel`` launched first by ``_call_bwd``: the row max
  ``m`` and ``s = sum(exp(x - m))``;
- K6, the ``_grad_kernel`` launched next by ``_call_bwd``:
  ``dlogits = (exp(x - m) / s - onehot(label)) * g`` in the logits' dtype.

What bounds them on the H100: each reads every logit once (K6 also writes
one gradient per logit) and does a handful of float32 operations on it, so
the logits' bytes bound them: at T = 4096, V = 30522 in f32, 500 MB take
about 149 us at 3.35 TB/s (K4, K5) and 1 GB about 298 us (K6). The Pallas
kernels carried running statistics in scratch across a sequential vocab
grid axis; Hopper runs blocks in no order, so K4 and K5 give one program
one row and loop over the vocabulary inside it, with the running max and
sum in registers (an online logsumexp: one chunk maximum, one exp per
logit). K6 has no carry, so it is a grid over (row, vocab chunk) that fills
the card. A label outside ``[0, V)`` picks no column, as the reference's
iota compare does, and the ragged vocab edge (30522, 50257) is masked, not
padded, so no padded copy of the logits is made.

:func:`xent_forward`, :func:`xent_stats` and :func:`xent_grad` dispatch on
the tensor's device (the plain version for a CPU tensor, the kernel for a
CUDA tensor: nothing falls back) and count kernel launches in their
``launches`` attributes, exactly when several threads launch. The backward of :func:`xent_forward` runs K5 then
K6, as the reference's ``_call_bwd`` does.
"""

from __future__ import annotations

import functools

import torch

from distkeras_tpu_torch.ops.launches import count_launch

__all__ = [
    "fused_softmax_xent", "xent_forward", "xent_forward_reference", "xent_grad",
    "xent_grad_reference", "xent_stats", "xent_stats_reference",
]

_BLOCK_V = 4096       # K4, K5: the vocab chunk of the loop in one row's program
_NUM_WARPS = 8
_GRAD_BLOCK_V = 2048  # K6: the vocab chunk of one program
_GRAD_NUM_WARPS = 4


def xent_forward_reference(logits, labels):
    """Plain version of K4: ``logits [T, V]``, integer ``labels [T]`` ->
    float32 per-row loss ``[T]``. A label outside ``[0, V)`` picks nothing
    (0), as the reference kernel's iota compare does."""
    x = logits.float()
    V = x.shape[-1]
    m = x.amax(dim=-1)
    s = torch.exp(x - m[:, None]).sum(dim=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < V)
    picked = x.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    return torch.log(s) + m - picked


def xent_stats_reference(logits):
    """Plain version of K5: ``logits [T, V]`` -> float32 ``(m [T], s [T])``,
    the row max and ``sum(exp(x - m))``."""
    x = logits.float()
    m = x.amax(dim=-1)
    return m, torch.exp(x - m[:, None]).sum(dim=-1)


def xent_grad_reference(logits, labels, g, m, s):
    """Plain version of K6: ``(exp(x - m) / s - onehot(label)) * g`` per
    row, in the logits' dtype. ``g``, ``m``, ``s``: float32 ``[T]``."""
    x = logits.float()
    p = torch.exp(x - m[:, None]) / s[:, None]
    cols = torch.arange(x.shape[-1], device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    return ((p - onehot) * g.float()[:, None]).to(logits.dtype)


@functools.cache
def _triton_kernels() -> dict:
    """K4, K5 and K6 by name, compiled by Triton on first use."""
    import triton
    import triton.language as tl

    @triton.jit
    def row_stats(base, V, BLOCK_V: tl.constexpr):
        """One row's max ``m`` and ``sum(exp(x - m))`` in float32, as an
        online logsumexp over chunks of ``BLOCK_V`` logits."""
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
        return m, s

    @triton.jit
    def xent_fwd_kernel(logits_ptr, labels_ptr, loss_ptr, V, stride_row,
                        BLOCK_V: tl.constexpr):
        row = tl.program_id(0)
        base = logits_ptr + row.to(tl.int64) * stride_row
        m, s = row_stats(base, V, BLOCK_V)
        label = tl.load(labels_ptr + row)
        valid = (label >= 0) & (label < V)
        picked = tl.load(base + label, mask=valid, other=0.0).to(tl.float32)
        tl.store(loss_ptr + row, tl.log(s) + m - picked)

    @triton.jit
    def xent_stats_kernel(logits_ptr, m_ptr, s_ptr, V, stride_row,
                          BLOCK_V: tl.constexpr):
        row = tl.program_id(0)
        m, s = row_stats(logits_ptr + row.to(tl.int64) * stride_row, V, BLOCK_V)
        tl.store(m_ptr + row, m)
        tl.store(s_ptr + row, s)

    @triton.jit
    def xent_grad_kernel(logits_ptr, labels_ptr, g_ptr, m_ptr, s_ptr, out_ptr, V,
                         stride_row, stride_out, BLOCK_V: tl.constexpr):
        row = tl.program_id(0)
        idx = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
        inside = idx < V
        x = tl.load(logits_ptr + row.to(tl.int64) * stride_row + idx, mask=inside,
                    other=0.0).to(tl.float32)
        p = tl.exp(x - tl.load(m_ptr + row)) / tl.load(s_ptr + row)
        onehot = tl.where(idx == tl.load(labels_ptr + row), 1.0, 0.0)
        d = (p - onehot) * tl.load(g_ptr + row)
        tl.store(out_ptr + row.to(tl.int64) * stride_out + idx,
                 d.to(out_ptr.dtype.element_ty), mask=inside)

    return {"fwd": xent_fwd_kernel, "stats": xent_stats_kernel, "grad": xent_grad_kernel}


def _on_cpu(x) -> bool:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type == "cpu"
    raise ValueError(f"fused xent runs on cpu or cuda, not {x.device}")


def _check_logits(logits, **rows) -> None:
    """What the kernels take: ``[T, V]`` f32/bf16/f16 logits with contiguous
    rows, and ``[T]`` per-row tensors on the same device."""
    if logits.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"the xent kernels take f32/bf16/f16 logits, got {logits.dtype}")
    if logits.ndim != 2 or logits.stride(1) != 1:
        raise ValueError("the xent kernels take [T, V] logits with contiguous rows")
    for name, x in rows.items():
        if x.device != logits.device or x.shape != logits.shape[:1]:
            raise ValueError(f"{name} must be [T] on {logits.device}, "
                             f"got {tuple(x.shape)} on {x.device}")


def _xent_forward_cuda(logits, labels):
    _check_logits(logits, labels=labels)
    T, V = logits.shape
    labels = labels.to(torch.int32).contiguous()
    loss = torch.empty(T, dtype=torch.float32, device=logits.device)
    if T:
        with torch.cuda.device(logits.device):
            _triton_kernels()["fwd"][(T,)](logits, labels, loss, V, logits.stride(0),
                                       BLOCK_V=_BLOCK_V, num_warps=_NUM_WARPS)
        count_launch(xent_forward)
    return loss


class _XentForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        if _on_cpu(logits):
            return xent_forward_reference(logits, labels)
        return _xent_forward_cuda(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        m, s = xent_stats(logits)
        return xent_grad(logits, labels, g, m, s), None


def xent_forward(logits, labels):
    """Per-row loss ``[T]`` (float32) of ``[T, V]`` logits: the plain version
    for CPU tensors, the Triton kernel (K4) for CUDA tensors.
    Differentiable in the logits."""
    return _XentForward.apply(logits, labels)


xent_forward.launches = 0


def xent_stats(logits):
    """``(m, s)``, float32 ``[T]`` each, of ``[T, V]`` logits: the plain
    version for CPU tensors, the Triton kernel (K5) for CUDA tensors."""
    if _on_cpu(logits):
        return xent_stats_reference(logits)
    _check_logits(logits)
    T, V = logits.shape
    m = torch.empty(T, dtype=torch.float32, device=logits.device)
    s = torch.empty(T, dtype=torch.float32, device=logits.device)
    if T:
        with torch.cuda.device(logits.device):
            _triton_kernels()["stats"][(T,)](logits, m, s, V, logits.stride(0),
                                       BLOCK_V=_BLOCK_V, num_warps=_NUM_WARPS)
        count_launch(xent_stats)
    return m, s


xent_stats.launches = 0


def xent_grad(logits, labels, g, m, s):
    """``dlogits [T, V]`` in the logits' dtype from integer ``labels`` and
    the per-row ``g``, ``m`` and ``s`` (float32 ``[T]``): the plain version
    for CPU tensors, the Triton kernel (K6) for CUDA tensors."""
    if _on_cpu(logits):
        return xent_grad_reference(logits, labels, g, m, s)
    _check_logits(logits, labels=labels, g=g, m=m, s=s)
    T, V = logits.shape
    labels = labels.to(torch.int32).contiguous()
    g, m, s = (x.float().contiguous() for x in (g, m, s))
    out = torch.empty((T, V), dtype=logits.dtype, device=logits.device)
    if T and V:
        with torch.cuda.device(logits.device):
            _triton_kernels()["grad"][(T, -(-V // _GRAD_BLOCK_V))](
                logits, labels, g, m, s, out, V, logits.stride(0), out.stride(0),
                BLOCK_V=_GRAD_BLOCK_V, num_warps=_GRAD_NUM_WARPS)
        count_launch(xent_grad)
    return out


xent_grad.launches = 0


def fused_softmax_xent(logits, labels):
    """Mean cross-entropy over tokens. ``logits``: ``[..., V]``; ``labels``:
    integer ids of the leading shape. Registered in the loss registry as
    ``"fused_categorical_crossentropy"``."""
    V = logits.shape[-1]
    return xent_forward(logits.reshape(-1, V), labels.reshape(-1)).mean()
