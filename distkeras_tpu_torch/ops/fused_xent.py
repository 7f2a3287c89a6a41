"""Fused softmax cross-entropy, forward and backward: kernels for Hopper
and their plain versions.

Counterpart of ``distkeras_tpu/ops/pallas/fused_xent.py``. Three kernels
replace the three Pallas kernels, per row of ``[T, V]`` logits:

- K4, the ``_fwd_kernel`` launched by ``_call_fwd``:
  ``loss = log(sum(exp(x - m))) + m - x[label]`` in float32
  (CUDA C++, ``csrc/fused_xent_fwd.cu``);
- K5, the ``_stats_kernel`` launched first by ``_call_bwd``: the row max
  ``m`` and ``s = sum(exp(x - m))`` (the same CUDA source);
- K6, the ``_grad_kernel`` launched next by ``_call_bwd``:
  ``dlogits = (exp(x - m) / s - onehot(label)) * g`` in the logits' dtype
  (Triton, below).

What bounds them on the H100: each reads every logit once (K6 also writes
one gradient per logit) and does a handful of float32 operations on it, so
the logits' bytes bound them: at T = 4096, V = 30522 in f32, 500 MB take
about 149 us at 3.35 TB/s (K4, K5) and 1 GB about 298 us (K6). The Pallas
kernels carried running statistics in scratch across a sequential vocab
grid axis; Hopper runs blocks in no order, so K4 and K5 sweep a whole row
in one warp (rows of at most 16 KB, such as MoE's V = 1024) or one block
(the vocabularies 30522 and 50257, on a persistent grid), with the running
max and sum in registers: an online logsumexp, one exp per logit.
:func:`_xent_plan` picks the schedule and the grid; the source's note says
how they keep the memory busy and read rows that do not start on 16
bytes. K6 has no carry, so it is a grid over (row, vocab chunk) that fills
the card. A label outside ``[0, V)`` picks no column, as the reference's
iota compare does, and the ragged vocab edge is masked, not padded, so no
padded copy of the logits is made. Labels may be int32 or int64: K4 and
K6 read either as it is.

:func:`xent_forward`, :func:`xent_stats` and :func:`xent_grad` dispatch on
the tensor's device (the plain version for a CPU tensor, the kernel for a
CUDA tensor: nothing falls back) and count kernel launches in their
``launches`` attributes, exactly when several threads launch. The backward
of :func:`xent_forward` runs K5 then K6, as the reference's ``_call_bwd``
does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from distkeras_tpu_torch.ops.launches import count_launch

__all__ = [
    "fused_softmax_xent", "xent_forward", "xent_forward_reference", "xent_grad",
    "xent_grad_reference", "xent_stats", "xent_stats_reference",
]

_GRAD_BLOCK_V = 2048  # K6: the vocab chunk of one program
_GRAD_NUM_WARPS = 4
# K4, K5 (csrc/fused_xent_fwd.cu): rows of at most this many bytes take the
# narrow schedule, one warp a row and 8 rows a block; wider rows the wide
# one, a block a row; the grids' caps in blocks an SM.
_NARROW_ROW_BYTES = 16384
_NARROW_ROWS = 8
_NARROW_BLOCKS_PER_SM = 8
_WIDE_BLOCKS_PER_SM = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


class _XentPlan(NamedTuple):
    """How K4 and K5 sweep ``[T, V]`` logits: the schedule and the grid,
    whose blocks walk the rows until none is left."""

    narrow: bool  # one warp a row, 8 rows a block; else one block a row
    grid: int


def _xent_plan(T: int, V: int, element_size: int, sms: int = 132) -> _XentPlan:
    """K4's and K5's schedule for ``T`` rows of ``V`` logits of
    ``element_size`` bytes on a card of ``sms`` SMs: narrow rows (at most
    16 KB) one warp each, 8 to a block, up to 8 blocks an SM; wider rows one
    block each on a persistent grid of 4 blocks an SM. No block is left
    without a row."""
    narrow = V * element_size <= _NARROW_ROW_BYTES
    cap = sms * (_NARROW_BLOCKS_PER_SM if narrow else _WIDE_BLOCKS_PER_SM)
    return _XentPlan(narrow, max(1, min(-(-T // (_NARROW_ROWS if narrow else 1)), cap)))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _kernel(symbol: str):
    """K4's or K5's C entry point from ``csrc/fused_xent_fwd.cu``: the
    logits', labels' (K4) and outputs' pointers, T, V, the row stride, the
    dtype code, the labels' width (K4), the schedule, the grid, the stream."""
    from distkeras_tpu_torch.utils.build import load_library

    fn = getattr(load_library("fused_xent_fwd"), symbol)
    n_ptrs, n_ints = 3, 3 if symbol == "fused_xent_stats" else 4
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, logits, pointers, label_bytes=()) -> None:
    """Launches ``symbol`` on ``logits`` and ``pointers`` (K4: labels and
    loss, and ``(label_bytes,)``, the labels' width; K5: m and s) on the
    logits' device and PyTorch's current stream there; raises if it
    failed."""
    T, V = logits.shape
    plan = _xent_plan(T, V, logits.element_size(), _sm_count(logits.device.index))
    fn = _kernel(symbol)
    with torch.cuda.device(logits.device):
        err = fn(logits.data_ptr(), *pointers, T, V, logits.stride(0),
                 _DTYPE_CODES[logits.dtype], *label_bytes, int(plan.narrow), plan.grid,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


@functools.cache
def _triton_grad_kernel():
    """K6, compiled by Triton on first use."""
    import triton
    import triton.language as tl

    @triton.jit
    def xent_grad_kernel(logits_ptr, labels_ptr, g_ptr, m_ptr, s_ptr, out_ptr, V,
                         stride_row, stride_out, BLOCK_V: tl.constexpr):
        row = tl.program_id(0)
        idx = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
        inside = idx < V
        x = tl.load(logits_ptr + row.to(tl.int64) * stride_row + idx, mask=inside,
                    other=0.0).to(tl.float32)
        p = tl.exp(x - tl.load(m_ptr + row)) / tl.load(s_ptr + row)
        label = tl.load(labels_ptr + row)  # int32 or int64; -1 for no column
        label = tl.where((label >= 0) & (label < V), label, -1).to(tl.int32)
        onehot = tl.where(idx == label, 1.0, 0.0)
        d = (p - onehot) * tl.load(g_ptr + row)
        tl.store(out_ptr + row.to(tl.int64) * stride_out + idx,
                 d.to(out_ptr.dtype.element_ty), mask=inside)

    return xent_grad_kernel


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
    T = logits.shape[0]
    if labels.dtype not in (torch.int32, torch.int64):
        labels = labels.long()
    labels = labels.contiguous()
    loss = torch.empty(T, dtype=torch.float32, device=logits.device)
    if T:
        _launch("fused_xent_fwd", logits, (labels.data_ptr(), loss.data_ptr()),
                (labels.element_size(),))
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
    for CPU tensors, the CUDA kernel (K4) for CUDA tensors.
    Differentiable in the logits."""
    return _XentForward.apply(logits, labels)


xent_forward.launches = 0


def xent_stats(logits):
    """``(m, s)``, float32 ``[T]`` each, of ``[T, V]`` logits: the plain
    version for CPU tensors, the CUDA kernel (K5) for CUDA tensors."""
    if _on_cpu(logits):
        return xent_stats_reference(logits)
    _check_logits(logits)
    T, V = logits.shape
    m = torch.empty(T, dtype=torch.float32, device=logits.device)
    s = torch.empty(T, dtype=torch.float32, device=logits.device)
    if T:
        _launch("fused_xent_stats", logits, (m.data_ptr(), s.data_ptr()))
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
    if labels.dtype not in (torch.int32, torch.int64):
        labels = labels.long()
    labels = labels.contiguous()
    g, m, s = (x.float().contiguous() for x in (g, m, s))
    out = torch.empty((T, V), dtype=logits.dtype, device=logits.device)
    if T and V:
        with torch.cuda.device(logits.device):
            _triton_grad_kernel()[(T, -(-V // _GRAD_BLOCK_V))](
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
