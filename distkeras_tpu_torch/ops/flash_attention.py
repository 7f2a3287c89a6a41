"""Flash attention forward: a CUDA C++ kernel for Hopper and its plain version.

Counterpart of ``distkeras_tpu/ops/pallas/flash_attention.py``. The kernel
(``csrc/flash_attention_fwd.cu``) replaces the Pallas ``_fwd_kernel``
launched by ``_flash_forward``; its source note says what bounds it on the
H100 and how it is laid out. :func:`flash_forward_reference` is the same
function in plain PyTorch: the CPU path, and what the kernel is held against
on the card.

:func:`flash_forward` dispatches on the tensor's device: the plain version
for a CPU tensor, the kernel for a CUDA tensor (or an error: nothing falls
back). Its ``launches`` attribute counts kernel launches. The backward
kernels (``_dq_kernel``, ``_dkv_kernel``) belong to the training slice, so
differentiating through this op raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["flash_attention", "flash_forward", "flash_forward_reference"]

_NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (32, 64)  # the tiny models' 32, the published ones' 64


def flash_forward_reference(q, k, v, causal: bool = False, causal_shift: int = 0):
    """Plain version. ``q/k/v: [BH, S, D]`` -> ``(out [BH, S, D], lse [BH, S, 1])``.

    Scores in float32 (exact products of the input dtype), masked entries
    filled with -1e30, ``P`` rounded to the input dtype before ``P·V`` as
    the kernels do, the denominator summed from the unrounded ``P``."""
    S, D = q.shape[1], q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * D**-0.5
    if causal:
        pos = torch.arange(S, device=q.device)
        keep = pos[:, None] >= pos[None, :] + causal_shift
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), m + torch.log(l)


@functools.cache
def _kernel():
    from distkeras_tpu_torch.utils.build import load_library

    fn = load_library("flash_attention_fwd").flash_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _flash_forward_cuda(q, k, v, causal: bool, causal_shift: int):
    BH, S, D = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the flash kernel takes bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dim {_KERNEL_HEAD_DIMS}, got {D}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if BH > 65535:
        raise ValueError(f"batch*heads {BH} exceeds the kernel grid's 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {q.device}")
    out = torch.empty_like(q)
    lse = torch.empty((BH, S, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), BH, S, D, int(causal), int(causal_shift),
                        float(D**-0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_forward.launches += 1
    return out, lse


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, causal_shift):
        if q.device.type == "cpu":
            return flash_forward_reference(q, k, v, causal, causal_shift)
        if q.device.type == "cuda":
            return _flash_forward_cuda(q, k, v, causal, causal_shift)
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention backward (dQ, dK/dV kernels) comes with the training slice")


def flash_forward(q, k, v, causal: bool = False, causal_shift: int = 0):
    """``q/k/v: [BH, S, D]`` -> ``(out [BH, S, D], lse [BH, S, 1] f32)``:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors.
    ``causal_shift`` 0 keeps the diagonal (inclusive causal), 1 drops it."""
    if causal_shift not in (0, 1):
        raise ValueError(f"causal_shift must be 0 or 1, got {causal_shift}")
    return _FlashForward.apply(q, k, v, bool(causal), int(causal_shift))


flash_forward.launches = 0


def flash_attention(
    q,
    k,
    v,
    causal: bool = False,
    block_q: int = 128,
    block_k: int = 128,
    return_lse: bool = False,
):
    """Flash attention over ``[B, S, H, D]`` inputs, the convention of
    :func:`distkeras_tpu_torch.ops.attention.dot_product_attention`.

    ``block_q``/``block_k`` keep the reference's contract (``S`` must be a
    multiple of each, after clipping them to ``S``); the CUDA kernel tiles by
    64 itself and handles any ``S``. ``return_lse=True`` also returns the
    per-row logsumexp ``[B, S, H]`` as a detached statistic."""
    B, S, H, D = q.shape
    block_q = min(block_q, S)
    block_k = min(block_k, S)
    if S % block_q or S % block_k:
        raise ValueError(
            f"seq_len {S} must divide block sizes ({block_q},{block_k})"
        )

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, S, D)

    out, lse = flash_forward(fold(q), fold(k), fold(v), causal)
    out = out.reshape(B, H, S, D).permute(0, 2, 1, 3)
    if return_lse:
        return out, lse[..., 0].reshape(B, H, S).permute(0, 2, 1).detach()
    return out
