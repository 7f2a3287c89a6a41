"""Flash attention, forward and backward: CUDA C++ kernels for Hopper and
their plain versions.

Counterpart of ``distkeras_tpu/ops/pallas/flash_attention.py``. Three
kernels replace the three Pallas kernels:

- ``csrc/flash_attention_fwd.cu`` (K1) the ``_fwd_kernel`` launched by
  ``_flash_forward``: ``(O, lse)``;
- ``csrc/flash_attention_bwd.cu`` K2, the ``_dq_kernel`` launched by
  ``dq_call``: ``dQ``;
- the same file's K3, the ``_dkv_kernel`` launched by ``dkv_call``:
  ``dK, dV``.

Their source notes say what bounds them on the H100 and how they are laid
out. :func:`flash_forward_reference`, :func:`flash_dq_reference` and
:func:`flash_dkv_reference` are the same functions in plain PyTorch: the
CPU path, and what the kernels are held against on the card.

:func:`flash_forward`, :func:`dq_call` and :func:`dkv_call` dispatch on
the tensor's device: the plain version for a CPU tensor, the kernel for a
CUDA tensor (or an error: nothing falls back). Each counts its kernel
launches in its ``launches`` attribute, exactly when several threads launch
(:func:`~distkeras_tpu_torch.ops.launches.count_launch`). Differentiating
through :func:`flash_forward` runs ``Δ = rowsum(dO·O)`` in float32 plain torch, as
the reference's ``_flash_backward`` does outside Pallas, then K2 and K3.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distkeras_tpu_torch.ops.launches import count_launch

__all__ = [
    "dkv_call", "dq_call", "flash_attention", "flash_dkv_reference",
    "flash_dq_reference", "flash_forward", "flash_forward_reference",
]

_NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (32, 64)  # the tiny models' 32, the published ones' 64
_TENSOR_MAP_ERROR = 10000  # csrc/hopper_sm90.cuh kTensorMapError


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


def _probs(q, k, lse, causal: bool, causal_shift: int):
    """``P = exp(S·scale − lse)`` in float32, the masked scores filled with
    -1e30 before the exp: a query row that sees no key has lse -1e30, so
    its ``P`` is 1 for every key, as in the reference."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * q.shape[-1] ** -0.5
    if causal:
        rows = torch.arange(q.shape[1], device=q.device)
        cols = torch.arange(k.shape[1], device=q.device)
        keep = rows[:, None] >= cols[None, :] + causal_shift
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return torch.exp(s - lse)


def _dscores(p, do, v, delta, scale: float):
    """``dS = P∘(dO·Vᵀ − Δ)·scale`` in float32."""
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p * (dp - delta) * scale


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool = False,
                       causal_shift: int = 0):
    """Plain version of K2. ``q/do: [BH, S_q, D]``, ``k/v: [BH, S_kv, D]``,
    ``lse/delta: [BH, S_q, 1]`` float32 -> ``dQ [BH, S_q, D]`` in q's dtype.
    ``dS`` is rounded to the input dtype before ``dS·K``, as the kernels do."""
    p = _probs(q, k, lse, causal, causal_shift)
    ds = _dscores(p, do, v, delta, q.shape[-1] ** -0.5)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_dkv_reference(k, v, q, do, lse, delta, causal: bool = False,
                        causal_shift: int = 0):
    """Plain version of K3, the shapes of :func:`flash_dq_reference` ->
    ``(dK, dV)`` in k's and v's dtype. ``P`` and ``dS`` are rounded to the
    input dtype before ``Pᵀ·dO`` and ``dSᵀ·Q``, as the kernel does (the
    reference keeps ``P`` in float32 for ``dV``: exact for float32 inputs,
    one bfloat16 rounding of each weight for bfloat16)."""
    p = _probs(q, k, lse, causal, causal_shift)
    ds = _dscores(p, do, v, delta, q.shape[-1] ** -0.5)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _kernel(library: str, symbol: str, n_ptrs: int, n_ints: int):
    """A kernel's C entry point from ``csrc/<library>.cu``: ``n_ptrs``
    pointers, ``n_ints`` ints, then the float scale and the stream."""
    from distkeras_tpu_torch.utils.build import load_library

    fn = getattr(load_library(library), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(x) -> bool:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type == "cpu"
    raise ValueError(f"flash attention runs on cpu or cuda, not {x.device}")


def _check_kernel_inputs(stats=(), **tensors) -> None:
    """What the kernels take: contiguous, 16-byte aligned bfloat16
    ``[BH, S, D]`` tensors on one device, D in :data:`_KERNEL_HEAD_DIMS`,
    and float32 ``[BH, S_q, 1]`` statistics."""
    first = next(iter(tensors.values()))
    BH, D, dev = first.shape[0], first.shape[-1], first.device
    for name, x in tensors.items():
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernels take bfloat16 tensors, got {name} {x.dtype}")
        if x.ndim != 3 or x.shape[0] != BH or x.shape[2] != D:
            raise ValueError(f"{name} must be [{BH}, S, {D}], got {tuple(x.shape)}")
        if x.device != dev or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {dev}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dim {_KERNEL_HEAD_DIMS}, got {D}")
    for x in stats:
        if x.dtype != torch.float32 or x.device != dev or not x.is_contiguous():
            raise ValueError(f"lse/delta must be contiguous float32 tensors on {dev}")


def _launch(fn, what: str, device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what}: TMA tensor map not encoded (CUresult "
                           f"{err - _TENSOR_MAP_ERROR}, or no driver entry point if 0)")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _flash_forward_cuda(q, k, v, causal: bool, causal_shift: int):
    _check_kernel_inputs(q=q, k=k, v=v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    BH, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, S, 1), dtype=torch.float32, device=q.device)
    _launch(_kernel("flash_attention_fwd", "flash_attention_fwd_bf16", 5, 5),
            "flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), BH, S, D, int(causal), int(causal_shift),
            float(D**-0.5))
    count_launch(flash_forward)
    return out, lse


def _check_backward_shapes(q, k, v, do, lse, delta) -> None:
    BH, Sq, D = q.shape
    if k.shape != v.shape or do.shape != q.shape or k.shape[2] != D:
        raise ValueError(f"q/k/v/do shapes do not fit: {q.shape} {k.shape} {v.shape} {do.shape}")
    if lse.shape != (BH, Sq, 1) or delta.shape != (BH, Sq, 1):
        raise ValueError(f"lse/delta must be [{BH}, {Sq}, 1], got {lse.shape} {delta.shape}")


def _check_shift(causal_shift: int) -> None:
    if causal_shift not in (0, 1):
        raise ValueError(f"causal_shift must be 0 or 1, got {causal_shift}")


def dq_call(q, k, v, do, lse, delta, causal: bool, causal_shift: int = 0):
    """``dQ [BH, S_q, D]`` from ``q/do [BH, S_q, D]``, ``k/v [BH, S_kv, D]``
    (``S_q`` may differ from ``S_kv``) and the float32 ``lse`` and
    ``delta = rowsum(dO·O)`` ``[BH, S_q, 1]``: the plain version for CPU
    tensors, the CUDA kernel (K2) for CUDA tensors."""
    _check_shift(causal_shift)
    _check_backward_shapes(q, k, v, do, lse, delta)
    if _on_cpu(q):
        return flash_dq_reference(q, k, v, do, lse, delta, causal, causal_shift)
    _check_kernel_inputs(stats=(lse, delta), q=q, k=k, v=v, do=do)
    BH, Sq, D = q.shape
    if not (Sq and k.shape[1]):
        return torch.zeros_like(q)  # no key, or no query: nothing to launch
    dq = torch.empty_like(q)  # the kernel writes every element
    _launch(_kernel("flash_attention_bwd", "flash_attention_dq_bf16", 7, 6),
            "flash_attention_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, Sq,
            k.shape[1], D, int(causal), int(causal_shift), float(D**-0.5))
    count_launch(dq_call)
    return dq


dq_call.launches = 0


def dkv_call(k, v, q, do, lse, delta, causal: bool, causal_shift: int = 0):
    """``(dK, dV)``, each ``[BH, S_kv, D]``, from the inputs of
    :func:`dq_call` in the reference's argument order: the plain version for
    CPU tensors, the CUDA kernel (K3) for CUDA tensors."""
    _check_shift(causal_shift)
    _check_backward_shapes(q, k, v, do, lse, delta)
    if _on_cpu(k):
        return flash_dkv_reference(k, v, q, do, lse, delta, causal, causal_shift)
    _check_kernel_inputs(stats=(lse, delta), k=k, v=v, q=q, do=do)
    BH, Skv, D = k.shape
    if not (Skv and q.shape[1]):
        return torch.zeros_like(k), torch.zeros_like(v)  # nothing to launch
    dk, dv = torch.empty_like(k), torch.empty_like(v)  # the kernel writes every element
    _launch(_kernel("flash_attention_bwd", "flash_attention_dkv_bf16", 8, 6),
            "flash_attention_dkv", k.device, k.data_ptr(), v.data_ptr(), q.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), BH, q.shape[1], Skv, D, int(causal), int(causal_shift),
            float(D**-0.5))
    count_launch(dkv_call)
    return dk, dv


dkv_call.launches = 0


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, causal_shift):
        if _on_cpu(q):
            out, lse = flash_forward_reference(q, k, v, causal, causal_shift)
        else:
            out, lse = _flash_forward_cuda(q, k, v, causal, causal_shift)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.causal_shift = causal, causal_shift
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        # lse is a statistic of the softmax: its cotangent is dropped, as the
        # reference's _flash_with_lse_bwd drops it.
        q, k, v, out, lse = ctx.saved_tensors
        do = g_out.contiguous()
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        dq = dq_call(q, k, v, do, lse, delta, ctx.causal, ctx.causal_shift)
        dk, dv = dkv_call(k, v, q, do, lse, delta, ctx.causal, ctx.causal_shift)
        return dq, dk, dv, None, None


def flash_forward(q, k, v, causal: bool = False, causal_shift: int = 0):
    """``q/k/v: [BH, S, D]`` -> ``(out [BH, S, D], lse [BH, S, 1] f32)``:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors.
    ``causal_shift`` 0 keeps the diagonal (inclusive causal), 1 drops it.
    Differentiable in q, k and v; lse is not."""
    _check_shift(causal_shift)
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
        # At B = 1 the reshape is a strided view; the kernels take contiguous rows.
        return x.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()

    out, lse = flash_forward(fold(q), fold(k), fold(v), causal)
    out = out.reshape(B, H, S, D).permute(0, 2, 1, 3)
    if return_lse:
        return out, lse[..., 0].reshape(B, H, S).permute(0, 2, 1).detach()
    return out
