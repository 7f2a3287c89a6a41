"""Ring flash attention: counterpart of ``distkeras_tpu/ops/ring_flash.py``.

Each rank of a mesh's sequence axis holds ``S/p`` of Q, K and V. Per hop it
runs the flash forward (K1, :func:`~distkeras_tpu_torch.ops.flash_attention.fwd_call`)
against the visiting K/V shard, getting that shard's partial output and
per-row logsumexp; the partials merge exactly, in float32,

    lse = logaddexp(lse, lse_i)
    o   = o * exp(lse_old - lse) + o_i * exp(lse_i - lse)

then K and V move one hop along the ring
(:func:`~distkeras_tpu_torch.parallel.distributed.sp_permute_start`, started
before the hop's kernel so the transfer runs beside it). Hop 0 is always
the rank's own shard, which every query row sees, so the merge never meets
two ``-inf``. The forward's last rotation would bring every rank its own
shard back, which nothing reads: it is not made (the reference's ``scan``
makes it), which saves one transfer a layer and changes no number.

The hop's mask (:func:`hop_mode`, computed on the host: the rank and the
step are plain ints here): contiguous layout, the rank's own shard causal,
an earlier shard full, a later shard skipped (no launch); striped layout
(:func:`stripe_shard`, Striped Attention), ``src <= my`` causal and
``src > my`` strict causal (K1 with ``causal_shift=1``): no hop is skipped.

Backward (a ``torch.autograd.Function``, the reference's custom VJP): the
merged result is dense attention over the whole sequence, so its gradient
is the flash backward evaluated with the **global** lse and
``Δ = rowsum(dO∘O)``. The ring runs again: per hop K2 (``dq_call``) adds
into the local dQ and K3 (``dkv_call``) into dK and dV buffers that
**rotate with their shards** and arrive home after ``p`` hops; all three
accumulate in float32 and are cast to the inputs' dtype at the end.

The reference's ``block_q`` search fits TPU tiles to the shard; K1-K3 tile
by 64 themselves and take any length, so ``block_q`` is accepted and
unused.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.ops.flash_attention import dkv_call, dq_call, fwd_call
from distkeras_tpu_torch.parallel.distributed import (
    AxisRing,
    axis_ring,
    sp_permute,
    sp_permute_start,
)

__all__ = ["hop_mode", "ring_flash_attention", "stripe_shard", "stripe_unshard"]

SKIP, CAUSAL, FULL, STRICT = 0, 1, 2, 3
# mode -> (causal, causal_shift) of the hop's kernels
_HOP_MASK = {CAUSAL: (True, 0), FULL: (False, 0), STRICT: (True, 1)}


def _stripe_permute(x, p: int, axis: int, to_striped: bool):
    """Both stripe directions are the same blocked transpose, as a reshape
    and a swap of two axes (a torch tensor or a numpy array)."""
    axis %= x.ndim
    S = x.shape[axis]
    if S % p:
        raise ValueError(f"sequence {S} not divisible by {p} stripes")
    shape = tuple(x.shape)
    inner = (S // p, p) if to_striped else (p, S // p)
    x = x.reshape(*shape[:axis], *inner, *shape[axis + 1:])
    return x.swapaxes(axis, axis + 1).reshape(shape)


def stripe_shard(x, p: int, axis: int = 1):
    """Natural token order -> striped layout: after the usual contiguous
    split into ``p`` shards, shard ``m`` holds tokens ``m, m+p, m+2p, ...``
    (position ``(m, j)`` is global token ``j*p + m``). Apply to the token
    ids and labels before the split; invert with :func:`stripe_unshard`."""
    return _stripe_permute(x, p, axis, to_striped=True)


def stripe_unshard(x, p: int, axis: int = 1):
    """Inverse of :func:`stripe_shard`."""
    return _stripe_permute(x, p, axis, to_striped=False)


def _fold(x):  # [B, S, H, D] -> [BH, S, D], contiguous for the kernels
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()


def _unfold(x, B: int, H: int):  # [BH, S, D] -> [B, S, H, D]
    _, S, D = x.shape
    return x.reshape(B, H, S, D).permute(0, 2, 1, 3)


def hop_mode(src: int, my: int, causal: bool, stripe: bool = False) -> int:
    """The mask of the hop on which rank ``my`` sees the K/V shard of rank
    ``src``: :data:`SKIP`, :data:`CAUSAL` (diagonal included), :data:`FULL`
    or :data:`STRICT` (diagonal excluded)."""
    if not causal:
        return FULL
    if stripe:
        return CAUSAL if src <= my else STRICT
    return CAUSAL if src == my else FULL if src < my else SKIP


class _Ring(torch.autograd.Function):
    """The ring over folded ``[BH, S/p, D]`` shards (see the module's
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, ring: AxisRing, causal: bool, stripe: bool):
        p, my = ring.size, ring.index
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:2] + (1,), float("-inf"), dtype=torch.float32,
                         device=q.device)
        k_cur, v_cur = k, v
        for step in range(p):
            nxt = sp_permute_start([k_cur, v_cur], ring) if step < p - 1 else None
            mode = hop_mode((my - step) % p, my, causal, stripe)
            if mode != SKIP:
                o_i, lse_i = fwd_call(q, k_cur, v_cur, *_HOP_MASK[mode])
                new_lse = torch.logaddexp(lse, lse_i)
                o = o * torch.exp(lse - new_lse) + o_i.float() * torch.exp(lse_i - new_lse)
                lse = new_lse
            if nxt is not None:
                k_cur, v_cur = nxt.wait()
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.stripe = ring, causal, stripe
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        p, my = ring.size, ring.index
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for step in range(p):
            mode = hop_mode((my - step) % p, my, ctx.causal, ctx.stripe)
            if mode != SKIP:
                causal, shift = _HOP_MASK[mode]
                dq += dq_call(q, k_cur, v_cur, do, lse, delta, causal, shift).float()
                dk_i, dv_i = dkv_call(k_cur, v_cur, q, do, lse, delta, causal, shift)
                dk += dk_i.float()
                dv += dv_i.float()
            # the gradients rotate with their shards: home after p hops
            moving = [dk, dv] + ([k_cur, v_cur] if step < p - 1 else [])
            dk, dv, *kv = sp_permute(moving, ring)
            if kv:
                k_cur, v_cur = kv
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_flash_attention(q, k, v, mesh, seq_axis: str = "sp", causal: bool = False,
                         block_q: int = 128, stripe: bool = False):
    """Ring flash attention over this rank's ``[B, S/p, H, D]`` shards of a
    sequence split over ``mesh``'s ``seq_axis`` (``p`` its size): exact (it
    equals dense attention over the whole sequence) and differentiable in
    q, k and v. Returns this rank's ``[B, S/p, H, D]`` rows.

    ``stripe=True`` (causal only): the shards are in the striped token
    layout (:func:`stripe_shard`), which gives every hop near-equal work on
    every rank; the output stays striped. ``block_q`` is the reference's
    TPU tile and unused (see the module's docstring). An axis above 1 needs
    a process group over the mesh's ranks."""
    if stripe and not causal:
        raise ValueError("stripe=True only changes causal masking; "
                         "non-causal rings are already balanced")
    ring = axis_ring(mesh, seq_axis)
    B, _, H, _ = q.shape
    out = _Ring.apply(_fold(q), _fold(k), _fold(v), ring, bool(causal), bool(stripe))
    return _unfold(out, B, H)
