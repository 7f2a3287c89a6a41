"""Ulysses sequence parallelism: counterpart of ``distkeras_tpu/ops/ulysses.py``.

Activations arrive sequence-split, ``[B, S/p, H, D]`` on each rank of a
mesh's sequence axis. One all-to-all per tensor
(:func:`~distkeras_tpu_torch.parallel.distributed.sp_all_to_all_grad`)
re-splits the heads instead of the sequence, ``[B, S, H/p, D]``: every
rank then holds the whole sequence for ``1/p`` of the heads, attention
runs locally (dense, or the flash kernels K1-K3 with
``attn_fn=flash_attention``), and a second all-to-all restores the
sequence split of the output. The all-to-all is its own adjoint, so the
backward is the same exchange of the cotangents. Needs
``num_heads % p == 0``; the ring (:mod:`~distkeras_tpu_torch.ops.ring_flash`)
has no such constraint.
"""

from __future__ import annotations

from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.parallel.distributed import AxisRing, axis_ring, sp_all_to_all_grad

__all__ = ["ulysses_attention", "ulysses_self_attention"]


def _to_heads(x, ring: AxisRing):
    """``[B, S/p, H, D]`` -> ``[B, S, H/p, D]``: chunk ``j`` of the heads
    goes to rank ``j``, which concatenates the ranks' tokens in order."""
    p = ring.size
    B, s, H, D = x.shape
    x = x.reshape(B, s, p, H // p, D).permute(2, 0, 1, 3, 4)
    x = sp_all_to_all_grad(x, ring)  # [p, B, s, H/p, D]: rank j's tokens, my heads
    return x.permute(1, 0, 2, 3, 4).reshape(B, p * s, H // p, D)


def _to_sequence(x, ring: AxisRing):
    """``[B, S, H/p, D]`` -> ``[B, S/p, H, D]``, the inverse of :func:`_to_heads`."""
    p = ring.size
    B, S, h, D = x.shape
    x = x.reshape(B, p, S // p, h, D).permute(1, 0, 2, 3, 4)
    x = sp_all_to_all_grad(x, ring)  # [p, B, S/p, h, D]: my tokens, rank j's heads
    return x.permute(1, 2, 0, 3, 4).reshape(B, S // p, p * h, D)


def ulysses_attention(q, k, v, ring: AxisRing, causal: bool = False, attn_fn=None):
    """All-to-all sequence-parallel attention on this rank's sequence shards
    ``[B, S/p, H, D]`` of the axis ``ring`` (:func:`axis_ring`; the
    reference's ``axis_name``), ``H`` divisible by ``p``. Returns
    ``[B, S/p, H, D]``.

    ``attn_fn(q, k, v, causal=...)`` computes whole-sequence attention on
    the local head group ``[B, S, H/p, D]``; default
    :func:`~distkeras_tpu_torch.ops.attention.dot_product_attention`."""
    H = q.shape[2]
    if H % ring.size:
        raise ValueError(
            f"ulysses_attention needs num_heads % axis_size == 0; got {H} heads over "
            f"{ring.size} devices — use ring attention for head counts that don't divide")
    if ring.size == 1:
        return (attn_fn or dot_product_attention)(q, k, v, causal=causal)
    out = (attn_fn or dot_product_attention)(_to_heads(q, ring), _to_heads(k, ring),
                                             _to_heads(v, ring), causal=causal)
    return _to_sequence(out, ring)


def ulysses_self_attention(q, k, v, mesh, seq_axis: str = "sp", causal: bool = False,
                           attn_fn=None):
    """:func:`ulysses_attention` over ``mesh``'s ``seq_axis``, on this rank's
    ``[B, S/p, H, D]`` shards: the reference's wrapper, whose ``shard_map``
    split is here the caller's (every rank holds its own tokens). An axis
    above 1 needs a process group over the mesh's ranks."""
    H, p = q.shape[2], mesh.shape[seq_axis]
    if H % p:
        raise ValueError(f"ulysses_attention needs num_heads % {seq_axis} == 0; got {H} heads "
                         f"over {p} devices — use ring attention for head counts that "
                         f"don't divide")
    return ulysses_attention(q, k, v, axis_ring(mesh, seq_axis), causal, attn_fn)
