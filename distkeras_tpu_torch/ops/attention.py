"""Dense and paged attention: counterpart of ``distkeras_tpu/ops/attention.py``
``dot_product_attention`` (the path attention takes when flash is off or a
mask is given) and the paged serving engine's ``paged_kv_update`` and
``paged_attention``. Neither paged op is a Pallas kernel in the reference
(they are plain gathers and scatters), so they are plain torch ops here.
:func:`constrain_heads` is the reference's head-layout pin for tensor
parallel decode. :func:`ring_attention` is the reference's dense ring for
sequence parallelism: plain torch (the reference has no Pallas body
there), its K/V moving one hop per step with an autograd-aware permute
whose backward moves the cotangents the other way; the flash ring is
:mod:`~distkeras_tpu_torch.ops.ring_flash`."""

from __future__ import annotations

import torch

from distkeras_tpu_torch.parallel.distributed import AxisRing, axis_ring, sp_permute_grad

__all__ = ["PagedPlan", "constrain_heads", "dot_product_attention", "paged_attention",
           "paged_kv_update", "ring_attention", "ring_self_attention", "sp_batch_spec"]


def constrain_heads(x, mesh, num_heads: int, axis: str = "tp", dim: int = -2):
    """Reference ``constrain_heads``: there it pins ``x``'s heads dimension
    to the mesh's tp axis. Here every rank holds its own heads explicitly,
    so there is nothing to pin; this checks that ``x`` holds this rank's
    share of the model's ``num_heads`` heads at ``dim`` and raises
    ``ValueError`` otherwise. ``x`` passes unchanged without a mesh, without
    the axis, at one rank or when the heads do not divide over the axis
    (reference ``:52-56``)."""
    if mesh is None or axis not in mesh.axis_names:
        return x
    n = mesh.shape[axis]
    if n <= 1 or num_heads % n:
        return x
    if x.shape[dim] != num_heads // n:
        raise ValueError(f"a K/V leaf of shape {tuple(x.shape)} holds {x.shape[dim]} heads at "
                         f"dimension {dim}; this rank's share of {num_heads} over {axis}={n} "
                         f"is {num_heads // n}")
    return x


def sp_batch_spec(mesh, seq_axis: str, batch_size: int) -> tuple:
    """The ``[B, S, H, D]`` partition spec every sequence-parallel wrapper
    shares (reference ``sp_batch_spec``): the sequence over ``seq_axis``,
    the batch over ``dp`` when the batch divides it. A rank's part of a
    whole tensor is ``NamedSharding(mesh, spec).index(shape, rank)``."""
    batch_axis = ("dp" if "dp" in mesh.axis_names and batch_size % mesh.shape["dp"] == 0
                  else None)
    return (batch_axis, seq_axis, None, None)


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


class PagedPlan:
    """The index work of one paged apply, done once and shared by every
    layer's K and V (it depends only on the block tables, the positions,
    the window width and the pool geometry).

    Write side: ``targets`` (int64 ``[B * S]``), each new vector's flat
    element ``row * page_tokens + offset`` of the pool viewed as
    ``[C * page_tokens, H, D]``; ``valid`` (bool ``[B * S]``), whether the
    write lands; ``first`` (int64 ``[1]``), the first valid write, or 0.
    A write past a row's table or through an unallocated id is DROPPED,
    never clamped into a real block (the reference's ``mode="drop"``).
    ``index_put_`` has no drop mode, and selecting the valid writes would
    read their count back to the host; instead every dropped write is
    routed to the target of the first valid write, carrying that write's
    own value, so the duplicate stores are byte-identical and the result
    does not depend on which one lands; with no valid write at all they go
    to element 0 carrying its current value. Every index is a tensor of
    at least one dimension: indexing with a 0-d tensor would read it back
    to the host.

    Read side: ``gather`` (int64 ``[B, T]``), the tables with unallocated
    ids clamped to a real block, as the reference's gather clamps (the
    mask hides what it reads), and ``mask`` (bool ``[B, 1, S, T * bt]``),
    ``k_pos <= q_pos``: query ``j`` of a window attends to positions
    ``<= positions[b] + j``."""

    def __init__(self, tables, positions, S: int, capacity: int, page_tokens: int):
        C, bt = capacity, page_tokens
        T = tables.shape[1]
        dev = tables.device
        tables = tables.long()
        q_pos = positions.long()[:, None] + torch.arange(S, device=dev)[None, :]  # [B, S]
        blk = q_pos // bt
        rows = tables.gather(1, blk.clamp(max=T - 1))
        valid = ((blk < T) & (rows < C)).reshape(-1)
        targets = (rows * bt + q_pos % bt).reshape(-1)
        self.first = torch.argmax(valid.to(torch.int32)).reshape(1)
        self.some = valid.any().reshape(1)
        park = torch.where(self.some, targets.index_select(0, self.first),
                           torch.zeros_like(self.first))
        self.park = park.clamp(0, C * bt - 1)
        self.valid = valid
        self.targets = torch.where(valid, targets, self.park)
        self.gather = tables.clamp(max=C - 1)
        k_pos = torch.arange(T * bt, device=dev)
        self.mask = k_pos[None, None, None, :] <= q_pos[:, None, :, None]

    def write(self, pool, new):
        """Write ``new`` (``[B, S, H, D]``) into ``pool`` in place; returns
        the pool."""
        C, bt = pool.shape[0], pool.shape[1]
        tail = tuple(pool.shape[2:])
        dest = pool.view((C * bt,) + tail)
        vals = new.to(pool.dtype).reshape((-1,) + tail)
        park_val = torch.where(self.some.view((1,) * (len(tail) + 1)),
                               vals.index_select(0, self.first),
                               dest.index_select(0, self.park))
        vals = torch.where(self.valid.view((-1,) + (1,) * len(tail)), vals, park_val)
        dest.index_put_((self.targets,), vals)
        return pool

    def attend(self, q, pool_k, pool_v):
        """Attention of ``q`` (``[B, S, H, D]``) over each row's gathered
        blocks, in table order (position order)."""
        B = q.shape[0]
        L = self.gather.shape[1] * pool_k.shape[1]
        k = pool_k[self.gather].reshape((B, L) + tuple(pool_k.shape[2:]))
        v = pool_v[self.gather].reshape((B, L) + tuple(pool_v.shape[2:]))
        return dot_product_attention(q, k, v, mask=self.mask)


def paged_kv_update(pool, new, tables, positions, page_tokens: int):
    """Write per-row K (or V) vectors into a paged block pool, in place,
    and return the pool (reference ``paged_kv_update``; see
    :class:`PagedPlan` for the dropped writes).

    ``pool``: ``[C, page_tokens, H, D]``, row ``c`` one block. ``new``:
    ``[B, S, H, D]``, each batch row's ``S`` new vectors. ``tables``: int32
    ``[B, T]``, row ``b``'s block table (entry ``t`` holds its positions
    ``[t * page_tokens, (t + 1) * page_tokens)``; an id ``>= C`` is
    unallocated). ``positions``: int32 ``[B]``, where row ``b``'s first new
    vector goes."""
    plan = PagedPlan(tables, positions, new.shape[1], pool.shape[0], page_tokens)
    return plan.write(pool, new)


def paged_attention(q, pool_k, pool_v, tables, positions):
    """Attention over paged K/V (reference ``paged_attention``).

    ``q``: ``[B, S, H, D]`` queries whose first token sits at position
    ``positions[b]``. ``pool_k``/``pool_v``: ``[C, bt, H, D]`` block pools.
    ``tables``: int32 ``[B, T]`` block tables. Each row's K/V is gathered
    in table order and masked with the dense decode path's
    ``k_pos <= q_pos`` rule (:class:`PagedPlan`)."""
    plan = PagedPlan(tables, positions, q.shape[1], pool_k.shape[0], pool_k.shape[1])
    return plan.attend(q, pool_k, pool_v)


def _block_attn_update(q, k_blk, v_blk, acc, m, denom, scale: float, mask=None):
    """One online-softmax step against a K/V block (reference
    ``_block_attn_update``). ``acc``: the running numerator ``[B, S, H, D]``
    (float32); ``m``: the running max ``[B, H, S, 1]``; ``denom``: the running
    sum of exps ``[B, H, S, 1]``; ``mask`` broadcasts to ``[B, H, S_q, S_k]``,
    True where a query attends."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    new_m = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    correction = torch.exp(m - new_m)
    p = torch.exp(scores - new_m)
    new_denom = denom * correction + p.sum(dim=-1, keepdim=True)
    p_v = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk).float()
    return acc * correction.transpose(1, 2) + p_v, new_m, new_denom


def ring_attention(q, k, v, ring: AxisRing, causal: bool = False, stripe: bool = False):
    """Dense ring attention on this rank's ``[B, S/p, H, D]`` shards of the
    axis ``ring`` (:func:`~distkeras_tpu_torch.parallel.distributed.axis_ring`;
    the reference's ``axis_name``): each of the ``p`` steps adds the
    visiting K/V shard's block with an online softmax, then K and V move one
    hop. ``stripe=True`` (causal only) takes the striped token layout
    (:func:`~distkeras_tpu_torch.ops.ring_flash.stripe_shard`)."""
    if stripe and not causal:
        raise ValueError("stripe=True only changes causal masking; "
                         "non-causal rings are already balanced")
    p, my = ring.size, ring.index
    B, S, H, _ = q.shape
    scale = q.shape[-1] ** -0.5
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S, 1), float("-inf"), dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, H, S, 1), dtype=torch.float32, device=q.device)
    pos = torch.arange(S, device=q.device)
    k_cur, v_cur = k, v
    for step in range(p):
        mask = None
        if causal:
            src = (my - step) % p  # the rank whose shard visits at this step
            if stripe:  # local index j of rank m is global token j*p + m
                rows, cols = pos[:, None] * p + my, pos[None, :] * p + src
            else:
                rows, cols = my * S + pos[:, None], src * S + pos[None, :]
            mask = (rows >= cols)[None, None]
        acc, m, denom = _block_attn_update(q, k_cur, v_cur, acc, m, denom, scale, mask)
        if step < p - 1:
            k_cur, v_cur = sp_permute_grad([k_cur, v_cur], ring)
    return (acc / denom.transpose(1, 2).clamp_min(1e-30)).to(q.dtype)


def ring_self_attention(q, k, v, mesh, seq_axis: str = "sp", causal: bool = False,
                        stripe: bool = False):
    """:func:`ring_attention` over ``mesh``'s ``seq_axis`` on this rank's
    ``[B, S/p, H, D]`` shards (the reference's wrapper, whose ``shard_map``
    split is here the caller's)."""
    if stripe and not causal:
        raise ValueError("stripe=True only changes causal masking")
    return ring_attention(q, k, v, axis_ring(mesh, seq_axis), causal, stripe)
