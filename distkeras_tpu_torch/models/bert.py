"""BERT encoder family (masked LM) and the GPT-style causal LMs.

Counterpart of ``distkeras_tpu/models/bert.py``, the non-decode path: the
same config fields, module names and parameter layout (so the reference's
weights carry across through :mod:`distkeras_tpu_torch.utils.bridge`), and
the same numerics:

- weights are float32; each ``Dense`` casts its input and weights to
  ``cfg.dtype`` (bfloat16 by default) for the matmul, as flax's
  ``nn.Dense(dtype=...)`` does;
- LayerNorm runs in float32 with epsilon 1e-6 (flax's default, not torch's
  1e-5) and returns float32;
- GELU is the tanh approximation (flax ``nn.gelu``'s default);
- the residual stream stays in ``cfg.dtype``;
- the tied head multiplies in ``cfg.dtype`` (flax ``Embed.attend`` promotes
  both sides) and adds the float32 ``mlm_bias``, so logits are float32.

Dropout keeps flax's semantics (keep with probability ``1 - rate``, scale
by ``1 / (1 - rate)``, in the input's dtype) and draws its masks from
``torch.Generator``s seeded inside the forward from the ``rng`` seed the
caller passes, one derived seed per dropout site, so a recompute under
``torch.utils.checkpoint`` draws the same masks.

Attention takes the flash kernel (:mod:`distkeras_tpu_torch.ops.flash_attention`)
when ``use_flash_attention`` is set and no mask is given, else dense
attention. Tensor parallelism (``tp_mesh``) splits the heads, the MLP and
the vocabulary over a mesh's tp axis (Megatron's layout, explicit
autograd-aware collectives).

MoE (``moe_experts > 0``, ``moe_top_k``; reference ``bert.py:419-444``):
each layer's MLP is a routed expert mixture (:class:`~distkeras_tpu_torch.ops.moe.MoEMLP`,
``layer_{i}.moe_mlp.{router,w_in,w_out}``) on the float32 LayerNorm output,
with the residual kept in the compute dtype. A training apply returns the
layers' summed load-balancing loss as ``{"aux_loss": scalar}``, the
``new_state`` the step folds into the objective (nothing else returns it).
Expert parallelism (``ep_mesh``, a port field as ``tp_mesh`` is): each rank
of the mesh's ep axis computes on its ``E/ep`` experts; with ``tp_mesh`` each
rank holds ``M/tp`` of every expert's hidden columns (``w_in`` ``[E/ep, D,
M/tp]``, ``w_out`` ``[E/ep, M/tp, D]``, the reference's ``("expert", "ep")``
and ``("mlp", "tp")`` rules), and the ranks' shares are summed inside the
layer in one all-reduce over ep, tp or the joint ``(ep, tp)`` group of the
one mesh (:func:`_moe_shards`). Under a data-parallel step
(:func:`~distkeras_tpu_torch.models.core.cross_replica_batch_stats`) and
under ``ring_mesh`` or ``seq_mesh`` (a rank's columns of the rows) the
routing takes the whole batch's seats and statistics in the reference's
row-major order over the global ``[B, S]`` (the striped one under
``"ring_stripe"``), as its XLA routes the global batch
(:mod:`~distkeras_tpu_torch.ops.moe`). Decode mode splits no sequence, so
its routing has no sp part.

Sequence parallelism (``ring_mesh``, ``ring_axis``, ``sp_impl``; reference
``bert.py:235-280``): every attention layer runs across the ranks of
``ring_mesh``'s ``ring_axis`` (size ``p``) through the flash ring
(``"ring"``; ``"ring_stripe"``, causal only, in the striped token layout:
:mod:`~distkeras_tpu_torch.ops.ring_flash`) or Ulysses' all-to-all
(``"ulysses"``, flash on the local head group with ``use_flash_attention``:
:mod:`~distkeras_tpu_torch.ops.ulysses`). A rank holds its own tokens: the
forward takes its ``[B, S/p]`` shard of the ids and returns its
``[B, S/p, V]`` logits (rank ``m`` holds columns ``m·S/p … (m+1)·S/p − 1``,
or under ``"ring_stripe"`` columns ``m, m+p, m+2p, …``; ``stripe_shard``
then the contiguous split). Its positional rows, ``m·S/p + j`` or
``j·p + m``, come from the whole ``pos_embed``. So the reference's
stripe/unstripe bracket around the trunk (``bert.py:556-580``) has nothing
to do here: the tokens arrive striped and the logits leave striped. An
axis above 1 needs a process group over the mesh's ranks
(``RuntimeError`` otherwise). Decode mode ignores ``ring_mesh``, as the
reference's ``generate`` drops it. With ``tp_mesh`` as well, attention runs
across the sp ranks on this rank's ``H/tp`` heads (Ulysses then needs
``H/tp`` to divide by ``p``).

The XLA sequence split (``seq_mesh``, a port field as ``tp_mesh`` is; the
reference's ``shard_sequence=True`` on a model without ``ring_mesh``, where
GSPMD splits the tokens over ``sp`` and gathers what attention needs): a
rank holds its contiguous ``[B, S/p]`` columns, as under ``ring_mesh``, and
every attention layer gathers the columns it needs over the mesh's ``sp``
axis (:func:`~distkeras_tpu_torch.parallel.distributed.sp_all_gather_grad`,
whose backward reduce-scatters the cotangents). Dense attention gathers K
and V and runs its ``S/p`` query rows against the ``S`` keys, the causal
mask offset by the rank's first column. Flash attention gathers Q as well
and runs K1-K3 at the whole length, keeping the rank's rows: the kernels
take one length for queries and keys, and at the whole length they round as
the reference's flash kernel does on the gathered sequence.

Decode mode (``decode=True``, reference ``bert.py:297-404, :527-551``) keeps
dense K/V caches ``[B, L, H, D]`` (``L = decode_cache_len or max_seq_len``)
and position counters, a scalar each or, with ``decode_slots``, one per
batch row. The cache is a flat dict of tensors under the reference's cache
paths in the port's dotted form (``layer_{i}.attention.cached_key``,
``cached_value``, ``cache_index``; ``pos_index`` at the top). It goes in
with the weights, ``model.apply({**params, **cache}, tokens)``, and the
updated cache comes back as the apply's ``new_state``; a leaf not given
starts at zeros, as a flax cache variable does. Every write and index moves
on the device: no step reads a counter back to the host. The attention
``out`` and ``mlp_out`` projections then form their product in float32,
round it to the compute dtype and add the bias there (two roundings, the
reference's ``_F32AccumDense``).

Paged decode (``paged_blocks > 0``, reference ``bert.py:297-361, :512-526``)
replaces each layer's dense cache with a shared block pool
``[paged_blocks, page_tokens, H, D]`` under the reference's leaf names
(``layer_{i}.attention.pool_key``, ``pool_value``). The module keeps no
position state: every apply takes ``positions`` (int32 ``[B]``, where each
row's first token sits) and ``block_tables`` (int32 ``[B, T]``); their index
work is done once an apply (:class:`~distkeras_tpu_torch.ops.attention.PagedPlan`,
the reference's ``paged_kv_update`` and ``paged_attention``) and shared by
every layer.
``return_hidden=True`` returns the trunk's last activation ``[B, S, H]``
(before the final LayerNorm and the head) instead of logits, in every mode.
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.ops.attention import PagedPlan, constrain_heads, dot_product_attention
from distkeras_tpu_torch.ops.flash_attention import flash_attention
from distkeras_tpu_torch.ops.moe import EXPERT_AXES, MoEMLP
from distkeras_tpu_torch.ops.ring_flash import ring_flash_attention
from distkeras_tpu_torch.ops.ulysses import ulysses_self_attention
from distkeras_tpu_torch.parallel.distributed import axis_ring, sp_all_gather_grad
from distkeras_tpu_torch.parallel.mesh import Mesh
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.utils.rng import fold_in

__all__ = [
    "BertConfig", "Bert", "EncoderLayer", "SelfAttention", "dropout", "decode_cache",
    "PARAM_AXES", "param_axes", "with_ep_mesh", "with_ring_mesh", "with_seq_mesh",
    "with_tp_mesh",
    "bert_base_mlm", "bert_tiny_mlm", "bert_tiny_moe_mlm", "gpt_tiny", "gpt_small",
]

# The logical axes of each weight (reference ``nn.with_logical_partitioning``
# at ``distkeras_tpu/models/bert.py:224-227, :294, :437-439, :485, :506,
# :594``; ``ops/moe.py:76, :140, :148``), by ``state_dict`` name. A torch
# ``Linear.weight`` is ``[out, in]``, the transpose of flax's kernel, so its
# axes are the reference's reversed; the MoE expert weights are plain
# parameters in the reference's layout, their axes as there. Every other leaf
# (biases, LayerNorms, the MoE router) has none: it is replicated.
PARAM_AXES: tuple[tuple[str, tuple], ...] = (
    (r"layer_\d+\.attention\.(query|key|value)\.weight", ("heads", "embed")),
    (r"layer_\d+\.attention\.out\.weight", ("embed", "heads")),
    (r"layer_\d+\.mlp_in\.weight", ("mlp", "embed")),
    (r"layer_\d+\.mlp_out\.weight", ("embed", "mlp")),
    *((rf"layer_\d+\.moe_mlp\.{leaf}", axes) for leaf, axes in EXPERT_AXES.items()),
    (r"token_embed\.weight", ("vocab", "embed")),
    (r"pos_embed", (None, "seq", "embed")),
    (r"mlm_bias", ("vocab",)),
)


def param_axes(name: str) -> tuple | None:
    """The logical axes of the weight ``name`` (:data:`PARAM_AXES`), or
    None for a leaf without any."""
    for pattern, axes in PARAM_AXES:
        if re.fullmatch(pattern, name):
            return axes
    return None


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_seq_len: int = 512
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    use_flash_attention: bool = False
    moe_experts: int = 0
    moe_top_k: int = 1
    causal: bool = False
    ring_mesh: object = None
    ring_axis: str = "sp"
    sp_impl: str = "ring"
    decode: bool = False
    decode_slots: bool = False
    decode_cache_len: int = 0
    paged_blocks: int = 0
    page_tokens: int = 16
    page_table_blocks: int = 0
    tp_mesh: object = None
    ep_mesh: object = None
    seq_mesh: object = None

    def __post_init__(self):
        if self.ep_mesh is not None and not isinstance(self.ep_mesh, Mesh):
            raise TypeError(f"BertConfig.ep_mesh must be a distkeras_tpu_torch Mesh, "
                            f"not {type(self.ep_mesh).__name__}")
        if self.tp_mesh is not None:
            if not isinstance(self.tp_mesh, Mesh):
                raise TypeError(f"BertConfig.tp_mesh must be a distkeras_tpu_torch Mesh, "
                                f"not {type(self.tp_mesh).__name__}")
            tp = _tp_size(self)
            if self.num_heads % tp:
                raise ValueError(f"num_heads {self.num_heads} does not divide over tp={tp}")
        if self.ring_mesh is not None:
            if not isinstance(self.ring_mesh, Mesh):
                raise TypeError(f"BertConfig.ring_mesh must be a distkeras_tpu_torch Mesh, "
                                f"not {type(self.ring_mesh).__name__}")
            if self.ring_axis not in self.ring_mesh.axis_names:
                raise ValueError(f"BertConfig.ring_axis {self.ring_axis!r} is not an axis of "
                                 f"ring_mesh {self.ring_mesh.axis_names}")
        if self.seq_mesh is not None:
            if not isinstance(self.seq_mesh, Mesh):
                raise TypeError(f"BertConfig.seq_mesh must be a distkeras_tpu_torch Mesh, "
                                f"not {type(self.seq_mesh).__name__}")
            if "sp" not in self.seq_mesh.axis_names:
                raise ValueError(f"BertConfig.seq_mesh has no 'sp' axis: "
                                 f"{self.seq_mesh.axis_names}")
            if self.ring_mesh is not None:
                raise ValueError("BertConfig.seq_mesh and ring_mesh both split the sequence: "
                                 "give one of them")


def _tp_size(cfg: BertConfig) -> int:
    return 1 if cfg.tp_mesh is None else cfg.tp_mesh.shape.get("tp", 1)


def _tp(cfg: BertConfig):
    """``(size, rank, group)`` of ``cfg.tp_mesh``'s tp axis, or None when
    there is no such axis above 1."""
    n = _tp_size(cfg)
    if n == 1:
        return None
    group = cfg.tp_mesh.group("tp")
    if group is None:
        raise RuntimeError(f"BertConfig.tp_mesh with tp={n} needs a process group over its "
                           f"ranks (distkeras_tpu_torch.parallel.distributed.initialize)")
    return n, torch.distributed.get_rank(group), group


def _ep(cfg: BertConfig):
    """``(group, size)`` of ``cfg.ep_mesh``'s ep axis, ``(None, 1)`` when
    there is no such axis above 1."""
    n = 1 if cfg.ep_mesh is None else cfg.ep_mesh.shape.get("ep", 1)
    if n == 1:
        return None, 1
    group = cfg.ep_mesh.group("ep")
    if group is None:
        raise RuntimeError(f"BertConfig.ep_mesh with ep={n} needs a process group over its "
                           f"ranks (distkeras_tpu_torch.parallel.distributed.initialize)")
    return group, n


def _moe_shards(cfg: BertConfig):
    """The group whose ranks' MoE outputs add up to the layer's: the ep
    group (:func:`_ep`), the tp group, or the joint ``(ep, tp)`` group of the
    one mesh that holds both axes; None without either."""
    group, n = _ep(cfg)
    tp = _tp(cfg)
    if tp is None:
        return group
    if n == 1:
        return tp[2]
    if cfg.ep_mesh is not cfg.tp_mesh:
        raise ValueError("BertConfig.ep_mesh and tp_mesh must be the same mesh when both "
                         "axes are above 1: the layer sums its experts' shares over both")
    return cfg.ep_mesh.group(("ep", "tp"))


def _all_reduce(x, group):
    out = x.contiguous().clone()
    with span("tp_all_reduce"):
        torch.distributed.all_reduce(out, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    """The input of a tp-split region: the identity forward; backward, the
    ranks' gradients (each through its own shard) summed over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """The ranks' partial sums added over tp; backward, the identity (every
    rank holds the same loss, so each partial takes the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    """The ranks' ``[..., W]`` slices gathered along the last dimension, in
    rank order; backward, this rank's slice of the gradient (the ranks
    compute the same loss on the gathered rows: a summing backward would
    give tp times the gradient)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.slice = (rank * x.shape[-1], (rank + 1) * x.shape[-1])
        parts = [torch.empty_like(x) for _ in range(n)]
        with span("tp_gather"):
            torch.distributed.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.slice
        return grad[..., lo:hi], None, None, None


def _tp_input(cfg: BertConfig, x):
    tp = _tp(cfg)
    return x if tp is None else _CopyToTP.apply(x, tp[2])


def dropout(x, rate: float, seed: int | None):
    """flax ``nn.Dropout`` in train mode: keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``, in x's dtype. The keep
    mask comes from a ``torch.Generator`` on x's device seeded with ``seed``."""
    if rate == 0.0:
        return x
    if seed is None:
        raise ValueError("dropout in train mode needs a seed: apply(..., train=True, rng=seed)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _lecun_normal_(weight: torch.Tensor, generator) -> None:
    """flax ``lecun_normal``: truncated normal (±2σ), variance 1/fan_in."""
    fan_in = weight.shape[1]  # torch Linear weight is [out, in]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` with float32 weights and its matmul in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def init_weights(self, generator) -> None:
        _lecun_normal_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _SplitDense(Dense):
    """A ``Dense`` that splits over ``cfg.tp_mesh``'s tp axis, when it has
    one above 1."""

    def __init__(self, in_features: int, out_features: int, cfg: BertConfig):
        super().__init__(in_features, out_features, cfg.dtype)
        self.cfg = cfg


class _ColumnDense(_SplitDense):
    """Output features split over tp: this rank's weight holds its rows.
    The bias is whole (the reference replicates it); the rank adds its
    slice, and the slice's gradient is summed over tp into the whole bias,
    so the ranks' biases stay equal."""

    def forward(self, x):
        tp = _tp(self.cfg)
        if tp is None:
            return super().forward(x)
        n, rank, group = tp
        width = self.bias.shape[0] // n
        bias = _CopyToTP.apply(self.bias, group)[rank * width:(rank + 1) * width]
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), bias.to(dt))


class _RowDense(_SplitDense):
    """Input features split over tp: the ranks' partial products are summed
    over tp, then the whole bias is added once."""

    def forward(self, x):
        tp = _tp(self.cfg)
        if tp is None:
            return super().forward(x)
        dt = self.compute_dtype
        y = _ReduceFromTP.apply(F.linear(x.to(dt), self.weight.to(dt)), tp[2])
        return y + self.bias.to(dt)


class _F32AccumDense(_RowDense):
    """The decode-mode ``attention.out`` and ``mlp_out`` projections
    (reference ``_F32AccumDense``): the product accumulates in float32 and
    is rounded once to the compute dtype, and the bias is added after, in
    that dtype. Under tp the ranks' float32 partial products are summed
    before that one rounding, so a sharded decode rounds as the whole one
    does. Names and shapes are ``Dense``'s, so weights carry over."""

    def forward(self, x):
        dt = self.compute_dtype
        tp = _tp(self.cfg)
        if tp is None:
            return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)
        y = F.linear(x.to(dt).float(), self.weight.to(dt).float())
        return _ReduceFromTP.apply(y, tp[2]).to(dt) + self.bias.to(dt)


def _reduce_dense(cfg: "BertConfig", in_features: int, out_features: int) -> Dense:
    return (_F32AccumDense if cfg.decode else _RowDense)(in_features, out_features, cfg)


def _cache_leaf(module: nn.Module, name: str, shape, dtype, device) -> torch.Tensor:
    """The cache leaf ``name`` given to this apply, or zeros of ``shape``
    when none was (the module's own placeholder is empty)."""
    leaf = getattr(module, name)
    if leaf.numel() == 0:
        return torch.zeros(shape, dtype=dtype, device=device)
    return leaf


def _register_cache(module: nn.Module, *names: str) -> None:
    # Empty, non-persistent placeholders: the cache never enters the
    # state_dict, and an apply swaps the given leaves in by name.
    for name in names:
        module.register_buffer(name, torch.empty(0), persistent=False)


def _pos_window(pos_embed, starts, S: int, max_seq_len: int):
    """Per-row positional window ``[B, S, H]``: row ``b`` takes positions
    ``starts[b] .. starts[b] + S - 1``, each clipped to the table on its own
    (reference ``_pos_window``)."""
    pos_ids = starts[:, None].long() + torch.arange(S, device=starts.device)[None, :]
    return pos_embed[0][pos_ids.clamp(0, max_seq_len - 1)]


def _layer_norm(hidden: int) -> nn.LayerNorm:
    return nn.LayerNorm(hidden, eps=1e-6)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = _ColumnDense(h, h, cfg)
        self.key = _ColumnDense(h, h, cfg)
        self.value = _ColumnDense(h, h, cfg)
        self.out = _reduce_dense(cfg, h, h)
        if cfg.decode and cfg.paged_blocks > 0:
            _register_cache(self, "pool_key", "pool_value")
        elif cfg.decode:
            _register_cache(self, "cached_key", "cached_value", "cache_index")

    def forward(self, x, mask=None, new_cache: dict | None = None,
                paged: PagedPlan | None = None):
        """``new_cache`` (decode mode): receives this layer's updated cache
        leaves under their names. ``paged``: the paged decode's index plan
        of this apply."""
        cfg = self.cfg
        B, S = x.shape[0], x.shape[1]
        heads = cfg.num_heads // _tp_size(cfg)  # this rank's
        D = cfg.hidden_size // cfg.num_heads
        shape = (B, S, heads, D)
        x = _tp_input(cfg, x)
        q = self.query(x).reshape(shape)
        k = self.key(x).reshape(shape)
        v = self.value(x).reshape(shape)
        if cfg.decode and cfg.paged_blocks > 0:
            out = self._paged_attention(q, k, v, new_cache, paged)
        elif cfg.decode:
            out = self._decode_attention(q, k, v, new_cache)
        elif cfg.ring_mesh is not None and mask is None:
            out = _sp_attention(cfg, q, k, v)
        elif cfg.seq_mesh is not None and mask is None and _seq_ring(cfg).size > 1:
            out = _gathered_attention(cfg, q, k, v)
        elif cfg.use_flash_attention and mask is None:
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = dot_product_attention(q, k, v, mask=mask, causal=cfg.causal)
        return self.out(out.reshape(B, S, heads * D))

    def _kv_leaf(self, name: str, shape, device):
        """A K/V cache leaf (``shape`` holds this rank's heads), checked to
        hold this rank's heads under ``tp_mesh``."""
        leaf = _cache_leaf(self, name, shape, self.cfg.dtype, device)
        return constrain_heads(leaf, self.cfg.tp_mesh, self.cfg.num_heads)

    def _paged_attention(self, q, k, v, new_cache: dict, plan: PagedPlan):
        """Paged branch of the reference's ``_decode_attention``: the new
        K/V go into the pools through the block tables (writes past a
        row's blocks are dropped) and the queries attend to each row's
        gathered blocks under ``k_pos <= q_pos``. The pools are written in
        place and handed back as the layer's new cache leaves."""
        cfg = self.cfg
        H, D = q.shape[2], q.shape[3]
        shape = (cfg.paged_blocks, cfg.page_tokens, H, D)
        pk = plan.write(self._kv_leaf("pool_key", shape, q.device), k)
        pv = plan.write(self._kv_leaf("pool_value", shape, q.device), v)
        new_cache["pool_key"] = pk
        new_cache["pool_value"] = pv
        return plan.attend(q, pk, pv)

    def _decode_attention(self, q, k, v, new_cache: dict):
        """KV-cache attention (reference ``_decode_attention``, dense
        branch). One path serves prefill (S = prompt length) and one-token
        steps: the new K/V are written at the cache index, the queries
        attend to the whole cache under ``key position <= query position``,
        and the index advances by S. The write start is clamped to
        ``[0, L - S]``, as ``lax.dynamic_update_slice`` clamps it; with
        slots each row writes at its own index, which advances as
        ``min(idx + S, L)``."""
        cfg = self.cfg
        B, S, H, D = q.shape
        L = cfg.decode_cache_len or cfg.max_seq_len
        dev = q.device
        ck = self._kv_leaf("cached_key", (B, L, H, D), dev)
        cv = self._kv_leaf("cached_value", (B, L, H, D), dev)
        idx = _cache_leaf(self, "cache_index", (B,) if cfg.decode_slots else (),
                          torch.int32, dev)
        steps = torch.arange(S, device=dev)
        rows = idx.long().expand(B)  # per-row write index
        write = (rows.clamp(0, max(L - S, 0))[:, None] + steps[None, :])[:, :, None, None]
        write = write.expand(B, S, H, D)
        ck = ck.scatter(1, write, k.to(ck.dtype))
        cv = cv.scatter(1, write, v.to(cv.dtype))
        k_pos = torch.arange(L, device=dev)
        if cfg.decode_slots:
            new_idx = torch.clamp(idx + S, max=L)
            q_pos = idx.long()[:, None] + steps[None, :]  # [B, S]
            mask = k_pos[None, None, None, :] <= q_pos[:, None, :, None]  # [B, 1, S, L]
        else:
            new_idx = idx + S
            q_pos = idx.long() + steps  # [S]
            mask = (k_pos[None, :] <= q_pos[:, None])[None, None]  # [1, 1, S, L]
        new_cache["cached_key"] = ck
        new_cache["cached_value"] = cv
        new_cache["cache_index"] = new_idx
        return dot_product_attention(q, ck, cv, mask=mask)


def _sp_attention(cfg: BertConfig, q, k, v):
    """Attention across ``cfg.ring_mesh``'s ``ring_axis`` by ``cfg.sp_impl``
    (reference ``SelfAttention`` under ``ring_mesh``)."""
    if cfg.sp_impl == "ulysses":
        attn_fn = flash_attention if cfg.use_flash_attention else None
        return ulysses_self_attention(q, k, v, cfg.ring_mesh, cfg.ring_axis, cfg.causal,
                                      attn_fn)
    if cfg.sp_impl in ("ring", "ring_stripe"):
        stripe = cfg.sp_impl == "ring_stripe"
        if stripe and not cfg.causal:
            raise ValueError("sp_impl='ring_stripe' is causal-only (striping balances the "
                             "causal triangle; non-causal rings are already balanced — use "
                             "sp_impl='ring')")
        return ring_flash_attention(q, k, v, cfg.ring_mesh, cfg.ring_axis, cfg.causal,
                                    stripe=stripe)
    raise ValueError(f"unknown sp_impl {cfg.sp_impl!r}: expected 'ring', 'ring_stripe', "
                     f"or 'ulysses'")


def _seq_ring(cfg: BertConfig):
    """The :class:`AxisRing` the tokens are split over: ``ring_mesh``'s
    ``ring_axis``, or ``seq_mesh``'s ``sp``."""
    if cfg.ring_mesh is not None:
        return axis_ring(cfg.ring_mesh, cfg.ring_axis)
    return axis_ring(cfg.seq_mesh, "sp")


def _gathered_attention(cfg: BertConfig, q, k, v):
    """Attention of this rank's ``[B, S/p]`` query columns under
    ``seq_mesh`` (see the module's docstring): the columns it needs
    gathered over sp, then dense attention of the rank's rows against every
    key, or K1-K3 at the whole length."""
    ring = _seq_ring(cfg)
    s = q.shape[1]
    if cfg.use_flash_attention:
        q, k, v = sp_all_gather_grad([q, k, v], ring)
        out = flash_attention(q, k, v, causal=cfg.causal)
        return out[:, ring.index * s:(ring.index + 1) * s]
    k, v = sp_all_gather_grad([k, v], ring)
    mask = None
    if cfg.causal:
        q_pos = ring.index * s + torch.arange(s, device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
    return dot_product_attention(q, k, v, mask=mask)


def _sp_positions(cfg: BertConfig, S: int, device):
    """The positions of this rank's ``S`` tokens under ``ring_mesh`` or
    ``seq_mesh``: ``m·S + j`` contiguous, ``j·p + m`` striped (rank ``m``
    of ``p``)."""
    ring = _seq_ring(cfg)
    if S * ring.size > cfg.max_seq_len:
        raise ValueError(f"{ring.size} shards of {S} tokens exceed max_seq_len "
                         f"{cfg.max_seq_len}")
    j = torch.arange(S, device=device)
    if cfg.ring_mesh is not None and cfg.sp_impl == "ring_stripe":
        return j * ring.size + ring.index
    return ring.index * S + j


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = _layer_norm(cfg.hidden_size)
        self.attention = SelfAttention(cfg)
        self.ln_mlp = _layer_norm(cfg.hidden_size)
        if cfg.moe_experts > 0:
            group, n = _ep(cfg)
            self.moe_mlp = MoEMLP(cfg.moe_experts, cfg.mlp_dim, cfg.hidden_size,
                                  dtype=cfg.dtype, residual=False,
                                  router_top_k=cfg.moe_top_k, ep_group=group, ep_size=n)
        else:
            self.mlp_in = _ColumnDense(cfg.hidden_size, cfg.mlp_dim, cfg)
            self.mlp_out = _reduce_dense(cfg, cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x, mask=None, train: bool = False, rng: int | None = None,
                new_cache: dict | None = None, paged: PagedPlan | None = None,
                aux: list | None = None):
        """``aux``: an MoE layer appends its load-balancing loss."""
        p = self.cfg.dropout_rate if train else 0.0
        y = self.attention(self.ln_attn(x.float()), mask=mask, new_cache=new_cache,
                           paged=paged)
        x = x + dropout(y, p, None if rng is None else fold_in(rng, 0))
        if self.cfg.moe_experts > 0:
            # The float32 LayerNorm output in, float32 out; the residual
            # stays in the compute dtype (reference bert.py:442-444).
            # Its shard group and sequence split are resolved here, as the
            # attention's groups are: a mesh's groups are built collectively.
            cfg = self.cfg
            split = not cfg.decode and (cfg.ring_mesh is not None or cfg.seq_mesh is not None)
            y, layer_aux = self.moe_mlp(self.ln_mlp(x.float()), shard_group=_moe_shards(cfg),
                                        seq_ring=_seq_ring(cfg) if split else None)
            if aux is not None:
                aux.append(layer_aux)
        else:
            y = self.mlp_in(_tp_input(self.cfg, self.ln_mlp(x.float())))
            y = self.mlp_out(F.gelu(y, approximate="tanh"))
        return x + dropout(y, p, None if rng is None else fold_in(rng, 1)).to(x.dtype)


class Bert(nn.Module):
    """BERT encoder with a tied-embedding MLM head.

    Input: integer token ids ``[B, S]``. Output: float32 vocab logits
    ``[B, S, V]`` (under ``ring_mesh`` or ``seq_mesh`` this rank's ``[B, S/p]`` shard and its
    ``[B, S/p, V]`` logits). Submodules are named as the reference's flax modules
    (``token_embed``, ``pos_embed``, ``layer_{i}``, ``ln_final``,
    ``mlm_bias``)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.max_seq_len, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg))
        self.ln_final = _layer_norm(cfg.hidden_size)
        self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size))
        if cfg.decode and not cfg.paged_blocks:
            _register_cache(self, "pos_index")

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def init_weights(self, generator) -> None:
        """Initial weights as the reference draws them (in distribution):
        normal(0.02) embeddings, lecun-normal dense kernels, zero biases,
        unit LayerNorm scales, lecun-normal MoE leaves."""
        nn.init.normal_(self.token_embed.weight, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        nn.init.zeros_(self.mlm_bias)
        for module in self.modules():
            if isinstance(module, (Dense, MoEMLP)):
                module.init_weights(generator)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def forward(self, token_ids, train: bool = False, rng: int | None = None,
                positions=None, block_tables=None, return_hidden: bool = False,
                stage=None):
        """``rng``: the integer seed of this forward's dropout masks (needed
        when ``train`` and ``dropout_rate > 0``); site ``i`` draws from
        ``fold_in(rng, i)``. In decode mode returns ``(logits, new_cache)``.
        ``positions``/``block_tables``: the paged decode's inputs (reference
        ``Bert.__call__``). ``return_hidden``: the trunk's last activation
        in place of the logits.

        A training apply of an MoE config returns ``(logits, {"aux_loss":
        the layers' summed load-balancing loss})``.

        ``stage=(lo, hi, first, last)``: the contiguous layer slice
        ``[lo, hi)`` of a pipeline stage (reference ``bert.py:458-470``).
        A ``first`` stage takes token ids and runs the embedding (and, dense
        decode, advances ``pos_index``); a later stage takes the previous
        stage's activation ``[B, S, H]`` in the compute dtype as its first
        argument. A ``last`` stage runs the final LayerNorm and the tied
        head; an earlier one returns the activation. The weights and the
        cache given are the stage's own (``parallel/pp.py``)."""
        cfg = self.cfg
        lo, hi, first, last = (0, cfg.num_layers, True, True) if stage is None else stage
        B, S = token_ids.shape[0], token_ids.shape[1]
        table = self.token_embed.weight  # this rank's vocab rows under tp
        tp = _tp(cfg)
        new_cache = plan = None
        if cfg.decode:
            new_cache = {}
        if cfg.decode and cfg.paged_blocks > 0 and (first or lo < hi):
            # Position-stateless: the positional window comes from the
            # caller's positions (reference bert.py:512-526), and every
            # stage's layers index the pools through the same plan.
            if positions is None:
                raise ValueError("paged decode needs positions [B]")
            if block_tables is None:
                raise ValueError(
                    "paged decode needs positions [B] and block_tables [B, T] passed to "
                    "every apply")
            plan = PagedPlan(block_tables, positions, S, cfg.paged_blocks, cfg.page_tokens)
        if first:
            x = self._embed(token_ids, table, tp, positions, new_cache)
        else:
            x = token_ids  # the previous stage's activation, not re-rounded

        def site(i):
            return None if rng is None else fold_in(rng, i)

        if first:
            x = dropout(x, cfg.dropout_rate if train else 0.0, site(0))
        aux = [] if train and cfg.moe_experts > 0 else None
        for i in range(lo, hi):
            layer = getattr(self, f"layer_{i}")
            layer_cache = None if new_cache is None else {}
            x = layer(x, train=train, rng=site(i + 1), new_cache=layer_cache, paged=plan,
                      aux=aux)
            if layer_cache:
                new_cache.update({f"layer_{i}.attention.{k}": v for k, v in layer_cache.items()})
        if aux is not None:
            new_cache = {"aux_loss": torch.stack(aux).sum() if aux
                         else torch.zeros((), device=x.device)}
        if return_hidden or not last:
            return x if new_cache is None else (x, new_cache)
        x = self.ln_final(x.float())
        if tp is not None:
            x = _CopyToTP.apply(x, tp[2])
        # The vocab rows are padded to a multiple of 8 so that the product's
        # rows stay 16-byte aligned: with 30522 or 50257 columns cuBLAS
        # otherwise takes an unaligned kernel several times slower. The pad
        # columns are dropped before the bias.
        rows = table.shape[0]
        w = F.pad(table.to(cfg.dtype), (0, 0, 0, -rows % 8))
        logits = torch.matmul(x.to(cfg.dtype), w.t())[..., :rows]
        logits = torch.add(logits, self.mlm_bias)  # widens to float32 in the add
        if tp is not None:  # [B, S, V/tp] -> [B, S, V]: the loss takes whole rows
            logits = _GatherFromTP.apply(logits, tp[2], tp[1], tp[0])
        return logits if new_cache is None else (logits, new_cache)

    def _embed(self, token_ids, table, tp, positions, new_cache):
        """The first stage's input: token and positional embeddings in the
        compute dtype; dense decode also advances ``pos_index`` into
        ``new_cache``."""
        cfg = self.cfg
        B, S = token_ids.shape[0], token_ids.shape[1]
        if tp is None:
            x = F.embedding(token_ids.long(), table)
        else:
            rows = table.shape[0]
            ids = token_ids.long() - tp[1] * rows
            inside = (ids >= 0) & (ids < rows)
            x = torch.where(inside[..., None], F.embedding(ids.clamp(0, rows - 1), table), 0.0)
            x = _ReduceFromTP.apply(x, tp[2])
        x = x.to(cfg.dtype)
        if cfg.decode and cfg.paged_blocks > 0:
            pos = _pos_window(self.pos_embed, positions, S, cfg.max_seq_len)
        elif cfg.decode:
            # Positions advance with the caches (reference bert.py:527-551).
            pi = _cache_leaf(self, "pos_index", (B,) if cfg.decode_slots else (),
                             torch.int32, x.device)
            if cfg.decode_slots:
                pos = _pos_window(self.pos_embed, pi, S, cfg.max_seq_len)  # [B, S, H]
                new_cache["pos_index"] = torch.clamp(pi + S, max=cfg.max_seq_len)
            else:
                # lax.dynamic_slice clamps the window into the table; a
                # plain slice past its end would silently shorten.
                start = pi.long().clamp(0, cfg.max_seq_len - S)
                pos = self.pos_embed[:, start + torch.arange(S, device=x.device)]
                new_cache["pos_index"] = pi + S
        elif cfg.ring_mesh is not None or cfg.seq_mesh is not None:
            pos = self.pos_embed[0][_sp_positions(cfg, S, x.device)]
        else:
            pos = self.pos_embed[:, :S]
        return x + pos.to(cfg.dtype)


def decode_cache(cfg: BertConfig, batch_size: int, device) -> dict[str, torch.Tensor]:
    """The zero decode cache of ``cfg`` for ``batch_size`` rows, keyed as
    :class:`Bert` reads and returns it (this rank's heads under
    ``tp_mesh``). A paged config's cache is its block pools alone, whatever
    ``batch_size``."""
    L = cfg.decode_cache_len or cfg.max_seq_len
    D = cfg.hidden_size // cfg.num_heads
    H = cfg.num_heads // _tp_size(cfg)  # this rank's heads under tp_mesh
    if cfg.paged_blocks > 0:
        shape = (cfg.paged_blocks, cfg.page_tokens, H, D)
        return {f"layer_{i}.attention.{name}": torch.zeros(shape, dtype=cfg.dtype,
                                                           device=device)
                for i in range(cfg.num_layers) for name in ("pool_key", "pool_value")}
    idx_shape = (batch_size,) if cfg.decode_slots else ()
    cache = {"pos_index": torch.zeros(idx_shape, dtype=torch.int32, device=device)}
    for i in range(cfg.num_layers):
        prefix = f"layer_{i}.attention."
        for name in ("cached_key", "cached_value"):
            cache[prefix + name] = torch.zeros((batch_size, L, H, D),
                                               dtype=cfg.dtype, device=device)
        cache[prefix + "cache_index"] = torch.zeros(idx_shape, dtype=torch.int32, device=device)
    return cache


def _bert_flops(cfg: BertConfig, seq_len: int) -> float:
    per_token = cfg.num_layers * 2 * (4 * cfg.hidden_size**2 + 2 * cfg.hidden_size * cfg.mlp_dim)
    attn = cfg.num_layers * 2 * 2 * seq_len * cfg.hidden_size
    head = 2 * cfg.hidden_size * cfg.vocab_size
    return float(seq_len * (per_token + attn + head))


def _make(cfg: BertConfig, seq_len: int, name: str) -> Model:
    m = Model(
        lambda: Bert(cfg),
        name=name,
        input_shape=(seq_len,),
        output_dim=cfg.vocab_size,
        flops_per_example=_bert_flops(cfg, seq_len),
    )
    m.config = cfg
    m.param_axes = param_axes  # annotated: the reference's boxed_init
    return m


def with_tp_mesh(model: Model, mesh: Mesh | None) -> Model:
    """The bert-family ``model`` with ``mesh`` as its config's ``tp_mesh``:
    its forward computes on this rank's tp shards of the weights."""
    cfg = dataclasses.replace(model.config, tp_mesh=mesh)
    return _make(cfg, model.input_shape[0], model.name)


def with_ep_mesh(model: Model, mesh: Mesh | None) -> Model:
    """The bert-family ``model`` with ``mesh`` as its config's ``ep_mesh``:
    each MoE layer computes on this rank's experts of the mesh's ep axis."""
    cfg = dataclasses.replace(model.config, ep_mesh=mesh)
    return _make(cfg, model.input_shape[0], model.name)


def with_ring_mesh(model: Model, mesh: Mesh | None) -> Model:
    """The bert-family ``model`` with ``mesh`` as its config's ``ring_mesh``
    (its ``ring_axis`` and ``sp_impl`` kept)."""
    cfg = dataclasses.replace(model.config, ring_mesh=mesh)
    return _make(cfg, model.input_shape[0], model.name)


def with_seq_mesh(model: Model, mesh: Mesh | None) -> Model:
    """The bert-family ``model`` with ``mesh`` as its config's ``seq_mesh``:
    its forward takes this rank's columns over the mesh's sp axis and
    gathers what attention needs (the reference's XLA sequence split)."""
    cfg = dataclasses.replace(model.config, seq_mesh=mesh)
    return _make(cfg, model.input_shape[0], model.name)


def bert_base_mlm(seq_len: int = 128, vocab_size: int = 30522) -> Model:
    return _make(BertConfig(vocab_size=vocab_size), seq_len, "bert_base_mlm")


def bert_tiny_mlm(seq_len: int = 64, vocab_size: int = 1024,
                  dropout_rate: float = 0.1) -> Model:
    cfg = BertConfig(
        vocab_size=vocab_size, hidden_size=128, num_layers=2, num_heads=4,
        mlp_dim=512, max_seq_len=max(seq_len, 64),
        dropout_rate=dropout_rate,
    )
    return _make(cfg, seq_len, "bert_tiny_mlm")


def bert_tiny_moe_mlm(seq_len: int = 64, vocab_size: int = 1024, num_experts: int = 4,
                      top_k: int = 1) -> Model:
    """MoE variant of ``bert_tiny_mlm``: each MLP block is a routed expert
    mixture (ep-shardable); ``top_k=2`` selects GShard top-2 routing."""
    cfg = BertConfig(
        vocab_size=vocab_size, hidden_size=128, num_layers=2, num_heads=4,
        mlp_dim=512, max_seq_len=max(seq_len, 64), moe_experts=num_experts,
        moe_top_k=top_k,
    )
    return _make(cfg, seq_len, f"bert_tiny_moe{'_top2' if top_k == 2 else ''}_mlm")


def gpt_tiny(seq_len: int = 64, vocab_size: int = 1024) -> Model:
    """Decoder-only causal LM (GPT-style): the same stack with causal
    masking and the tied LM head."""
    cfg = BertConfig(
        vocab_size=vocab_size, hidden_size=128, num_layers=2, num_heads=4,
        mlp_dim=512, max_seq_len=max(seq_len, 64), causal=True,
    )
    return _make(cfg, seq_len, "gpt_tiny")


def gpt_small(seq_len: int = 512, vocab_size: int = 50257) -> Model:
    """GPT-2-small-shaped causal LM (124M params)."""
    cfg = BertConfig(
        vocab_size=vocab_size, hidden_size=768, num_layers=12, num_heads=12,
        mlp_dim=3072, max_seq_len=max(seq_len, 512), causal=True,
    )
    return _make(cfg, seq_len, "gpt_small")
