"""Mixture-of-Experts with expert, tensor and sequence parallelism:
counterpart of ``distkeras_tpu/ops/moe.py``.

A GShard-style routed MLP: a float32 router picks each token's expert
(Switch top-1) or two experts (GShard top-2, the two gates renormalised to
sum to 1), a capacity-bounded one-hot dispatch tensor ``[T, E, C]`` moves
the tokens into each expert's ``[C, D]`` slab, every expert runs its dense
MLP as one batched product, and the combine tensor (dispatch times the
gates) brings the outputs back to the tokens. Under top-2 every first
choice is seated before any second choice, so second choices are dropped
first; a token dropped by all its experts passes through the residual
unchanged. The Switch load-balancing loss ``E · Σ_e frac_e · prob_e`` over
first choices comes back from :meth:`MoEMLP.forward` beside the output.

The products are plain ``torch.einsum`` (batched matmuls): the reference
computes them outside any Pallas kernel too.

**Expert parallelism** (``ep_group``, ``ep_size``; the reference's manual
``ep_axis`` mode and its ``("expert", "ep")`` rule): each rank of the ep
group holds ``E / ep_size`` experts (its ``w_in``/``w_out`` are
``[E/ep, ...]``), routes the whole token set (the tokens and the router are
replicated over ep) and computes its experts' share of the output.
**Tensor parallelism** (the reference's ``("mlp", "tp")`` rule) splits each
expert's hidden width: a rank holds ``w_in`` ``[E/ep, D, M/tp]`` and
``w_out`` ``[E/ep, M/tp, D]``, and since GELU is elementwise its output is a
partial sum over tp. ``shard_group`` is the group whose ranks' outputs add
up to the layer's: the ep group, the tp group, or under both the joint
``(ep, tp)`` group, summed in one all-reduce (span ``ep_all_reduce``). The
backward has to put the same sum back: a rank's task-loss gradient reaches
the router, the LayerNorm and everything below them only through its own
experts' columns, through the gates that build its slice of ``combine`` and
through the tokens its experts were dispatched. So the gates and the tokens
enter the rank's slice through :class:`_CopyToEP`, identity forward and a
sum over ``shard_group`` backward (the gates carry the same sum as
``combine`` would, at ``T`` numbers instead of ``T·E·C``), and the output's
sum is :class:`_ReduceFromEP`, identity backward. The router and the aux
term are computed whole on every rank and need no sum. Every rank then
holds the whole gradient of every replicated leaf, the router included,
and its own experts' exact gradient: neither is summed or averaged over ep
or tp afterwards. The tokens are identical on the ranks of a
``shard_group`` (a tp model's activations come out of all-reduces that
give every rank the same bits), so those ranks pick the same experts and
seats. Only the expert weights (:data:`EXPERT_AXES`) split; the router
stays whole on every rank, on every path.

**The data group and the sequence split.** Under a data-parallel step
(:func:`~distkeras_tpu_torch.models.core.cross_replica_batch_stats`, the
ranks that hold other rows) and under a sequence split (``seq_ring``, the
ranks that hold other columns of the same rows: ``BertConfig.ring_mesh``
or ``seq_mesh``) the routing is the whole batch's, as the reference's XLA
computes it on the global ``[B, S]`` arrays, row-major: the capacity counts
every rank's tokens, and a token's queue position counts the choices of
every earlier row on every rank, then those of its own row on the sp ranks
before this one, then those of the tokens before it here; every first
choice of the batch is seated before any second choice. So a seat's base
is per row, not per rank (:func:`_row_bases`). Under
``sp_impl="ring_stripe"`` a rank's columns are its contiguous chunk of the
striped sequence, which is the order the reference routes its striped
trunk in. The load-balancing statistics are the whole batch's means. Small
collectives a layer carry that (span ``moe_route``): the per-row choice
counts gathered over sp, the per-rank counts over the data group, the gate
sums added over both. The experts then process each rank's own seats.

The gate sums' backward adds the ranks' cotangents too. Each of the ``N``
ranks of the data group and the sp ring holds the whole batch's aux, so the
cotangent of the summed gates is ``N`` times the whole batch's, on every
rank; the step averages the ranks' gradients over the same ``N`` ranks (the
data axes and sp), so the mean of the ranks' ``N ∂aux/∂prob · ∂prob_r/∂θ``
is ``Σ_r ∂aux/∂prob · ∂prob_r/∂θ``, the whole batch's gradient of the
load-balancing loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.core import batch_stats_group
from distkeras_tpu_torch.parallel.distributed import _staged
from distkeras_tpu_torch.parallel.island import IslandMember, all_reduce_sum_grad
from distkeras_tpu_torch.telemetry.spans import span

__all__ = ["EXPERT_AXES", "MoEMLP", "capacity", "is_expert_leaf"]

# The expert weights and their logical axes (reference ``ops/moe.py:140,
# :148``): the leading dimension holds the experts and splits over ``ep``,
# the hidden width over ``tp``. The router (``[D, E]``) is not among them:
# it stays replicated.
EXPERT_AXES = {"w_in": ("expert", "embed", "mlp"), "w_out": ("expert", "mlp", "embed")}


def is_expert_leaf(path) -> bool:
    """Whether the leaf at ``path`` (its keys, or a dotted name) is an MoE
    expert weight, ``moe_mlp.{w_in,w_out}`` (:data:`EXPERT_AXES`)."""
    names = [n for key in ([path] if isinstance(path, str) else path)
             for n in str(getattr(key, "key", key)).split(".")]
    return "moe_mlp" in names and names[-1] in EXPERT_AXES


def capacity(tokens: int, num_experts: int, capacity_factor: float, top_k: int) -> int:
    """Seats per expert: ``max(1, int(T / E · factor · top_k))``, truncated
    as the reference's code truncates (its docstring says ceil)."""
    return max(1, int(tokens / num_experts * capacity_factor * top_k))


def _ep_all_reduce(x, group):
    out = x.contiguous().clone()
    with span("ep_all_reduce"):
        torch.distributed.all_reduce(out, group=group)
    return out


class _CopyToEP(torch.autograd.Function):
    """A replicated tensor entering this rank's share of the experts: the
    identity forward; backward, the ranks' gradients (each through its own
    experts and columns) summed over the shard group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ep_all_reduce(grad, ctx.group), None


class _ReduceFromEP(torch.autograd.Function):
    """The ranks' shares of the output summed over the shard group;
    backward, the identity (every rank computes the same loss on the summed
    output)."""

    @staticmethod
    def forward(ctx, x, group):
        return _ep_all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverData(torch.autograd.Function):
    """A per-rank partial sum added over the data group; backward, the
    ranks' cotangents added too (each rank's loss holds the whole sum, and
    the step averages the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        with span("moe_route"):
            torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        with span("moe_route"):
            torch.distributed.all_reduce(out, group=ctx.group)
        return out, None


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> None:
    """flax ``lecun_normal``: truncated normal (±2σ), variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def _seats(onehot, base, cap: int):
    """Queue positions of one choice rank (reference ``_dispatch_for``):
    ``onehot`` ``[B, s, E]`` the choices of ``B`` rows of ``s`` tokens,
    ``base`` ``[B, E]`` each row's seats taken before its first token here.
    Returns the ``[B·s, E, C]`` dispatch of the choices that find a seat."""
    pos = (torch.cumsum(onehot, dim=1) - 1.0) * onehot + base[:, None, :] * onehot
    pos, onehot = pos.flatten(0, 1), onehot.flatten(0, 1)
    keep = (pos < cap).float() * onehot
    slot = (torch.clamp(pos, max=cap - 1).to(torch.int32) * onehot.to(torch.int32)).sum(-1)
    return keep[:, :, None] * F.one_hot(slot.long(), cap).float()[:, None, :]


def _gather(x, group, n: int):
    """Every rank's ``x`` of ``group`` stacked in group order, ``[n, ...]``
    (through host memory under gloo on CUDA tensors)."""
    staged = _staged(x, group)
    send = x.contiguous().cpu() if staged else x.contiguous()
    parts = torch.empty((n * send.numel(),), dtype=send.dtype, device=send.device)
    with span("moe_route"):
        torch.distributed.all_gather_into_tensor(parts, send.reshape(-1), group=group)
    return parts.to(x.device).view(n, *x.shape)


def _row_bases(rows, group, ring):
    """``(bases, total)``: ``rows`` ``[B, k, E]`` holds each of this rank's
    rows' per-expert counts of each choice rank; ``bases`` ``[B, k, E]`` the
    choices of that rank the whole batch seats before the row's first token
    here (every earlier row on every rank, then the row's columns on the sp
    ranks before this one: the reference's row-major order over the global
    ``[B, S]``), and ``total`` ``[k, E]`` the whole batch's counts."""
    before = torch.zeros_like(rows)
    if ring is not None and ring.size > 1:  # the same rows' other columns
        parts = _gather(rows, ring.group, ring.size)
        before = parts[:ring.index].sum(0)
        rows = parts.sum(0)
    mine = rows.sum(0)
    if group is None:
        data_before, total = torch.zeros_like(mine), mine
    elif isinstance(group, IslandMember):  # an async island's replicas
        with span("moe_route"):
            parts = group.gather(mine)
        data_before, total = parts[:group.rank].sum(0), parts.sum(0)
    else:
        parts = _gather(mine, group, torch.distributed.get_world_size(group))
        data_before = parts[:torch.distributed.get_rank(group)].sum(0)
        total = parts.sum(0)
    earlier = torch.cumsum(rows, 0) - rows  # this data shard's earlier rows
    return data_before[None] + earlier + before, total


def _sum_prob(prob, group, ring):
    """The gate sums added over the data group and the sp ring, their
    cotangents too (see the module's docstring)."""
    if isinstance(group, IslandMember):
        prob = all_reduce_sum_grad(prob, group)
    elif group is not None:
        prob = _SumOverData.apply(prob, group)
    if ring is not None and ring.size > 1:
        prob = _SumOverData.apply(prob, ring.group)
    return prob


def _route(tokens, router, E: int, top_k: int, factor: float, group, ring=None,
           rows: int = 1):
    """``(dispatch [T, E, C], gates per choice, dispatches per choice, aux)``:
    the router's softmax in float32, the first (and second) choices by
    ``argmax`` (ties to the first index), the seats and the load-balancing
    loss of ``tokens`` ``[T, D]`` (``rows`` rows of ``T/rows`` tokens), over
    the whole batch of the data ``group`` and the sp ``ring`` (see the
    module's docstring)."""
    T = tokens.shape[0]
    island = isinstance(group, IslandMember)
    n = 1 if group is None else group.size if island else torch.distributed.get_world_size(group)
    if ring is not None:
        n *= ring.size
    cap = capacity(T * n, E, factor, top_k)
    gates = torch.softmax(tokens.float() @ router, dim=-1)  # [T, E]
    idx1 = torch.argmax(gates, dim=-1)
    g1 = gates.gather(-1, idx1[:, None])[:, 0]
    onehots = [F.one_hot(idx1, E).float()]
    if top_k == 2:
        idx2 = torch.argmax(gates * (1.0 - onehots[0]), dim=-1)
        g2 = gates.gather(-1, idx2[:, None])[:, 0]
        onehots.append(F.one_hot(idx2, E).float())
    onehots = [o.view(rows, T // rows, E) for o in onehots]
    bases, total = _row_bases(torch.stack([o.sum(1) for o in onehots], 1), group, ring)
    prob = _sum_prob(gates.sum(0), group, ring)
    aux = E * torch.sum(total[0] / (T * n) * (prob / (T * n)))
    d1 = _seats(onehots[0], bases[:, 0], cap)
    if top_k == 1:
        return d1, [g1], [d1], aux
    denom = g1 + g2 + 1e-9
    # Every first choice of the batch is seated before any second choice.
    d2 = _seats(onehots[1], total[0] + bases[:, 1], cap)
    return d1 + d2, [g1 / denom, g2 / denom], [d1, d2], aux


class MoEMLP(nn.Module):
    """A routed expert MLP block, ``x -> x + MoE(x)`` (``residual``) or
    ``MoE(x)``, shape-preserving (reference ``MoEMLP``, the same fields).

    ``x`` is ``[B, S, hidden_size]``; the caller owns any LayerNorm. The
    parameters are float32: ``router`` ``[D, E]`` (applied to the float32
    input, whole on every rank), ``w_in`` ``[E, D, M]`` and ``w_out``
    ``[E, M, D]`` (this rank's ``E/ep_size`` experts and ``M/tp`` columns
    under expert and tensor parallelism; ``forward``'s ``shard_group`` sums
    the ranks' shares). With ``forward``'s ``seq_ring`` (an
    :class:`~distkeras_tpu_torch.parallel.distributed.AxisRing`) ``x`` holds
    this rank's columns of the rows, routed with the other columns'. The
    einsums run in ``dtype`` and GELU is the tanh approximation; the output
    comes back in ``x``'s dtype. ``forward`` returns ``(y, aux_loss)``."""

    def __init__(self, num_experts: int, mlp_dim: int, hidden_size: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.bfloat16,
                 residual: bool = True, router_top_k: int = 1, ep_group=None,
                 ep_size: int = 1):
        super().__init__()
        self.num_experts = int(num_experts)
        self.mlp_dim = int(mlp_dim)
        self.capacity_factor = float(capacity_factor)
        self.dtype = dtype
        self.residual = bool(residual)
        self.router_top_k = int(router_top_k)
        self.ep_group = ep_group
        self.ep_size = int(ep_size)
        E, D, M = self.num_experts, int(hidden_size), self.mlp_dim
        self.router = nn.Parameter(torch.empty(D, E))
        self.w_in = nn.Parameter(torch.empty(E, D, M))
        self.w_out = nn.Parameter(torch.empty(E, M, D))

    def init_weights(self, generator) -> None:
        """flax ``lecun_normal`` on each leaf: the fan-in of ``[..., in,
        out]`` counts every dimension but the last (``D`` for the router,
        ``E·D`` and ``E·M`` for the experts)."""
        for p in (self.router, self.w_in, self.w_out):
            _lecun_normal_(p, p.numel() // p.shape[-1], generator)

    def forward(self, x, shard_group=None, seq_ring=None):
        """``shard_group``: the group that sums the ranks' shares (default:
        the ep group under expert parallelism); ``seq_ring``: the sequence
        split of ``x``'s columns (see the class's docstring). The bert
        layer resolves both from its config at call time."""
        B, S, D = x.shape
        E, k = self.num_experts, self.router_top_k
        if k not in (1, 2):
            raise ValueError(f"router_top_k must be 1 or 2, got {k}")
        ep = self.ep_group is not None and self.ep_size > 1
        if ep and E % self.ep_size:
            raise ValueError(f"num_experts {E} not divisible by ep_size {self.ep_size}")
        if shard_group is None and ep:
            shard_group = self.ep_group
        tokens = x.reshape(B * S, D)
        dispatch, gates, seats, aux = _route(tokens, self.router, E, k, self.capacity_factor,
                                             batch_stats_group(), seq_ring, rows=B)
        moved = tokens
        if ep:
            # This rank's experts: the dispatch and combine slices of its
            # range.
            n = E // self.ep_size
            lo = torch.distributed.get_rank(self.ep_group) * n
            dispatch = dispatch[:, lo:lo + n]
            seats = [d[:, lo:lo + n] for d in seats]
        if shard_group is not None:
            # The gates and the tokens entering this rank's share sum their
            # gradients over the shard group (see the module's docstring).
            gates = [_CopyToEP.apply(g, shard_group) for g in gates]
            moved = _CopyToEP.apply(tokens, shard_group)
        combine = seats[0] * gates[0][:, None, None]
        if k == 2:
            combine = combine + seats[1] * gates[1][:, None, None]
        dt = self.dtype
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), moved.to(dt))
        h = torch.einsum("ecd,edm->ecm", expert_in, self.w_in.to(dt))
        h = F.gelu(h, approximate="tanh")
        expert_out = torch.einsum("ecm,emd->ecd", h, self.w_out.to(dt))
        y = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)
        if shard_group is not None:
            y = _ReduceFromEP.apply(y, shard_group)
        y = y.to(x.dtype).reshape(B, S, D)
        return (x + y if self.residual else y), aux

    @staticmethod
    def reference_forward(params: dict, x, top_k: int = 1):
        """The per-token gather (reference ``MoEMLP.reference_forward``): no
        dispatch tensors and no capacity, so no drops; float32. ``params``
        holds ``router``, ``w_in`` and ``w_out`` (whole)."""
        B, S, D = x.shape
        tokens = x.reshape(-1, D).float()
        gates = torch.softmax(tokens @ params["router"], dim=-1)

        def expert_out(idx):
            h = F.gelu(torch.einsum("td,tdm->tm", tokens, params["w_in"][idx]),
                       approximate="tanh")
            return torch.einsum("tm,tmd->td", h, params["w_out"][idx])

        idx1 = torch.argmax(gates, dim=-1)
        g1 = gates.gather(-1, idx1[:, None])[:, 0]
        if top_k == 1:
            y = expert_out(idx1) * g1[:, None]
        else:
            masked = gates * (1.0 - F.one_hot(idx1, gates.shape[-1]).float())
            idx2 = torch.argmax(masked, dim=-1)
            g2 = gates.gather(-1, idx2[:, None])[:, 0]
            denom = g1 + g2 + 1e-9
            y = expert_out(idx1) * (g1 / denom)[:, None] + expert_out(idx2) * (g2 / denom)[:, None]
        return x + y.reshape(B, S, D).to(x.dtype)
