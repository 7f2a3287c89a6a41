"""Async optimization protocols as update rules over host trees.

Counterpart of ``distkeras_tpu/parallel/protocols.py``, rule for rule. Each
protocol is a small strategy object:

- ``server_commit(center, num_updates, payload) -> (center, num_updates)``:
  the single-owner PS state transition (no locks needed by construction);
- ``worker_begin(client, params)`` / ``worker_window(params, carry,
  client)``: the per-``communication_window`` exchange each worker runs
  between stretches of local train steps.

DOWNPOUR   the worker pushes the delta accumulated over the window, then
           pulls the fresh center; the server applies ``center += delta``.
ADAG       the same worker; the server applies ``center += delta / N``.
AEASGD     elastic averaging: the force ``e = rho * lr * (local - center)``
           moves the worker by ``-e`` and the center by ``+e``.
EAMSGD     AEASGD plus a Nesterov trace on the local update.
DynSGD     staleness-aware: the server applies ``center += delta /
           (staleness + 1)`` with ``staleness = num_updates - last_update``.

Trees are the port's flat ``dict[str, Tensor]``. The server side works on
host (CPU) trees only: the PS loop never touches CUDA. On the worker side,
``params`` may live on the card; what a worker receives (a center, a force)
comes back as a host tree, and the trainer writes it into the optimizer's
own parameter tensors. The bf16 wire casts are torch CPU casts, which round
to nearest even as ``ml_dtypes`` does, so the wire bytes equal the
reference's.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import uuid

import torch

from distkeras_tpu_torch.ops.losses import NesterovTrace, OptimizerFactory
from distkeras_tpu_torch.utils.pytree import Tree, add, l2, scale, sub, to_host

__all__ = [
    "AsyncProtocol",
    "WorkerCarry",
    "DOWNPOURProtocol",
    "ADAGProtocol",
    "AEASGDProtocol",
    "EAMSGDProtocol",
    "DynSGDProtocol",
]

# High bit of the fused-exchange reply counter: "the PS lost your mirror —
# re-bootstrap with full params" (fits the wire's u64 counter field).
_REBOOTSTRAP = 1 << 63


@dataclasses.dataclass
class WorkerCarry:
    """Per-worker protocol bookkeeping between windows. ``window_start`` is
    always the tree the exchange handed back as the worker's new params, so
    a trainer that places that tree on the card may put the placed copy
    here in its stead."""

    window_start: Tree | None = None  # params snapshot at window start
    last_update: int = 0  # DynSGD: server counter seen at last pull
    worker_id: str = ""  # elastic family: keys the server-side mirror
    mirror: Tree | None = None  # elastic family: shared worker/PS mirror


class AsyncProtocol:
    """Base strategy. Subclasses override the hooks below."""

    name = "async"

    def __init__(self, communication_window: int = 5):
        self.communication_window = int(communication_window)

    # -- server side (runs inside the single-owner PS loop) ------------------

    def server_commit(self, center: Tree, num_updates: int, payload: dict,
                      num_workers: int) -> tuple[Tree, int]:
        raise NotImplementedError

    def server_commit_pull(self, center: Tree, num_updates: int, payload: dict,
                           num_workers: int) -> tuple[Tree, int, tuple[Tree, int]]:
        """Fused exchange: apply the commit and produce the reply in one PS
        transition. ``reply = (tree, counter)`` is what the committing worker
        receives: by default the fresh post-commit center."""
        new_center, new_n = self.server_commit(center, num_updates, payload, num_workers)
        return new_center, new_n, (new_center, new_n)

    def server_duplicate_reply(self, center: Tree, num_updates: int,
                               payload: dict) -> tuple[Tree, int]:
        """Reply for a fused exchange whose commit was already applied (a
        retried ``commit_pull`` caught by the PS dedupe window): nothing is
        re-applied, but the worker still needs an answer."""
        return center, num_updates

    # -- health telemetry ----------------------------------------------------

    def commit_stats(self, center: Tree, num_updates: int, payload: dict,
                     num_workers: int) -> dict:
        """Health accounting for ONE commit against the PRE-commit PS state:
        ``staleness`` (``num_updates - last_update``), ``damping`` (the mass
        factor this protocol applies), ``update_norm`` (L2 of the committed
        update) and, for the elastic family, ``divergence``."""
        out: dict = {"damping": 1.0}
        last = payload.get("last_update")
        if last is not None:
            out["staleness"] = max(0, num_updates - int(last))
        if "delta" in payload:
            out["update_norm"] = l2(payload["delta"])
        return out

    # -- worker side ---------------------------------------------------------

    def local_optimizer(self, base: OptimizerFactory) -> OptimizerFactory:
        """Hook for protocols that modify the local update rule (EAMSGD)."""
        return base

    def worker_begin(self, client, params) -> tuple[Tree, WorkerCarry]:
        """Initial pull: start every worker from the shared center."""
        center, num_updates = client.pull()
        return center, WorkerCarry(window_start=center, last_update=num_updates)

    def worker_window(self, params: Tree, carry: WorkerCarry,
                      client) -> tuple[Tree, WorkerCarry]:
        raise NotImplementedError


def _device_delta(params: Tree, base: Tree) -> Tree:
    """Whole-tree ``params - base`` as one ``torch._foreach_sub`` on the
    current stream: the window's delta, computed where the weights live."""
    keys = list(params)
    with torch.no_grad():
        out = torch._foreach_sub([params[k].detach() for k in keys],
                                 [base[k] for k in keys])
    return dict(zip(keys, out))


def _wire_bf16(tree: Tree) -> Tree:
    """Cast wide float leaves to bfloat16 for the wire (half of f32 bytes);
    everything else ships unchanged. A host cast that rounds to nearest
    even, as ``ml_dtypes`` and XLA do."""
    return {k: v.to(torch.bfloat16) if v.is_floating_point() and v.element_size() > 2 else v
            for k, v in tree.items()}


def _wire_f32(tree: Tree) -> Tree:
    """Upcast bf16 wire leaves back to float32 (exact: bf16 is a prefix of
    f32); other leaves pass through."""
    return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in tree.items()}


class _DeltaWindowMixin:
    """Commit the window's accumulated delta and receive the fresh center in
    one fused exchange (the DOWNPOUR/ADAG/DynSGD worker cadence). Falls back
    to separate commit + pull round trips for clients without
    ``commit_pull``."""

    def worker_window(self, params, carry, client):
        delta = _device_delta(params, carry.window_start)
        payload = {"delta": delta, "last_update": carry.last_update}
        fused = getattr(client, "commit_pull", None)
        if fused is not None:
            center, num_updates = fused(payload)
        else:
            client.commit(payload)
            center, num_updates = client.pull()
        return center, WorkerCarry(window_start=center, last_update=num_updates)


class DOWNPOURProtocol(_DeltaWindowMixin, AsyncProtocol):
    """Dean et al. Downpour SGD (reference ``DOWNPOUR`` trainer +
    ``DeltaParameterServer``)."""

    name = "downpour"

    def server_commit(self, center, num_updates, payload, num_workers):
        return add(center, payload["delta"]), num_updates + 1


class ADAGProtocol(_DeltaWindowMixin, AsyncProtocol):
    """Accumulated-gradient normalization (reference ``ADAG`` trainer +
    ``ADAGParameterServer``): commit scaled by 1/num_workers."""

    name = "adag"

    def __init__(self, communication_window: int = 12):
        super().__init__(communication_window)

    def server_commit(self, center, num_updates, payload, num_workers):
        scaled = scale(payload["delta"], 1.0 / max(1, num_workers))
        return add(center, scaled), num_updates + 1

    def commit_stats(self, center, num_updates, payload, num_workers):
        out = super().commit_stats(center, num_updates, payload, num_workers)
        out["damping"] = 1.0 / max(1, num_workers)
        return out


class AEASGDProtocol(AsyncProtocol):
    """Asynchronous Elastic Averaging SGD (reference ``AEASGD`` trainer).

    Wire format of the fused exchange: a worker's first window bootstraps by
    shipping its full-precision ``local`` params; every later window ships
    only ``bf16(local - mirror)``, where ``mirror`` is a per-worker tree
    kept **bit-identically** on both sides (both advance it as
    ``mirror + f32(diff) - f32(e)`` from the very bytes that crossed the
    wire, rounded to ``mirror_dtype`` by the same cast). The PS rebuilds
    ``local ≈ mirror + diff``, computes the force against the center it
    owns, applies ``center += e`` and replies ``bf16(e)``. The PS keeps at
    most ``max(2N, 4)`` mirrors and ``max(4N, 8)`` recorded replies, each
    LRU-bounded on its own (:meth:`host_state_budget`). Over an in-process
    client (``wire_is_local``) none of this runs: the worker ships its
    full-precision params and the PS keeps no per-worker state.
    """

    name = "aeasgd"

    def __init__(self, communication_window: int = 32, rho: float = 5.0,
                 learning_rate: float = 0.1, mirror_dtype: str = "bfloat16"):
        super().__init__(communication_window)
        self.rho = float(rho)
        self.learning_rate = float(learning_rate)
        if mirror_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"mirror_dtype must be bfloat16|float32, got {mirror_dtype!r}")
        self.mirror_dtype = mirror_dtype
        # Server-side per-worker state, touched only by the single-owner PS
        # loop: the shared mirror tree and the last fused reply (replayed
        # verbatim for a deduped retry). Each is LRU-bounded on its own: a
        # reply must outlive its mirror, or a lost-reply retry after an
        # eviction would be told "nothing applied" when the commit did move
        # the center.
        self._mirrors: collections.OrderedDict[str, Tree] = collections.OrderedDict()
        self._last_reply: collections.OrderedDict[str, tuple] = collections.OrderedDict()
        # Consume-once memo handing commit_stats' reconstruction of the
        # worker's params to the server_commit_pull that follows it.
        self._local_memo: tuple | None = None

    def server_commit(self, center, num_updates, payload, num_workers):
        return add(center, payload["delta"]), num_updates + 1

    def _elastic(self, local, center):
        alpha = self.rho * self.learning_rate
        return scale(sub(local, center), alpha)

    def _round_mirror(self, tree):
        """Round a freshly advanced mirror to the storage dtype: the ONE
        cast both sides share; any asymmetry here would split the mirrors."""
        return _wire_bf16(tree) if self.mirror_dtype == "bfloat16" else tree

    def _local_of(self, payload):
        """The committing worker's local params (bootstrap ``local``, or
        mirror + ``elastic_diff``); None when the mirror is gone. One host
        pass, shared with the server_commit_pull that follows commit_stats
        through a consume-once memo."""
        memo, self._local_memo = self._local_memo, None
        if memo is not None and memo[0] is payload:
            return memo[1]
        if "elastic_diff" in payload:
            wid = payload.get("worker_id")
            if wid not in self._mirrors:
                return None
            return add(_wire_f32(self._mirrors[wid]), _wire_f32(payload["elastic_diff"]))
        if "local" in payload:
            return to_host(payload["local"])
        return None

    def commit_stats(self, center, num_updates, payload, num_workers):
        """Elastic health: ``divergence = ||local - center||_2`` against the
        pre-commit center, and the force's norm ``alpha * divergence`` as
        the update mass."""
        out = super().commit_stats(center, num_updates, payload, num_workers)
        local = self._local_of(payload)
        if local is not None:
            self._local_memo = (payload, local)
            divergence = l2(sub(local, center))
            out["divergence"] = divergence
            out["update_norm"] = self.rho * self.learning_rate * divergence
        return out

    def host_state_budget(self, n_params: int, num_workers: int) -> int:
        """Worst-case PS host bytes of the per-worker state: ``max(2N, 4)``
        mirrors (in ``mirror_dtype``) + ``max(4N, 8)`` recorded replies
        (float32 model-sized at worst, a bootstrap reply)."""
        mirror_bytes = 2 if self.mirror_dtype == "bfloat16" else 4
        mirrors = max(2 * int(num_workers), 4) * mirror_bytes * n_params
        replies = max(4 * int(num_workers), 8) * 4 * n_params
        return mirrors + replies

    def server_commit_pull(self, center, num_updates, payload, num_workers):
        wid = payload.get("worker_id")
        if "elastic_diff" in payload:
            local_est = self._local_of(payload)
            if local_est is None:
                # Mirror lost (PS restart, or LRU eviction): apply nothing
                # and flag a re-bootstrap. Nothing is recorded: a deduped
                # retry rebuilds the same flagged zero reply from its own
                # payload in server_duplicate_reply.
                zero = scale(payload["elastic_diff"], 0.0)  # stays bf16: unread
                return center, num_updates, (zero, _REBOOTSTRAP | num_updates)
            e_wire = _wire_bf16(self._elastic(local_est, center))
            e = _wire_f32(e_wire)
            self._set_mirror(wid, self._round_mirror(sub(local_est, e)), num_workers)
            reply = (e_wire, num_updates)
            self._set_reply(wid, reply, num_workers)
            return add(center, e), num_updates + 1, reply
        if "local" in payload:
            local = self._local_of(payload)
            e = self._elastic(local, center)
            reply = (e, num_updates)
            if wid is not None:
                self._set_mirror(wid, self._round_mirror(sub(local, e)), num_workers)
                self._set_reply(wid, reply, num_workers)
            return add(center, e), num_updates + 1, reply
        new_center, new_n = self.server_commit(center, num_updates, payload, num_workers)
        return new_center, new_n, (new_center, new_n)

    def _set_mirror(self, wid, mirror, num_workers):
        """Store a worker's mirror, LRU-evicting beyond 2×num_workers (worker
        ids are per incarnation, so churn would otherwise grow this without
        bound); an evicted live worker re-bootstraps next window. Replies
        are not evicted here."""
        self._mirrors[wid] = mirror
        self._mirrors.move_to_end(wid)
        bound = max(2 * int(num_workers), 4)
        while len(self._mirrors) > bound:
            self._mirrors.popitem(last=False)

    def _set_reply(self, wid, reply, num_workers):
        """Record the fused reply for dedupe replay, LRU-bounded on its own
        clock at twice the mirror bound; every replay refreshes it."""
        self._last_reply[wid] = reply
        self._last_reply.move_to_end(wid)
        bound = max(4 * int(num_workers), 8)
        while len(self._last_reply) > bound:
            self._last_reply.popitem(last=False)

    def server_duplicate_reply(self, center, num_updates, payload):
        # The original reply was lost after the commit applied: replay the
        # recorded answer (the mirror already advanced, so recomputing the
        # force would double-count the diff).
        wid = payload.get("worker_id")
        if wid in self._last_reply and ("local" in payload or "elastic_diff" in payload):
            self._last_reply.move_to_end(wid)
            return self._last_reply[wid]
        if "local" in payload:
            return self._elastic(to_host(payload["local"]), center), num_updates
        if "elastic_diff" in payload:
            # No recorded reply: never hand back the raw center (the worker
            # would subtract it as the force); flag a re-bootstrap.
            zero = scale(payload["elastic_diff"], 0.0)  # stays bf16: unread
            return zero, _REBOOTSTRAP | num_updates
        return center, num_updates

    def worker_window(self, params, carry, client):
        """The worker's side. Its arithmetic runs on the host copy ``local``
        of the params (bit-equal to them), and the new params come back as
        a host tree."""
        fused = getattr(client, "commit_pull", None)
        if fused is not None and getattr(client, "wire_is_local", False):
            # In-process transport: bytes are free and replies cannot be
            # lost, so ship the full-precision local tree with no worker_id;
            # the PS keeps no per-worker bookkeeping.
            local = to_host(params)
            e, num_updates = fused({"local": local, "last_update": carry.last_update})
            new_params = sub(local, _wire_f32(e))
            return new_params, WorkerCarry(window_start=new_params, last_update=num_updates)
        if fused is not None:
            wid = carry.worker_id or uuid.uuid4().hex
            local = to_host(params)
            if carry.mirror is None:
                # Bootstrap window: full-precision local; both sides then
                # hold the identical mirror ``local - e``.
                e, num_updates = fused({"local": local, "worker_id": wid,
                                        "last_update": carry.last_update})
                e = _wire_f32(e)
                mirror = self._round_mirror(sub(local, e))
            else:
                diff_wire = _wire_bf16(sub(local, _wire_f32(carry.mirror)))
                e_wire, num_updates = fused({"elastic_diff": diff_wire, "worker_id": wid,
                                             "last_update": carry.last_update})
                if num_updates & _REBOOTSTRAP:
                    # The PS lost the mirror; nothing was applied. Skip this
                    # window's exchange and re-bootstrap on the next one.
                    return local, WorkerCarry(window_start=local,
                                              last_update=num_updates & ~_REBOOTSTRAP,
                                              worker_id=wid, mirror=None)
                e = _wire_f32(e_wire)
                # Advance the shared mirror from the wire bytes: the same
                # arithmetic, order and storage rounding as the PS.
                mirror = self._round_mirror(
                    sub(add(_wire_f32(carry.mirror), _wire_f32(diff_wire)), e))
            new_params = sub(local, e)
            return new_params, WorkerCarry(window_start=new_params, last_update=num_updates,
                                           worker_id=wid, mirror=mirror)
        center, num_updates = client.pull()
        local = to_host(params)
        elastic = self._elastic(local, center)
        new_params = sub(local, elastic)
        client.commit({"delta": elastic, "last_update": num_updates})
        return new_params, WorkerCarry(window_start=new_params, last_update=num_updates)


class EAMSGDProtocol(AEASGDProtocol):
    """Elastic Averaging with Momentum SGD (reference ``EAMSGD`` trainer):
    AEASGD's elastic exchange + a Nesterov trace on the local update."""

    name = "eamsgd"

    def __init__(self, communication_window: int = 32, rho: float = 5.0,
                 learning_rate: float = 0.1, momentum: float = 0.9):
        super().__init__(communication_window, rho, learning_rate)
        self.momentum = float(momentum)

    def local_optimizer(self, base):
        """``optax.chain(base, optax.trace(momentum, nesterov=True))``."""
        return functools.partial(NesterovTrace, base=base, decay=self.momentum)


class DynSGDProtocol(_DeltaWindowMixin, AsyncProtocol):
    """Staleness-aware dynamic SGD (reference ``DynSGD`` trainer +
    ``DynSGDParameterServer``): each committed delta is damped by the
    committer's staleness. The PS update counter is owned by the PS loop
    alone, so its read-modify-write is race-free by construction."""

    name = "dynsgd"

    def server_commit(self, center, num_updates, payload, num_workers):
        staleness = max(0, num_updates - int(payload["last_update"]))
        damped = scale(payload["delta"], 1.0 / (staleness + 1))
        return add(center, damped), num_updates + 1

    def commit_stats(self, center, num_updates, payload, num_workers):
        # The SAME damping expression server_commit applies.
        out = super().commit_stats(center, num_updates, payload, num_workers)
        out["damping"] = 1.0 / (out.get("staleness", 0) + 1)
        return out
