"""One serving engine over the ranks of a serving mesh.

The reference's sharded engine is one process whose jits see the whole
mesh. Here one process drives one device, so a sharded engine is an SPMD
group: every rank of the mesh builds the same :class:`ServingEngine` from
the same arguments, holding its own shard (``H/tp`` heads and the
``1/tp`` column or row of every split weight; on a pp mesh the layers of
its stage). The rank at the mesh's first position is the **leader**: it
owns the scheduler, the front end, the prefix trie and block allocator,
and every pending operation. The others are **followers**, which run
:meth:`ServingEngine.follow`.

The leader decides; every rank executes. Each device operation of the
engine (a prefill chunk, a decode or speculative tick, an admission
write, an upload of a host array, a block copy, a KV gather or scatter, a
parameter placement) is a *mirrored call*: the leader broadcasts the
operation's name and its host arguments over a gloo control group
(:class:`MeshLink`), then runs it on its shard; each follower receives the
message and runs the same operation on its shard. Inside an operation the
shards meet in the model's own collectives (the tp sums and gathers, the
pp hops), so the order of operations is the order of collectives on
every rank. Device tensors that an earlier operation produced travel as
*handles*: both sides number the outputs of each operation in the same
order, so a handle names the leader's tensor on the leader and the
follower's own shard of it on a follower. Host values (token chunks,
tables, positions, a KVX1 payload's rows) travel by value.

Sampling needs no separate broadcast of tokens: under tp the logits are
gathered whole on every rank (bitwise copies of one another), under pp
the last stage's trunk output is broadcast and every rank applies the
final LayerNorm and the tied head itself; every rank's sampling generator
is seeded alike and draws in the same operations, so every rank holds the
leader's tokens.

Failure: a follower whose operation raises writes its error to the
process group's store and leaves the group; the leader's next collective
fails, and the leader raises :class:`MeshRankError` with the follower's
message, which ends the engine's tick with that typed error.
:meth:`MeshLink.close` broadcasts a stop message that ends every
follower's loop.

:class:`StagedDecode` is the decode module of a pp stage: the stage's
layers, the hops between stages (:func:`~distkeras_tpu_torch.parallel.distributed.pp_exchange`),
the broadcast of the last stage's output and the head on every rank, and
with ``micro_batches > 1`` the decode batch split into micro-batches that
flow through the stages in a GPipe schedule.
"""

from __future__ import annotations

import datetime
import pickle
import threading
import time
import weakref

import numpy as np
import torch

from distkeras_tpu_torch.serving.scheduler import ServingError
from distkeras_tpu_torch.telemetry.spans import span

__all__ = ["MeshLink", "MeshRankError", "StagedDecode", "local_params"]

_STOP = "__stop__"
_ERROR_KEY = "distkeras_serving_mesh_error"
# One broadcast carries a message up to this size; a longer one takes a
# second broadcast of the rest.
_HEAD_BYTES = 4096


class MeshRankError(ServingError):
    """A rank of a sharded engine failed: its error, as the rank raised
    it."""

    code = "mesh_rank_failed"


class _Tree(dict):
    """A dict that takes weak references: a registered cache or
    parameter dict."""


def _registrable(obj):
    """``obj`` as the engine should hold it after a mirrored call: a dict
    in a weak-referencable subclass."""
    if isinstance(obj, dict) and not isinstance(obj, _Tree):
        return _Tree(obj)
    return obj


def _store():
    try:
        return torch.distributed.distributed_c10d._get_default_store()
    except Exception:  # pragma: no cover - a group without a store
        return None


class MeshLink:
    """The control plane of a sharded engine: the leader's mirrored calls
    and the followers' loop (see the module docstring). ``ranks``: the
    mesh's ranks, the first one the leader; they must be the whole process
    group, every rank of which builds its link together."""

    def __init__(self, ranks, device):
        dist = torch.distributed
        self.ranks = [int(r) for r in ranks]
        self.rank = dist.get_rank()
        self.leader = self.ranks[0]
        self.is_leader = self.rank == self.leader
        self.device = device
        # The control group is gloo over the host whatever the data
        # plane's backend, so a message never waits on the device; a
        # follower may wait for the next one as long as the server idles.
        self.group = dist.new_group(self.ranks, backend="gloo",
                                    timeout=datetime.timedelta(days=30))
        self._local: dict = {}
        self._engine = None
        self._roots: tuple = ()
        self._sent: dict = {}
        self._ids: dict = {}       # follower: id(obj) -> handle
        self._lock = threading.RLock()
        self._nested = 0
        self._next = 0
        self._by_id: dict = {}     # leader: id(obj) -> (handle, weakref)
        self._objs: dict = {}      # follower: handle -> object
        self._freed: list = []
        self.active = False
        self.closed = False
        self.ops = 0
        self.bytes_sent = 0
        self.control_s = 0.0

    # -- registration ---------------------------------------------------------
    def bind(self, obj, names, roots=()) -> None:
        """Make each method or callable attribute ``names`` of ``obj`` a
        mirrored call on the leader, and the follower's operation of that
        name. Wraps outermost, so each rank's own wrappers (the recompile
        auditor) run on every rank. ``roots``: the attributes of ``obj``
        that hold device state; they are registered now, each message
        carries the handles of those the leader reassigned since its last
        one (so a follower's attributes name its own current shards), and
        after every operation each rank registers the ones the operation
        itself reassigned."""
        self._engine = obj
        self._roots = tuple(roots)
        self._sent = {}
        self.register(*(getattr(obj, name, None) for name in self._roots))
        for name in names:
            local = getattr(obj, name)
            self._local[name] = local
            if self.is_leader:
                setattr(obj, name, self._mirrored(name, local))

    def register(self, *objs) -> None:
        """Number ``objs`` as the next handles; every rank registers the
        same objects (its own shards of them) in the same order."""
        for obj in objs:
            h = self._next
            self._next += 1
            if obj is None or not isinstance(obj, (torch.Tensor, _Tree)):
                continue
            if self.is_leader:
                self._by_id[id(obj)] = (h, weakref.ref(obj))
                weakref.finalize(obj, self._gone, h, id(obj))
            else:
                self._objs[h] = obj
                self._ids[id(obj)] = h

    def _handle(self, obj):
        """The handle ``obj`` is registered under on this rank, or None."""
        if self.is_leader:
            hit = self._by_id.get(id(obj))
            return hit[0] if hit is not None and hit[1]() is obj else None
        h = self._ids.get(id(obj))
        return h if h is not None and self._objs.get(h) is obj else None

    def _state(self) -> dict:
        """Leader: the root attributes reassigned since the last message,
        by handle."""
        out = {}
        for name in self._roots:
            h = self._handle(getattr(self._engine, name, None))
            if h is not None and self._sent.get(name) != h:
                out[name] = self._sent[name] = h
        return out

    def _adopt_roots(self) -> None:
        """After an operation, on every rank: register the root attributes
        the operation reassigned (each rank's own, in one order)."""
        for name in self._roots:
            obj = getattr(self._engine, name, None)
            if obj is not None and self._handle(obj) is None:
                obj = _registrable(obj)
                setattr(self._engine, name, obj)
                self.register(obj)

    def _gone(self, h: int, key: int) -> None:
        """A registered object died on the leader: the followers drop
        their handle with the next message."""
        self._freed.append(h)
        hit = self._by_id.get(key)
        if hit is not None and hit[0] == h:
            del self._by_id[key]

    def _register_out(self, out):
        if isinstance(out, tuple):
            out = tuple(_registrable(o) for o in out)
            self.register(*out)
        else:
            out = _registrable(out)
            self.register(out)
        return out

    def _encode(self, x):
        if isinstance(x, (torch.Tensor, _Tree)):
            hit = self._by_id.get(id(x))
            if hit is not None and hit[1]() is x:
                return ("h", hit[0])
        if isinstance(x, torch.Tensor):
            t = x.detach()
            return ("t", t.cpu(), t.device.type != "cpu")
        if isinstance(x, dict):
            return ("d", {k: self._encode(v) for k, v in x.items()})
        if isinstance(x, (list, tuple)):
            return ("l" if isinstance(x, list) else "u", [self._encode(v) for v in x])
        return ("v", x)

    def _decode(self, x):
        kind = x[0]
        if kind == "h":
            return self._objs[x[1]]
        if kind == "t":
            return x[1].to(self.device) if x[2] else x[1]
        if kind == "d":
            return {k: self._decode(v) for k, v in x[1].items()}
        if kind in ("l", "u"):
            items = [self._decode(v) for v in x[1]]
            return items if kind == "l" else tuple(items)
        return x[1]

    # -- messages -------------------------------------------------------------
    def _send(self, msg) -> None:
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        n = len(data)
        head = torch.zeros(_HEAD_BYTES, dtype=torch.uint8)
        head[:8] = torch.tensor([n], dtype=torch.int64).view(torch.uint8)
        first = min(n, _HEAD_BYTES - 8)
        head[8:8 + first] = torch.frombuffer(bytearray(data[:first]), dtype=torch.uint8)
        t0 = time.monotonic()
        with span("mesh_plan", bytes=n):
            torch.distributed.broadcast(head, self.leader, group=self.group)
            if n > first:
                rest = torch.frombuffer(bytearray(data[first:]), dtype=torch.uint8)
                torch.distributed.broadcast(rest, self.leader, group=self.group)
        self.control_s += time.monotonic() - t0
        self.ops += 1
        self.bytes_sent += n

    def _recv(self):
        head = torch.empty(_HEAD_BYTES, dtype=torch.uint8)
        torch.distributed.broadcast(head, self.leader, group=self.group)
        n = int(head[:8].view(torch.int64)[0])
        first = min(n, _HEAD_BYTES - 8)
        data = bytes(head[8:8 + first].numpy())
        if n > first:
            rest = torch.empty(n - first, dtype=torch.uint8)
            torch.distributed.broadcast(rest, self.leader, group=self.group)
            data += bytes(rest.numpy())
        return pickle.loads(data)

    def _mirrored(self, name, local):
        def call(*args, **kwargs):
            if not self.active or self._nested:
                # Construction runs the same code on every rank, and an
                # operation's nested operations run on every rank inside
                # it: neither is announced.
                return local(*args, **kwargs)
            if self.closed:
                raise RuntimeError(f"{name}: the serving mesh is closed (its followers "
                                   f"have left)")
            with self._lock:
                freed, self._freed = self._freed, []
                try:
                    self._send((name, self._encode(args), self._encode(kwargs), freed,
                                self._state()))
                    self._nested += 1
                    try:
                        out = local(*args, **kwargs)
                    finally:
                        self._nested -= 1
                    self._adopt_roots()
                except MeshRankError:
                    raise
                except Exception as e:
                    self._raise_rank_error(e)
                    raise
                return self._register_out(out)

        call.__name__ = name
        call.__wrapped__ = local
        return call

    def _raise_rank_error(self, cause) -> None:
        """Raise the error a follower reported, if one did."""
        store = _store()
        if store is None:
            return
        try:
            if store.check([_ERROR_KEY]):
                msg = store.get(_ERROR_KEY).decode()
                raise MeshRankError(msg) from cause
        except MeshRankError:
            raise
        except Exception:
            return

    # -- the follower ---------------------------------------------------------
    def follow(self) -> int:
        """Run operations as the leader sends them until its stop message;
        returns how many ran. An operation that raises reports its error
        through the store, leaves the process group and re-raises."""
        done = 0
        while True:
            name, args, kwargs, freed, state = self._recv()
            if name == _STOP:
                return done
            for attr, h in state.items():
                setattr(self._engine, attr, self._objs[h])
            try:
                out = self._local[name](*self._decode(args), **self._decode(kwargs))
                self._adopt_roots()
            except BaseException as e:
                store = _store()
                if store is not None:
                    store.set(_ERROR_KEY, f"rank {self.rank} failed in {name}: {e!r}")
                torch.distributed.destroy_process_group()
                raise
            self._register_out(out)
            for h in freed:
                obj = self._objs.pop(h, None)
                if obj is not None and self._ids.get(id(obj)) == h:
                    del self._ids[id(obj)]
            done += 1

    def close(self) -> None:
        """Leader: end every follower's loop (idempotent)."""
        if self.is_leader and not self.closed:
            with self._lock:
                self._send((_STOP, None, None, [], {}))
        self.closed = True

    def stats(self) -> dict:
        return {"ops": self.ops, "bytes": self.bytes_sent,
                "control_s": round(self.control_s, 9)}


def _is_cache(name: str) -> bool:
    """True for a decode cache leaf's name (``pos_index``, a layer's
    ``cached_key``/``cached_value``/``cache_index`` or its pools)."""
    return name == "pos_index" or name.rsplit(".", 1)[-1] in (
        "cached_key", "cached_value", "cache_index", "pool_key", "pool_value")


def local_params(variables: dict, mesh, model_axes, plan=None, stage: int = 0,
                 device="cpu") -> dict:
    """This rank's share of the whole flat weights ``variables`` on a
    serving mesh: its stage's leaves under ``plan`` (every stage keeps the
    head's ``token_embed``, ``ln_final`` and ``mlm_bias``: each rank applies
    the head to the broadcast trunk output), each cut to this rank's tp
    shard by the model's logical axes."""
    from distkeras_tpu_torch.parallel.gspmd import place_sharded
    from distkeras_tpu_torch.parallel.sharding import infer_variable_shardings

    if plan is not None:
        head = ("token_embed", "ln_final", "mlm_bias")
        own = plan.split_params(variables)[stage]
        variables = {k: v for k, v in variables.items()
                     if k in own or k.split(".", 1)[0] in head}
    shardings = infer_variable_shardings(mesh, variables, model_axes)
    return place_sharded(variables, shardings, device)


class StagedDecode:
    """The decode module of pipeline stage ``stage`` on a serving mesh,
    with :class:`~distkeras_tpu_torch.models.core.Model`'s ``apply``:
    every rank of the pp group calls it together with the same arguments
    and gets the whole model's logits (or, ``return_hidden``, its trunk
    output) and its own stage's new cache.

    The first stage embeds and runs its layers; each later stage takes
    the previous stage's activation over ``pp_exchange``; the last
    stage's trunk output is broadcast over the pp group and every rank
    applies the final LayerNorm and the tied head. With ``micro_batches``
    M above 1 a batch of ``slots`` rows (a decode tick) splits into M
    micro-batches that go through the stages in a GPipe schedule: at tick
    ``t`` stage ``s`` runs micro-batch ``t - s``, so stage ``s`` works on
    micro-batch ``m`` while stage ``s + 1`` works on ``m - 1``. Rows are
    independent, so the logits are those of one batch. Each micro-batch's
    span from the first stage to the broadcast feeds ``bubble`` (a
    :class:`~distkeras_tpu_torch.serving.metrics.BubbleTracker`) on the
    leader."""

    def __init__(self, model, cfg, plan, stage: int, mesh, *, slots: int,
                 micro_batches: int = 1, bubble=None, device="cpu"):
        from distkeras_tpu_torch.parallel.distributed import axis_ring, pp_join

        self.model = model
        self.cfg = cfg
        self.plan = plan
        self.stage = int(stage)
        self.ring = axis_ring(mesh, "pp")
        self.slots = int(slots)
        self.micro_batches = int(micro_batches)
        self.bubble = bubble
        where = list(np.argwhere(mesh.devices == torch.distributed.get_rank())[0])
        where[mesh.axis_names.index("pp")] = plan.num_stages - 1
        self.last_rank = int(mesh.devices[tuple(where)])
        # NCCL wants a group's first batched P2P to involve all its ranks;
        # a tick's hops join neighbours only.
        pp_join(self.ring, device)

    def _exchange(self, out, like):
        from distkeras_tpu_torch.parallel.distributed import pp_exchange

        if out is None and like is None:
            return None
        got, _ = pp_exchange(self.ring, to_next=out, from_prev=like)
        return got

    def _broadcast(self, x, like):
        """The last stage's ``x`` on every rank of the pp group (through
        the host under gloo, which broadcasts host tensors)."""
        dist = torch.distributed
        buf = x if x is not None else torch.empty(like.shape, dtype=like.dtype,
                                                  device=like.device)
        staged = buf.is_cuda and dist.get_backend(self.ring.group) == "gloo"
        with span("pp_broadcast", bytes=buf.numel() * buf.element_size()):
            host = buf.cpu() if staged else buf.contiguous()
            dist.broadcast(host, self.last_rank, group=self.ring.group)
        return host.to(like.device) if staged else host

    def apply(self, variables, x, positions=None, block_tables=None,
              return_hidden: bool = False):
        lo, hi, first, last = self.plan.stage_arg(self.stage)
        cfg = self.cfg
        B, S = x.shape[0], x.shape[1]
        M = self.micro_batches if B == self.slots and B % self.micro_batches == 0 else 1
        b = B // M
        paged = cfg.paged_blocks > 0
        cache = {k: v for k, v in variables.items() if _is_cache(k)}
        params = {k: v for k, v in variables.items() if k not in cache}
        like = torch.empty((b, S, cfg.hidden_size), dtype=cfg.dtype, device=x.device)
        outs: list = [None] * M
        caches: list = [None] * M
        starts: list = [None] * M
        inbox = None
        record = self.bubble is not None and B == self.slots
        for t in range(M + self.plan.num_stages - 1):
            m = t - self.stage
            act = None
            if 0 <= m < M:
                rows = slice(m * b, (m + 1) * b)
                starts[m] = time.monotonic()
                sub = dict(cache) if paged else {k: v[rows] for k, v in cache.items()}
                kw = {}
                if positions is not None:
                    kw["positions"] = positions[rows]
                if block_tables is not None:
                    kw["block_tables"] = block_tables[rows]
                inp = x[rows] if first else inbox
                act, new = self.model.apply({**params, **sub}, inp,
                                            stage=(lo, hi, first, False), **kw)
                if paged:
                    cache.update(new)
                caches[m] = new
                if last:
                    outs[m] = act
            # Hops: this stage's micro-batch to the next stage, the previous
            # stage's (micro-batch m + 1 here) from it.
            nxt = t + 1 - self.stage
            inbox = self._exchange(act if not last else None,
                                   like if not first and 0 <= nxt < M else None)
            mo = t - (self.plan.num_stages - 1)
            if 0 <= mo < M:
                outs[mo] = self._broadcast(outs[mo] if last else None, like)
                if record and starts[mo] is not None:
                    self.bubble.record(starts[mo], time.monotonic(), self.plan.num_stages)
        hidden = outs[0] if M == 1 else torch.cat(outs, dim=0)
        if paged:
            new_cache = caches[-1]
        elif M == 1:
            new_cache = caches[0]
        else:
            new_cache = {k: torch.cat([c[k] for c in caches], dim=0) for k in caches[0]}
        if return_hidden:
            return hidden, new_cache
        L = self.plan.num_layers
        logits, _ = self.model.apply(params, hidden, stage=(L, L, False, True))
        return logits, new_cache
