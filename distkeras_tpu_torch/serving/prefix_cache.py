"""The dense serving engine's prefix cache: a device-resident pool of
fixed-size KV blocks keyed by a radix trie over prompt prefixes.

Port of the dense half of the reference's
``distkeras_tpu/serving/prefix_cache.py``. Real serving traffic is
dominated by shared prefixes (system prompts, few-shot templates,
multi-turn histories); :class:`PrefixCache` lets admission reuse their
prefill: the K/V rows of previously prefilled prompt prefixes live in a
fixed pool of **blocks** (``block_tokens`` tokens each), keyed by a radix
trie over the prompt's token blocks, and a hit copies the matched blocks
into the request's single-row prefill cache instead of recomputing them.

The trie and the block allocator (:class:`_BlockTrie`, :class:`_Node`,
:class:`PrefixMatch`) are host bookkeeping, copied. The reference's three
jitted device functions are torch index operations on the pool here
(:func:`_store`, :func:`_splice`, :func:`_materialize`): one
``index_copy_`` per KV leaf stores an insert's new blocks, and one
``index_select`` per leaf reads a match back. There is nothing to
compile, so the match ids are not padded to a power-of-two bucket: the
rows past the match stay zeros rather than holding the bucket's garbage,
which the causal mask hid from every read in the reference.

Why sharing is safe: in a causal LM the K/V at position ``p`` depend only
on tokens ``[0, p]``, so two prompts sharing a token prefix share that
prefix's K/V exactly. A block is only ever stored from fully computed
positions and only ever matched by the exact token sequence (trie edges
are the block's token tuple), so a hit cannot alias a different prompt.

:class:`KVBlockPool` is the paged engine's memory manager over the same
trie: the engine's block pools are the paged decode module's cache leaves,
slots address them through block tables, a prefix hit is zero-copy (the
table points at the pinned trie blocks) and a finished or preempted
slot's complete blocks are adopted into the trie in place. It owns no
device tensors and is copied from the reference, with the fleet's
:meth:`KVBlockPool.adopt_foreign` (the receiving half of a KV block
transfer) and the spill hooks the host KV tier attaches to.

NOT thread-safe: the trie and pool are mutated without locks, relying on
the owning :class:`~distkeras_tpu_torch.serving.engine.ServingEngine`'s loop
serializing every call. Do not drive one pool from two concurrently
running engines.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math

import numpy as np
import torch

__all__ = ["KVBlockPool", "PrefixCache", "PrefixMatch"]


def _kv_names(tree: dict) -> list[str]:
    """The K/V leaves of a decode cache (the 1-D index leaves get no
    pooled storage)."""
    return [name for name, leaf in tree.items() if leaf.ndim > 1]


def _ids(rows, pool: dict) -> torch.Tensor:
    """Pool row ids as one int64 tensor on the pool's device."""
    dev = next(iter(pool.values())).device
    return torch.as_tensor(np.asarray(rows, np.int64), device=dev)


@torch.inference_mode()
def _store(block_tokens: int, pool: dict, cache: dict, slots, off0: int) -> None:
    """Copy the ``len(slots)`` consecutive blocks of the single-row
    ``cache`` starting at token ``off0`` into pool rows ``slots``, one
    ``index_copy_`` per leaf (reference ``_store_fn``). An insert's new
    blocks are always a contiguous suffix of the prompt's block chain."""
    n = len(slots)
    ids = _ids(slots, pool)
    for name, p in pool.items():
        c = cache[name]
        blk = c[0, off0:off0 + n * block_tokens]
        blk = blk.reshape((n, block_tokens) + tuple(c.shape[2:]))
        p.index_copy_(0, ids, blk.to(p.dtype))


@torch.inference_mode()
def _splice(block_tokens: int, cache: dict, pool: dict, ids) -> dict:
    """Write pool rows ``ids`` as the cache's token prefix ``[0, len(ids) *
    block_tokens)``, in place (reference ``_splice_fn``, which donates the
    cache); index leaves pass through."""
    n = len(ids)
    idx = _ids(ids, pool)
    for name, p in pool.items():
        c = cache[name]
        blk = p.index_select(0, idx)
        c[:, :n * block_tokens] = blk.reshape((1, n * block_tokens) + tuple(c.shape[2:])).to(c.dtype)
    return cache


@torch.inference_mode()
def _materialize(block_tokens: int, shapes: dict, pool: dict, ids, device) -> dict:
    """A FRESH single-row cache whose token prefix is pool rows ``ids``
    and whose tail and index leaves are zeros (reference
    ``_materialize_fn``): the spliced region is never built as zeros
    first."""
    n = len(ids)
    idx = _ids(ids, pool)
    out = {}
    for name, s in shapes.items():
        if name not in pool:
            out[name] = torch.zeros(s.shape, dtype=s.dtype, device=device)
            continue
        p = pool[name]
        blk = p.index_select(0, idx)
        flat = blk.reshape((1, n * block_tokens) + tuple(s.shape[2:])).to(s.dtype)
        tail = torch.zeros((1, s.shape[1] - n * block_tokens) + tuple(s.shape[2:]),
                           dtype=s.dtype, device=device)
        out[name] = torch.cat([flat, tail], dim=1)
    return out


class _Node:
    """One trie edge = one cached block. Children are keyed by the next
    block's token tuple (exact-match radix trie)."""

    __slots__ = ("slot", "refs", "last_used", "parent", "key", "children")

    def __init__(self, slot: int, parent, key):
        self.slot = slot
        self.refs = 0
        self.last_used = 0
        self.parent = parent
        self.key = key
        self.children: dict = {}


@dataclasses.dataclass
class PrefixMatch:
    """A pinned match: ``release()`` it (via :meth:`PrefixCache.release`)
    once the matched blocks are no longer being read — after the splice
    (dense mode) or when the slot whose table points at them frees/adopts
    (paged mode)."""

    nodes: list
    ids: np.ndarray  # pool slots of the matched chain, int32 [n]
    matched_tokens: int
    released: bool = False


class _BlockTrie:
    """Shared core of both pool classes: the block allocator (free list +
    LRU eviction of unreferenced trie leaves) and the radix trie over
    token blocks (probe/match/release). Subclasses call
    :meth:`_init_trie` and provide ``_note_occupancy``."""

    def _init_trie(self, capacity: int, block_tokens: int) -> None:
        self.block_tokens = int(block_tokens)
        self.capacity = int(capacity)
        self._root = _Node(-1, None, None)
        self._by_slot: dict[int, _Node] = {}
        self._free = list(range(self.capacity - 1, -1, -1))
        self._clock = itertools.count(1)
        # Lazy LRU heap of (last_used, slot): every touch pushes a fresh
        # entry; _alloc pops, discarding entries whose stamp no longer
        # matches the node (stale) — amortized O(log n) eviction instead
        # of scanning every cached block per allocation.
        self._lru: list[tuple[int, int]] = []
        # Host-side stats (exact, source of truth for stats()).
        self.lookups = self.hit_requests = 0
        self.hit_tokens = self.miss_tokens = 0
        self.inserted_blocks = self.evicted_blocks = 0
        self.flushes = 0
        # Bumped whenever blocks become free or evictable — the engine's
        # "is it worth retrying a parked admission" heuristic.
        self.version = 0
        self._metrics: dict | None = None
        # Optional ``hook(chain_tokens, slot)`` called just before an
        # eviction victim's trie node is destroyed — the tiered-KV
        # engine uses it to spill the victim block (D2H) into the host
        # tier. Called while the victim's node is still intact (chain
        # reconstructible) and its pool row still holds the KV bytes.
        self.spill_hook = None
        # Batched variant, ``hook(list[(chain_tokens, slot)])``: when
        # set, multi-block allocation bursts (alloc(n), insert,
        # adopt_foreign) COLLECT their victims and fire one call at the
        # end of the burst — one D2H gather for the whole burst instead
        # of one per victim. The victims' pool rows still hold their KV
        # bytes at flush time: the burst only hands rows out, nothing
        # overwrites them until the caller scatters after the grant.
        # Takes precedence over ``spill_hook`` inside a burst;
        # single-victim paths still use ``spill_hook`` when no burst is
        # open.
        self.spill_many_hook = None
        self._spill_batch: list | None = None  # open burst's victims

    # -- introspection ------------------------------------------------------
    @property
    def blocks_used(self) -> int:
        return self.capacity - len(self._free)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    def debugz(self, top: int = 16) -> dict:
        """Trie occupancy grouped by **prefix family** — the root's
        children, i.e. the distinct first blocks (system prompts,
        templates). Per family: subtree block/token counts, live pins,
        and chain depth, sorted by blocks so the page leads with the
        biggest resident; ``top`` bounds the list (the full family count
        is still reported). The occupancy view ``stats()`` can't give:
        WHICH prompts own the pool, not just how full it is."""
        fams = []
        for key, child in self._root.children.items():
            blocks = refs = depth = 0
            stack = [(child, 1)]
            while stack:
                n, d = stack.pop()
                blocks += 1
                refs += n.refs
                depth = max(depth, d)
                stack.extend((c, d + 1) for c in n.children.values())
            fams.append({
                # First 8 tokens of the family's first block: enough to
                # recognize a system prompt, bounded output regardless
                # of block size.
                "family_head": list(key[:8]),
                "blocks": blocks,
                "tokens": blocks * self.block_tokens,
                "pinned_refs": refs,
                "max_chain_depth": depth,
            })
        fams.sort(key=lambda f: (-f["blocks"], f["family_head"]))
        return {
            "blocks_used": self.blocks_used,
            "capacity_blocks": self.capacity,
            "block_tokens": self.block_tokens,
            "families": len(fams),
            "top_families": fams[:int(top)],
        }

    def flush(self) -> None:
        """Invalidate every cached block at once (weight reload: pooled
        K/V is a function of the weights, so a param swap makes all of it
        wrong). Host bookkeeping only — the device pools stay allocated
        and their rows are simply free to overwrite; cumulative hit/miss
        counters keep counting across the flush. Must be called with no
        reader in flight (no pinned matches and — paged — no slot-owned
        blocks): the engine's swap path guarantees that by running with
        zero active slots; any match object still held afterwards
        releases onto orphaned nodes, harmlessly."""
        self._root = _Node(-1, None, None)
        self._by_slot.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self._lru = []
        self.flushes += 1
        self.version += 1
        if self._metrics is not None:
            self._note_occupancy()

    # -- trie walk ----------------------------------------------------------
    @staticmethod
    def _chain_tokens(node: _Node) -> list:
        """Full root→``node`` token chain, reconstructed by walking the
        parent links (each edge key is one block's token tuple)."""
        keys = []
        while node.parent is not None:
            keys.append(node.key)
            node = node.parent
        out = []
        for key in reversed(keys):
            out.extend(key)
        return out

    def _blocks(self, tokens, n_blocks: int):
        bt = self.block_tokens
        for i in range(n_blocks):
            yield tuple(int(t) for t in tokens[i * bt:(i + 1) * bt])

    def probe(self, tokens) -> int:
        """Matched-token count for ``tokens`` WITHOUT pinning or counting
        — the scheduler's cache-aware admission score."""
        node, matched = self._root, 0
        for key in self._blocks(tokens, self._match_cap(tokens)):
            node = node.children.get(key)
            if node is None:
                break
            matched += self.block_tokens
        return matched

    def _match_cap(self, tokens) -> int:
        # Never match the WHOLE prompt: prefill needs >= 1 uncached token
        # to produce the logits the first sampled token comes from.
        return max(0, (len(tokens) - 1) // self.block_tokens)

    def match(self, tokens) -> PrefixMatch:
        """Longest cached block-chain prefix of ``tokens``, pinned
        (ref-counted) until :meth:`release`."""
        self.lookups += 1
        node, chain = self._root, []
        for key in self._blocks(tokens, self._match_cap(tokens)):
            nxt = node.children.get(key)
            if nxt is None:
                break
            chain.append(nxt)
            node = nxt
        now = next(self._clock)
        for n in chain:
            n.refs += 1
            self._touch(n, now)
        matched = len(chain) * self.block_tokens
        self.hit_tokens += matched
        self.miss_tokens += len(tokens) - matched
        self.hit_requests += bool(chain)
        if self._metrics is not None:
            self._metrics["lookups"].inc()
            self._metrics["hit_tokens"].inc(matched)
            self._metrics["miss_tokens"].inc(len(tokens) - matched)
            if chain:
                self._metrics["hit_requests"].inc()
        return PrefixMatch(
            chain, np.asarray([n.slot for n in chain], np.int32), matched)

    def match_blocks(self, tokens) -> PrefixMatch:
        """Longest cached chain over ALL complete blocks of ``tokens``,
        pinned like :meth:`match` but WITHOUT the last-block holdback
        (:meth:`_match_cap`) and without touching the hit/miss stats —
        this is the EXPORT walk (kv_transfer): a peer adopting the
        chain wants the full resident prefix, and an export lookup is
        not an admission, so it must not skew the cache-efficiency
        series operators alert on."""
        node, chain = self._root, []
        for key in self._blocks(tokens, len(tokens) // self.block_tokens):
            nxt = node.children.get(key)
            if nxt is None:
                break
            chain.append(nxt)
            node = nxt
        now = next(self._clock)
        for n in chain:
            n.refs += 1
            self._touch(n, now)
        return PrefixMatch(
            chain, np.asarray([n.slot for n in chain], np.int32),
            len(chain) * self.block_tokens)

    def release(self, match: PrefixMatch | None) -> None:
        if match is None or match.released:
            return
        match.released = True
        for n in match.nodes:
            n.refs -= 1
        if match.nodes:
            self.version += 1  # pinned chains may have become evictable

    # -- eviction -----------------------------------------------------------
    def _touch(self, node: _Node, now: int) -> None:
        node.last_used = now
        heapq.heappush(self._lru, (now, node.slot))
        if len(self._lru) > 4 * self.capacity:
            # Stale entries are only consumed by _alloc, which a
            # hit-dominated workload (no inserts once warm) never runs —
            # compact to one live entry per node so the heap stays
            # O(capacity) over a long-running server, amortized O(1) per
            # touch (one rebuild per >= 3·capacity pushes).
            self._lru = [(n.last_used, n.slot)
                         for n in self._by_slot.values()]
            heapq.heapify(self._lru)

    def _alloc(self, protect: _Node | None) -> int | None:
        if self._free:
            return self._free.pop()
        victim, skipped = None, []
        while self._lru:
            stamp, slot = heapq.heappop(self._lru)
            n = self._by_slot.get(slot)
            if n is None or n.last_used != stamp:
                continue  # stale: slot was evicted or re-touched since
            if n.refs or n.children or n is protect:
                # Currently unevictable, but may become a leaf later
                # with no further touch — keep its entry alive.
                skipped.append((stamp, slot))
                continue
            victim = n
            break
        for item in skipped:
            heapq.heappush(self._lru, item)
        if victim is None:
            return None  # everything pinned or mid-chain
        if self._spill_batch is not None:
            # Inside a burst: collect the chain NOW (the node is about
            # to be unlinked) and spill at the burst's end in one call.
            self._spill_batch.append(
                (self._chain_tokens(victim), victim.slot))
        elif self.spill_hook is not None:
            # Spill BEFORE the node is unlinked: the hook needs the full
            # root→victim chain and the still-valid pool row. A hook
            # failure must never break allocation — the spill tier is an
            # optimization, the evicted block was always droppable.
            try:
                self.spill_hook(self._chain_tokens(victim), victim.slot)
            except Exception:  # pragma: no cover - defensive
                pass
        del victim.parent.children[victim.key]
        del self._by_slot[victim.slot]
        self.evicted_blocks += 1
        if self._metrics is not None:
            self._metrics["evictions"].inc()
        return victim.slot

    def _begin_spill_burst(self) -> bool:
        """Open a victim-collection burst (no-op without a batched
        hook, or when nested inside an already-open burst). Returns
        whether THIS call opened it — only the opener flushes."""
        if self.spill_many_hook is None or self._spill_batch is not None:
            return False
        self._spill_batch = []
        return True

    def _flush_spill_burst(self) -> None:
        """Fire the batched spill hook over the burst's victims. Runs
        before the allocating call returns, so every victim row still
        holds its KV bytes. Hook failures are swallowed like the
        per-victim hook's — spilling is an optimization."""
        batch, self._spill_batch = self._spill_batch, None
        if batch:
            try:
                self.spill_many_hook(batch)
            except Exception:  # pragma: no cover - defensive
                pass

    def _note_occupancy(self) -> None:  # pragma: no cover - overridden
        pass


class PrefixCache(_BlockTrie):
    """Device-owning block pool + radix trie over prompt prefixes, the
    DENSE engine's prefix cache.

    ``template``: the single-row decode cache (a dict of tensors, or of
    ``meta`` tensors standing for their shapes and dtypes, as the engine's
    ``_row_shapes``): KV leaves ``[1, L, H, D]`` define the pool geometry;
    1-D index leaves get no pooled storage. ``block_tokens``: granularity
    of sharing. ``budget_bytes``: hard cap on pool memory; capacity =
    ``budget_bytes // bytes_per_block`` blocks, allocated up front on
    ``device`` (the template's own device when it is not ``meta``; CUDA
    unless ``"cpu"`` is asked for otherwise). ``registry``: optional
    :class:`~distkeras_tpu_torch.telemetry.registry.MetricsRegistry` for
    the hit/miss/eviction counters and occupancy gauges. ``mesh`` and
    ``stage_meshes`` (the sharded engines' pools) wait for ROADMAP.md §A
    item A10 and raise.
    """

    def __init__(self, template, *, block_tokens: int = 16,
                 budget_bytes: int = 64 * 2**20, registry=None, mesh=None,
                 stage_meshes=None, device=None):
        if mesh is not None or stage_meshes is not None:
            raise NotImplementedError(
                "a sharded prefix cache (mesh/stage_meshes) is not ported yet: it "
                "comes with the multi-device slice (ROADMAP.md §A item A10)")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        kv = _kv_names(template)
        if not kv:
            raise ValueError("cache template has no KV leaves")
        L = template[kv[0]].shape[1]
        if block_tokens > L:
            raise ValueError(
                f"block_tokens={block_tokens} exceeds cache length {L}")
        self.max_blocks = L // int(block_tokens)
        self.bytes_per_block = sum(
            int(block_tokens) * math.prod(template[k].shape[2:])
            * template[k].dtype.itemsize for k in kv)
        capacity = int(budget_bytes) // self.bytes_per_block
        if capacity < 1:
            raise ValueError(
                f"budget_bytes={budget_bytes} holds zero blocks "
                f"(one block = {self.bytes_per_block} bytes)")
        self._init_trie(capacity, block_tokens)
        if device is None:
            leaf = template[kv[0]]
            device = leaf.device if leaf.device.type != "meta" else None
        from distkeras_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self._row_shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                            for k, v in template.items()}
        with torch.inference_mode():
            self._pool = {
                k: torch.zeros((self.capacity, self.block_tokens)
                               + tuple(template[k].shape[2:]),
                               dtype=template[k].dtype, device=self.device)
                for k in kv}
        if registry is not None:
            self._metrics = _register_trie_metrics(registry)
            self._metrics["capacity"].set(self.capacity)

    def stats(self) -> dict:
        total = self.hit_tokens + self.miss_tokens
        return {
            "block_tokens": self.block_tokens,
            "capacity_blocks": self.capacity,
            "blocks_used": self.blocks_used,
            "bytes_used": self.blocks_used * self.bytes_per_block,
            "bytes_per_block": self.bytes_per_block,
            "lookups": self.lookups,
            "hit_requests": self.hit_requests,
            "hit_tokens": self.hit_tokens,
            "miss_tokens": self.miss_tokens,
            "hit_rate": (self.hit_tokens / total) if total else 0.0,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "flushes": self.flushes,
        }

    # -- device ops ---------------------------------------------------------
    def splice(self, cache, ids: np.ndarray):
        """Return ``cache`` with pool rows ``ids`` written as its token
        prefix (in place: the reference donates ``cache``)."""
        return _splice(self.block_tokens, cache, self._pool, ids)

    def materialize(self, ids: np.ndarray):
        """Build a FRESH single-row cache with pool rows ``ids`` as its
        token prefix and zeros past it: the hit path's replacement for
        "allocate a full zeros cache, then splice"."""
        return _materialize(self.block_tokens, self._row_shapes, self._pool, ids,
                            self.device)

    def insert(self, tokens, cache) -> int:
        """Store every complete block of ``tokens`` not already cached,
        copying K/V rows out of the fully-prefilled single-row ``cache``
        in ONE batched device call. Allocation evicts LRU unreferenced
        leaves; when nothing is evictable the insert stops early (the
        chain must stay contiguous). Returns the newly stored count."""
        keys = list(self._blocks(tokens, len(tokens) // self.block_tokens))
        now = next(self._clock)
        node, idx = self._root, 0
        while idx < len(keys):  # walk (and touch) the existing prefix
            child = node.children.get(keys[idx])
            if child is None:
                break
            self._touch(child, now)
            node = child
            idx += 1
        take: list[int] = []
        opened = self._begin_spill_burst()
        try:
            for _ in keys[idx:]:
                slot = self._alloc(protect=node)
                if slot is None:
                    break
                take.append(slot)
        finally:
            if opened:
                self._flush_spill_burst()
        if not take:
            return 0
        n = len(take)
        _store(self.block_tokens, self._pool, cache, take, idx * self.block_tokens)
        for key, slot in zip(keys[idx:idx + n], take):
            child = _Node(slot, node, key)
            node.children[key] = child
            self._by_slot[slot] = child
            self._touch(child, now)
            node = child
        self.inserted_blocks += n
        self.version += 1
        if self._metrics is not None:
            self._metrics["inserts"].inc(n)
            self._note_occupancy()
        return n

    def _note_occupancy(self) -> None:
        self._metrics["used"].set(self.blocks_used)
        self._metrics["bytes"].set(self.blocks_used * self.bytes_per_block)



def _register_trie_metrics(registry) -> dict:
    """The prefix-sharing metric family — shared by both pool classes so
    an operator reads ONE set of hit/miss/eviction series whether the
    engine runs dense (PrefixCache) or paged (KVBlockPool)."""
    return {
        "hit_tokens": registry.counter(
            "prefix_cache_hit_tokens_total",
            help="prompt tokens whose prefill was skipped via the "
                 "prefix cache"),
        "miss_tokens": registry.counter(
            "prefix_cache_miss_tokens_total",
            help="prompt tokens prefilled from scratch"),
        "hit_requests": registry.counter(
            "prefix_cache_hit_requests_total",
            help="lookups matching at least one block"),
        "lookups": registry.counter(
            "prefix_cache_lookups_total", help="prefix lookups"),
        "evictions": registry.counter(
            "prefix_cache_evicted_blocks_total",
            help="blocks evicted (LRU under the byte budget)"),
        "inserts": registry.counter(
            "prefix_cache_inserted_blocks_total",
            help="blocks stored/adopted into the prefix trie"),
        "used": registry.gauge(
            "prefix_cache_blocks_used", help="pool blocks in use"),
        "capacity": registry.gauge(
            "prefix_cache_blocks_capacity",
            help="pool block capacity"),
        "bytes": registry.gauge(
            "prefix_cache_bytes_used", help="pool bytes in use"),
    }


class KVBlockPool(_BlockTrie):
    """Host-side allocator + prefix trie over ONE shared KV block pool —
    the paged engine's single memory manager for decode slots AND the
    prefix cache.

    Unlike :class:`PrefixCache` this class owns NO device tensors: the
    pools (``[capacity, block_tokens, H, D]`` per layer K/V) are the
    paged decode module's cache leaves, which the engine threads through
    its device functions. The pool hands out *row ids*:

    - :meth:`alloc` — take ``n`` private blocks for a slot (all-or-
      nothing; evicts LRU unreferenced trie leaves when the free list is
      dry; ``None`` means the caller must preempt someone or park);
    - :meth:`free` — return private blocks;
    - :meth:`match`/:meth:`release` — pin/unpin a shared prefix chain
      (the slot's block table points at the pinned rows, zero-copy);
    - :meth:`adopt` — a finished/preempted slot's complete blocks become
      trie nodes in place (zero-copy prefix-cache insert); already-
      cached duplicates are freed instead.

    Write-sharing is impossible by construction (block-aligned matches;
    appends go to private blocks), so the copy-on-write refcount's only
    job is to keep shared rows from being evicted/reallocated under a
    reader; the one copy is a ``sample`` fork's partially filled tail
    block (:meth:`fork`). :meth:`adopt_foreign` chains a peer's (or the
    host tier's) blocks into the trie. Copied from the reference.

    ``kv_pool_blocks_{total,used,free}`` gauges plus the shared
    ``prefix_cache_*`` hit/miss series publish into ``registry``.
    """

    def __init__(self, capacity: int, block_tokens: int, *,
                 bytes_per_block: int = 0, registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self._init_trie(capacity, block_tokens)
        self.bytes_per_block = int(bytes_per_block)
        # High-water mark of blocks in use — what a byte budget must
        # actually cover.
        self.peak_blocks_used = 0
        # Copy-on-write sharing for forked sampling (kind="sample"):
        # ``_fork_refs[row] = k`` means k ADDITIONAL owners share the row
        # beyond the one that will eventually free it last. ``free`` on
        # such a row decrements instead of returning it to the free list
        # — the row truly frees only when its last owner lets go. Rows
        # here are PRIVATE slot rows (complete, never-again-written
        # prompt blocks shared by n fork rows), distinct from trie
        # pinning (``_Node.refs``), which protects SHARED trie rows.
        self._fork_refs: dict[int, int] = {}
        self.forked_blocks_total = 0  # cumulative extra shares handed out
        self.fork_cow_copies = 0      # tail blocks copied at fork time
        self._g_pool = None
        if registry is not None:
            self._metrics = _register_trie_metrics(registry)
            self._metrics["capacity"].set(self.capacity)
            self._g_pool = {
                "total": registry.gauge(
                    "kv_pool_blocks_total",
                    help="KV block pool capacity (blocks)"),
                "used": registry.gauge(
                    "kv_pool_blocks_used",
                    help="KV blocks held by decode slots or the prefix "
                         "trie"),
                "free": registry.gauge(
                    "kv_pool_blocks_free", help="KV blocks on the free "
                                                "list"),
            }
            self._g_pool["total"].set(self.capacity)
            self._note_occupancy()

    def stats(self) -> dict:
        total = self.hit_tokens + self.miss_tokens
        return {
            "block_tokens": self.block_tokens,
            "capacity_blocks": self.capacity,
            "blocks_used": self.blocks_used,
            "blocks_free": self.blocks_free,
            "peak_blocks_used": self.peak_blocks_used,
            "bytes_per_block": self.bytes_per_block,
            "bytes_used": self.blocks_used * self.bytes_per_block,
            "lookups": self.lookups,
            "hit_requests": self.hit_requests,
            "hit_tokens": self.hit_tokens,
            "miss_tokens": self.miss_tokens,
            "hit_rate": (self.hit_tokens / total) if total else 0.0,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "flushes": self.flushes,
            "fork_shared_blocks": len(self._fork_refs),
            "forked_blocks_total": self.forked_blocks_total,
            "fork_cow_copies": self.fork_cow_copies,
        }

    # -- slot allocation ----------------------------------------------------
    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` private block rows, evicting LRU unreferenced trie
        leaves as needed. All-or-nothing: on shortfall every row taken is
        returned and ``None`` comes back (the caller preempts a slot or
        parks the request) — a partial grant would leave a slot unable
        to write its next token with no way to make progress."""
        if n <= 0:
            return []
        got: list[int] = []
        opened = self._begin_spill_burst()
        try:
            while len(got) < n:
                slot = self._alloc(protect=None)
                if slot is None:
                    self._free.extend(got)
                    return None
                got.append(slot)
        finally:
            # Flush even on shortfall: the victims were evicted either
            # way, and their rows (returned to the free list unwritten)
            # still hold the bytes to spill.
            if opened:
                self._flush_spill_burst()
        self.peak_blocks_used = max(self.peak_blocks_used, self.blocks_used)
        if self._metrics is not None:
            self._note_occupancy()
        return got

    def fork(self, ids, n: int) -> None:
        """Register ``n - 1`` additional owners for each private row in
        ``ids`` — the copy-on-write share under forked sampling: one
        prefill's complete prompt blocks are pointed at by all ``n`` fork
        rows' block tables, and each fork :meth:`free`\\ s them at its own
        teardown. Complete blocks are never written again (appends go to
        fresh private tail blocks), so sharing needs no copy — the only
        copy-on-write moment is the PARTIAL tail block, which the engine
        duplicates per fork at fork time (:attr:`fork_cow_copies`)."""
        extra = max(0, int(n) - 1)
        if not extra or not len(ids):
            return
        for i in ids:
            self._fork_refs[int(i)] = self._fork_refs.get(int(i), 0) + extra
        self.forked_blocks_total += extra * len(ids)

    def note_cow_copy(self, n: int = 1) -> None:
        """Count ``n`` tail blocks physically copied at fork time (the
        divergent-write half of copy-on-write)."""
        self.fork_cow_copies += int(n)

    def free(self, ids) -> None:
        """Return private rows to the free list. Only rows handed out by
        :meth:`alloc` and not since adopted may be freed. Rows shared
        across fork groups (:meth:`fork`) decrement their extra-owner
        count instead — the row returns to the free list only on its
        LAST owner's free, which keeps block accounting exact under
        copy-on-write sampling."""
        if not len(ids):
            return
        released: list[int] = []
        for i in ids:
            i = int(i)
            extra = self._fork_refs.get(i)
            if extra:
                if extra == 1:
                    del self._fork_refs[i]
                else:
                    self._fork_refs[i] = extra - 1
                continue
            released.append(i)
        if not released:
            return
        self._free.extend(released)
        self.version += 1
        if self._metrics is not None:
            self._note_occupancy()

    def flush(self) -> None:
        """Pool flush additionally clears fork shares: a flush runs with
        zero active slots, so no fork group can still own rows."""
        self._fork_refs.clear()
        super().flush()

    def adopt(self, tokens, ids, first_block: int) -> int:
        """Zero-copy prefix-cache insert: chain the slot's private rows
        ``ids`` — holding the K/V of ``tokens``' blocks ``first_block,
        first_block+1, ...`` — into the trie, making them shareable (and
        evictable once unreferenced). Blocks the trie already holds (a
        concurrent request cached the same prefix first) free our
        duplicate row instead; rows past ``tokens``' complete blocks are
        freed too. Returns the count actually adopted."""
        keys = list(self._blocks(tokens, len(tokens) // self.block_tokens))
        node = self._root
        for key in keys[:first_block]:
            child = node.children.get(key)
            if child is None:
                # The matched prefix chain this slot hung off was flushed
                # or evicted out from under a non-pinned walk — cannot
                # attach a disconnected suffix; just free the rows.
                self.free(ids)
                return 0
            node = child
        now = next(self._clock)
        adopted = 0
        extra: list[int] = []
        for key, slot in zip(keys[first_block:], ids):
            child = node.children.get(key)
            if child is not None:
                extra.append(int(slot))  # duplicate: cached copy wins
                self._touch(child, now)
                node = child
                continue
            child = _Node(int(slot), node, key)
            node.children[key] = child
            self._by_slot[int(slot)] = child
            self._touch(child, now)
            node = child
            adopted += 1
        tail = len(keys) - first_block
        extra.extend(int(s) for s in ids[max(0, tail):])
        if extra:
            self.free(extra)
        self.inserted_blocks += adopted
        self.version += 1  # adopted rows are now evictable
        if self._metrics is not None:
            if adopted:
                self._metrics["inserts"].inc(adopted)
            self._note_occupancy()
        return adopted

    def adopt_foreign(self, tokens, n_blocks: int):
        """Receiving half of a KV block migration (kv_transfer): chain
        the first ``n_blocks`` complete blocks of ``tokens`` into the
        trie, allocating a fresh pool row for each block not already
        resident. Returns ``(uploads, resident_blocks)``: ``uploads``
        is the ``(block_index, pool_row)`` list the engine must scatter
        the payload's data into (already-cached duplicates need no
        upload — the resident copy is bit-identical by the provenance
        contract), and ``resident_blocks`` is the contiguous prefix now
        matchable. A dry pool stops the walk early — the contiguous
        prefix adopted so far still serves, and adoption NEVER evicts a
        decode slot's blocks or preempts local work (foreign blocks
        must only ever help): only unreferenced trie leaves may be
        reclaimed, exactly like a local insert."""
        keys = list(self._blocks(tokens, int(n_blocks)))
        node = self._root
        now = next(self._clock)
        uploads: list[tuple[int, int]] = []
        resident = 0
        opened = self._begin_spill_burst()
        try:
            for i, key in enumerate(keys):
                child = node.children.get(key)
                if child is None:
                    slot = self._alloc(protect=node)
                    if slot is None:
                        break  # pool dry: keep the contiguous prefix
                    child = _Node(slot, node, key)
                    node.children[key] = child
                    self._by_slot[slot] = child
                    self.inserted_blocks += 1
                    uploads.append((i, slot))
                self._touch(child, now)
                node = child
                resident += 1
        finally:
            if opened:
                self._flush_spill_burst()
        if uploads:
            self.peak_blocks_used = max(self.peak_blocks_used,
                                        self.blocks_used)
            self.version += 1
            if self._metrics is not None:
                self._metrics["inserts"].inc(len(uploads))
                self._note_occupancy()
        return uploads, resident

    def _note_occupancy(self) -> None:
        if self._metrics is not None:
            self._metrics["used"].set(self.blocks_used)
            self._metrics["bytes"].set(
                self.blocks_used * self.bytes_per_block)
        if self._g_pool is not None:
            self._g_pool["used"].set(self.blocks_used)
            self._g_pool["free"].set(self.blocks_free)
