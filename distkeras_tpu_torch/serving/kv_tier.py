"""Host-RAM (optionally disk-backed) KV block tier under ``KVBlockPool``.

Copy of the reference's ``distkeras_tpu/serving/kv_tier.py``, which
imports no JAX; only its imports differ.

The paged pool dies at device bytes: once the hot prefix working set
outgrows HBM, every trie eviction costs a full re-prefill on the next
hit. :class:`HostKVTier` generalizes the pool's LRU into a two-level
promotion/demotion hierarchy:

    device pool  ⇄  host RAM  ⇄  (optional) disk

- **Spill (device → host)**: when ``_BlockTrie._alloc`` evicts an
  unreferenced leaf, the engine's spill hook gathers that one block
  D2H and stores the exact ``kv_transfer`` KVX1 bytes here, keyed by
  the block's full root→leaf token chain. The payload is the same
  serialization a peer transfer would ship, so a spilled block is
  simultaneously re-admittable locally AND exportable to the fleet.
- **Re-admit (host → device)**: on a trie miss during admission the
  engine probes this tier along the prompt's block chain and scatters
  hits back into freshly adopted pool rows (H2D), extending the device
  match without re-prefilling.
- **Demote (host → disk)** / **promote (disk → host)**: host entries
  evicted by the byte budget demote to one-file-per-entry storage under
  ``disk_dir`` when configured (else they are dropped); a ``get`` on a
  disk entry reads it back and promotes it to host RAM.

Eviction per tier is budget + watermark: inserts that push a tier past
its byte budget evict LRU entries down to ``watermark * budget`` so
eviction runs in bursts instead of on every put. Entries are NOT
removed on ``get`` — the tier is an inclusive cache below the device
pool, so a re-admitted block that gets evicted again is a cheap
overwrite rather than a fresh D2H gather.

Host-only code: imports no torch (payloads are opaque bytes; the
engine owns all device work). A single lock guards mutation — puts
arrive from both the engine loop (admission-time eviction) and the
executor thread (import-time adoption can cascade evictions).
"""

from __future__ import annotations

import itertools
import os
import threading

__all__ = ["HostKVTier", "TierEntry"]


class TierEntry:
    """One spilled block: KVX1 payload bytes, host- or disk-resident."""

    __slots__ = ("key", "payload", "path", "nbytes", "last_used")

    def __init__(self, key, payload, nbytes):
        self.key = key
        self.payload = payload  # bytes when host-resident, None on disk
        self.path = None        # file path when disk-resident
        self.nbytes = nbytes
        self.last_used = 0

    @property
    def on_disk(self) -> bool:
        return self.path is not None


class HostKVTier:
    """Byte-budgeted host tier of KVX1 block payloads with LRU
    demotion to an optional disk tier.

    ``block_tokens``: trie block granularity — keys are full token
    chains, so :meth:`probe` needs it to cut a prompt into block keys.
    ``host_budget_bytes`` / ``disk_budget_bytes``: per-tier caps on
    payload bytes (0 disables the tier).
    ``watermark``: eviction target as a fraction of the budget — an
    insert that crosses the budget evicts LRU entries until the tier is
    back under ``watermark * budget``.
    """

    def __init__(self, host_budget_bytes: int, block_tokens: int, *,
                 disk_dir: str | None = None, disk_budget_bytes: int = 0,
                 watermark: float = 0.8, registry=None):
        if host_budget_bytes <= 0:
            raise ValueError("host_budget_bytes must be positive")
        if not 0.0 < watermark <= 1.0:
            raise ValueError("watermark must be in (0, 1]")
        if disk_budget_bytes and not disk_dir:
            raise ValueError("disk_budget_bytes requires disk_dir")
        self.block_tokens = int(block_tokens)
        self.host_budget_bytes = int(host_budget_bytes)
        self.disk_dir = disk_dir
        self.disk_budget_bytes = int(disk_budget_bytes) if disk_dir else 0
        self.watermark = float(watermark)
        self._lock = threading.Lock()
        self._clock = itertools.count(1)
        self._host: dict[tuple, TierEntry] = {}   # insertion order = LRU
        self._disk: dict[tuple, TierEntry] = {}
        self._fileno = itertools.count()
        self.host_bytes = 0
        self.disk_bytes = 0
        # Counters survive flush(): they are lifetime telemetry.
        self.hits = 0
        self.misses = 0
        self.demotions = 0
        self.promotions = 0
        self.evictions = 0
        self.flushes = 0
        self._g = None
        if registry is not None:
            reg = registry
            self._g = {
                "host_bytes": reg.gauge(
                    "kv_tier_host_bytes",
                    help="KVX1 payload bytes resident in the host RAM tier"),
                "disk_bytes": reg.gauge(
                    "kv_tier_disk_bytes",
                    help="KVX1 payload bytes resident in the disk tier"),
                "host_entries": reg.gauge(
                    "kv_tier_host_entries",
                    help="blocks resident in the host RAM tier"),
                "disk_entries": reg.gauge(
                    "kv_tier_disk_entries",
                    help="blocks resident in the disk tier"),
                "hits": reg.counter(
                    "kv_tier_hits_total",
                    help="tier probes that found the block (any level)"),
                "misses": reg.counter(
                    "kv_tier_misses_total",
                    help="tier probes that missed both levels"),
                "demotions": reg.counter(
                    "kv_tier_demotions_total",
                    help="host-tier blocks demoted to the disk tier"),
                "promotions": reg.counter(
                    "kv_tier_promotions_total",
                    help="disk-tier blocks promoted back to host RAM"),
                "evictions": reg.counter(
                    "kv_tier_evictions_total",
                    help="tier blocks dropped entirely (no lower tier "
                         "or lower tier full)"),
            }

    # -- key helpers ---------------------------------------------------------
    @staticmethod
    def chain_key(chain_tokens) -> tuple:
        """Tier key for a block: the FULL root→block token chain (not
        just the block's own tokens) — two different prefixes sharing a
        final block's tokens are different KV."""
        return tuple(int(t) for t in chain_tokens)

    def block_keys(self, tokens):
        """The chain keys of every complete block of ``tokens``."""
        bt = self.block_tokens
        return [self.chain_key(tokens[:(i + 1) * bt])
                for i in range(len(tokens) // bt)]

    # -- core ops ------------------------------------------------------------
    def put(self, chain_tokens, payload: bytes) -> bool:
        """Insert/refresh one block payload; returns False only when the
        payload alone exceeds the host budget."""
        key = self.chain_key(chain_tokens)
        nbytes = len(payload)
        if nbytes > self.host_budget_bytes:
            return False
        with self._lock:
            self._drop_locked(key)  # replace, never double-count
            e = TierEntry(key, payload, nbytes)
            e.last_used = next(self._clock)
            self._host[key] = e
            self.host_bytes += nbytes
            if self.host_bytes > self.host_budget_bytes:
                self._evict_host_locked(protect=key)
            self._note_gauges_locked()
        return True

    def get(self, chain_tokens) -> bytes | None:
        """Payload for one block chain, promoting disk→host on a disk
        hit. The entry STAYS in the tier (inclusive-cache semantics)."""
        key = self.chain_key(chain_tokens)
        with self._lock:
            e = self._host.get(key)
            if e is not None:
                e.last_used = next(self._clock)
                # Re-append so dict order tracks LRU.
                self._host.pop(key)
                self._host[key] = e
                self.hits += 1
                if self._g:
                    self._g["hits"].inc()
                return e.payload
            e = self._disk.pop(key, None)
            if e is None:
                self.misses += 1
                if self._g:
                    self._g["misses"].inc()
                return None
            payload = self._read_disk(e)
            self.disk_bytes -= e.nbytes
            if payload is None:  # file vanished under us
                self.misses += 1
                self._note_gauges_locked()
                return None
            e.payload, e.path = payload, None
            e.last_used = next(self._clock)
            self._host[key] = e
            self.host_bytes += e.nbytes
            self.promotions += 1
            self.hits += 1
            if self._g:
                self._g["promotions"].inc()
                self._g["hits"].inc()
            if self.host_bytes > self.host_budget_bytes:
                self._evict_host_locked(protect=key)
            self._note_gauges_locked()
            return payload

    def contains(self, chain_tokens) -> bool:
        key = self.chain_key(chain_tokens)
        with self._lock:
            return key in self._host or key in self._disk

    def probe(self, tokens) -> int:
        """Contiguous complete blocks of ``tokens`` (from the root)
        present in the tier — the admission path uses this to decide
        whether a parked request is tier-pending. Does not touch LRU or
        hit/miss stats."""
        n = 0
        with self._lock:
            for key in self.block_keys(tokens):
                if key in self._host or key in self._disk:
                    n += 1
                else:
                    break
        return n

    def flush(self) -> int:
        """Drop every entry (both levels) — weight swaps call this: KV
        is a pure function of (weights, tokens), so spilled bytes from
        the old weights are poison under the new ones."""
        with self._lock:
            dropped = len(self._host) + len(self._disk)
            for e in self._disk.values():
                self._unlink(e)
            self._host.clear()
            self._disk.clear()
            self.host_bytes = 0
            self.disk_bytes = 0
            self.flushes += 1
            self._note_gauges_locked()
        return dropped

    def stats(self) -> dict:
        with self._lock:
            return {
                "host_entries": len(self._host),
                "host_bytes": self.host_bytes,
                "host_budget_bytes": self.host_budget_bytes,
                "disk_entries": len(self._disk),
                "disk_bytes": self.disk_bytes,
                "disk_budget_bytes": self.disk_budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "evictions": self.evictions,
                "flushes": self.flushes,
            }

    # -- internals (lock held) -----------------------------------------------
    def _drop_locked(self, key) -> None:
        e = self._host.pop(key, None)
        if e is not None:
            self.host_bytes -= e.nbytes
        e = self._disk.pop(key, None)
        if e is not None:
            self.disk_bytes -= e.nbytes
            self._unlink(e)

    def _evict_host_locked(self, protect=None) -> None:
        """LRU-evict host entries down to the watermark, demoting each
        to disk when a disk tier is configured (else dropping it)."""
        target = int(self.watermark * self.host_budget_bytes)
        for key in list(self._host):
            if self.host_bytes <= target:
                break
            if key == protect:
                continue
            e = self._host.pop(key)
            self.host_bytes -= e.nbytes
            if self.disk_budget_bytes and e.nbytes <= self.disk_budget_bytes:
                self._demote_locked(e)
            else:
                self.evictions += 1
                if self._g:
                    self._g["evictions"].inc()

    def _demote_locked(self, e: TierEntry) -> None:
        while (self.disk_bytes + e.nbytes > self.disk_budget_bytes
               and self._disk):
            victim_key = next(iter(self._disk))
            victim = self._disk.pop(victim_key)
            self.disk_bytes -= victim.nbytes
            self._unlink(victim)
            self.evictions += 1
            if self._g:
                self._g["evictions"].inc()
        path = self._write_disk(e)
        if path is None:  # disk write failed: drop, never raise mid-evict
            self.evictions += 1
            if self._g:
                self._g["evictions"].inc()
            return
        e.path, e.payload = path, None
        self._disk[e.key] = e
        self.disk_bytes += e.nbytes
        self.demotions += 1
        if self._g:
            self._g["demotions"].inc()

    def _write_disk(self, e: TierEntry) -> str | None:
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
            # pid in the name: N replica processes may share one spill
            # dir (cluster mode forwards a single --kv-disk-tier-dir).
            path = os.path.join(
                self.disk_dir,
                f"kvx-{os.getpid()}-{next(self._fileno):08d}.bin")
            with open(path, "wb") as f:
                f.write(e.payload)
            return path
        except OSError:
            return None

    def _read_disk(self, e: TierEntry) -> bytes | None:
        try:
            with open(e.path, "rb") as f:
                payload = f.read()
        except OSError:
            return None
        self._unlink(e)
        return payload

    @staticmethod
    def _unlink(e: TierEntry) -> None:
        if e.path is None:
            return
        try:
            os.unlink(e.path)
        except OSError:
            pass
        e.path = None

    def _note_gauges_locked(self) -> None:
        if not self._g:
            return
        self._g["host_bytes"].set(self.host_bytes)
        self._g["disk_bytes"].set(self.disk_bytes)
        self._g["host_entries"].set(len(self._host))
        self._g["disk_entries"].set(len(self._disk))
