"""ReplicaSupervisor: keep N serving replicas alive.

Copy of the reference's ``distkeras_tpu/serving/cluster/supervisor.py``,
which imports no JAX; only its imports differ.

The dist-keras lesson transplanted to serving (DeepSpark / SparkNet make
the same point for training): the win is a thin, fault-aware coordination
layer over otherwise-independent workers. The supervisor owns the
*lifecycle* column of the shared :class:`ReplicaInfo` table:

- spawn N replicas from a ``factory(index) -> ReplicaHandle`` and wait
  until each answers ``healthz`` (STARTING -> READY);
- a periodic health loop probes every live replica over the existing
  ``healthz`` verb — a dead process, a refused connection, or a reply
  that never arrives (wedged event loop) all count as failures, and
  ``fail_after`` consecutive failures mark the replica DEAD;
- a DEAD replica is killed (idempotent) and restarted with **capped
  exponential backoff** (the same shape as ``parallel/ha.py §
  RetryingClient``): ``base_delay * 2^k`` capped at ``max_delay``, where
  ``k`` counts restarts not yet vindicated by a stable READY period —
  a crash-looping replica never hot-loops the host, a one-off crash
  restarts almost immediately;
- the router feeds observations back through :meth:`note_failure`
  (a dispatch that found the backend gone), so detection latency is one
  failed request, not one health interval.

The supervisor never routes; the router never restarts. Both read and
write the one table.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import time
from typing import Callable

from distkeras_tpu_torch.serving.cluster.replicas import (
    DEAD,
    DRAINING,
    READY,
    STARTING,
    ReplicaHandle,
    ReplicaInfo,
    probe_healthz,
    send_control,
)

__all__ = ["ReplicaSupervisor", "parse_roles"]


def parse_roles(spec: str | None) -> list[str] | None:
    """``"prefill=N,decode=M"`` into the index-aligned role list the
    supervisor takes (prefill replicas first) — THE parser behind
    ``run.py cluster --roles`` and both benches' ``--roles`` flags, so
    the accepted grammar can never drift between them. Raises
    ``ValueError`` on bad input (CLI front ends map it to a typed
    exit); ``None``/empty means no roles (a monolithic fleet)."""
    if not spec:
        return None
    counts = {"prefill": 0, "decode": 0}
    for part in str(spec).split(","):
        name, sep, value = part.partition("=")
        name = name.strip()
        if not sep or name not in counts:
            raise ValueError(
                f"roles need prefill=N,decode=M, got {part!r}")
        try:
            counts[name] = int(value)
        except ValueError:
            raise ValueError(f"bad role count in {part!r}") from None
    if counts["prefill"] < 1 or counts["decode"] < 1:
        raise ValueError("roles need at least one prefill and one "
                         "decode replica (omit roles for a monolithic "
                         "fleet)")
    return (["prefill"] * counts["prefill"]
            + ["decode"] * counts["decode"])


class ReplicaSupervisor:
    """Spawn, health-check, and restart a fleet of serving replicas.

    ``factory``: ``index -> ReplicaHandle`` — called once per replica at
    :meth:`start` and again for every restart (a restarted replica gets a
    FRESH handle/engine; crashed state is never reused).
    ``health_interval_s`` / ``health_timeout_s``: probe cadence and
    per-probe deadline. ``fail_after``: consecutive failed probes before
    a live-looking replica is declared dead (a handle whose process has
    exited is declared dead immediately).
    ``base_delay_s`` / ``max_delay_s``: restart backoff bounds.
    ``stable_after_s``: a replica READY this long has its backoff
    exponent reset (the crash was transient, not a loop).
    """

    def __init__(
        self,
        factory: Callable[[int], ReplicaHandle],
        n: int,
        *,
        health_interval_s: float = 0.5,
        health_timeout_s: float = 5.0,
        fail_after: int = 2,
        base_delay_s: float = 0.2,
        max_delay_s: float = 30.0,
        stable_after_s: float = 5.0,
        registry=None,
        roles=None,
    ):
        if n < 1:
            raise ValueError(f"need at least 1 replica, got {n}")
        if roles is not None:
            if len(roles) != n:
                raise ValueError(
                    f"roles names {len(roles)} replicas for a fleet of "
                    f"{n}")
            bad = sorted({r for r in roles
                          if r not in ("prefill", "decode", "monolithic")})
            if bad:
                raise ValueError(f"unknown replica roles {bad}; valid: "
                                 f"prefill/decode/monolithic")
        self._factory = factory
        self.health_interval_s = float(health_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.fail_after = int(fail_after)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.stable_after_s = float(stable_after_s)
        # Disaggregated fleets: per-index role ("prefill"/"decode"),
        # default "monolithic". A role is a stable property of the
        # SLOT, not the incarnation — restarts keep it.
        self.replicas: dict[str, ReplicaInfo] = {
            f"r{i}": ReplicaInfo(
                rid=f"r{i}", index=i, handle=factory(i),
                role=(roles[i] if roles is not None else "monolithic"))
            for i in range(n)
        }
        self._stopping = asyncio.Event()
        self._restart_tasks: set[asyncio.Task] = set()
        # Death observers: ``cb(rid)`` fired when a replica is declared
        # DEAD (before its restart begins). The router registers its
        # fleet-cache-directory invalidation here — a dead tier owner's
        # entries must stop steering adoptions at it. Callbacks must be
        # cheap and must not raise.
        self.on_replica_death: list = []
        # Bounded death/restart log: one entry per replica death, with a
        # reference to (and summary of) the dead replica's flight-
        # recorder "last words" dump when its handle exposes one — the
        # post-mortem trail `debugz` serves and operators grep first.
        self.restart_log: collections.deque = collections.deque(maxlen=64)
        # The most recent crash's FULL flight-recorder dump (bounded to
        # the final events/timelines so a chatty recorder can't bloat
        # the supervisor): restart_log keeps one summary line per death,
        # this keeps the one post-mortem an operator actually opens —
        # served whole through the router's ``debugz`` and as a one-line
        # pointer in ``healthz``.
        self.last_crash: dict | None = None
        # The fleet's CURRENT weights path, recorded by the router's
        # rolling reload: a replica (re)started after a reload must
        # rejoin on these weights, not the factory's boot weights —
        # otherwise one crash silently creates a mixed-version fleet.
        self.current_weights: str | None = None
        self._c_restarts = self._c_health_failures = None
        self._g_ready = None
        if registry is not None:
            self._c_restarts = registry.counter(
                "cluster_replica_restarts_total",
                help="replica restarts performed by the supervisor")
            self._c_health_failures = registry.counter(
                "cluster_health_check_failures_total",
                help="failed replica health probes")
            self._g_ready = registry.gauge(
                "cluster_replicas_ready", help="replicas in READY state")

    # -- introspection ------------------------------------------------------
    @property
    def ready_count(self) -> int:
        return sum(1 for r in self.replicas.values() if r.status == READY)

    def _note_ready(self) -> None:
        if self._g_ready is not None:
            self._g_ready.set(self.ready_count)

    def table(self) -> dict[str, dict]:
        """JSON-safe snapshot of the replica table (aggregate healthz)."""
        return {rid: info.public() for rid, info in self.replicas.items()}

    def restart_log_entries(self) -> list[dict]:
        return list(self.restart_log)

    def last_crash_summary(self) -> dict | None:
        """One-line pointer for ``healthz``: who crashed last, when, why,
        and where the full dump lives (``debugz`` serves the dump)."""
        if self.last_crash is None:
            return None
        return {k: self.last_crash[k]
                for k in ("t", "rid", "why", "flight_recorder")}

    def _collect_last_words(self, info: ReplicaInfo, entry: dict) -> None:
        """Attach the dead replica's flight-recorder dump to its restart
        log entry: the path, plus a small summary (event/timeline counts
        and the final recorded events) so the log is useful even before
        anyone opens the file. Missing file (SIGKILL'd process replicas
        can't write last words) or a torn read is recorded as such, never
        raised — this runs on the death path."""
        path = getattr(info.handle, "last_words_path", None)
        if not path:
            return
        entry["flight_recorder"] = path
        try:
            if not os.path.exists(path):
                entry["last_words"] = "no dump found (hard kill?)"
                return
            with open(path) as f:
                dump = json.load(f)
            self.last_crash = {
                "t": entry["t"], "rid": info.rid, "why": entry["why"],
                "flight_recorder": path,
                "dump": {
                    "source": dump.get("source"),
                    "dumped_at": dump.get("dumped_at"),
                    "events": dump.get("events", [])[-50:],
                    "timelines": dump.get("timelines", [])[-20:],
                    "slow_exemplars": dump.get("slow_exemplars", [])[-8:],
                },
            }
            entry["last_words"] = {
                "source": dump.get("source"),
                "dumped_at": dump.get("dumped_at"),
                "events": len(dump.get("events", [])),
                "timelines": len(dump.get("timelines", [])),
                "slow_exemplars": len(dump.get("slow_exemplars", [])),
                "final_events": [
                    {"kind": e.get("kind"), "ts": e.get("ts")}
                    for e in dump.get("events", [])[-3:]
                ],
            }
        except (OSError, ValueError) as e:
            entry["last_words"] = f"unreadable dump: {e}"

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        """Start every replica concurrently and wait until all READY.
        If ANY replica fails to come up, every already-started one is
        killed before the error propagates — a failed cluster start
        leaves no orphaned replica processes behind."""
        results = await asyncio.gather(
            *(self._start_replica(info) for info in self.replicas.values()),
            return_exceptions=True)
        errors = [r for r in results if isinstance(r, BaseException)]
        if errors:
            await asyncio.gather(
                *(info.handle.kill() for info in self.replicas.values()),
                return_exceptions=True)
            raise errors[0]

    async def _start_replica(self, info: ReplicaInfo) -> None:
        info.status = STARTING
        info.host, info.port = await info.handle.start()
        # New incarnation: invalidate everything the router negotiated
        # with the previous life — pooled connections AND the cached
        # wire protocol are keyed by this generation, so a replica that
        # restarts onto the SAME port can never be served by a stale
        # connection mid-handshake.
        info.generation += 1
        info.wire_proto = None
        await self._await_ready(info)

    async def _await_ready(self, info: ReplicaInfo,
                           timeout_s: float = 120.0) -> None:
        """Probe until the replica answers healthz — then, if the fleet
        has rolled to newer weights than the factory boots with, apply
        them BEFORE the replica becomes routable — and mark READY."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                info.last_health = await probe_healthz(
                    info.host, info.port, self.health_timeout_s)
                break
            except (OSError, asyncio.TimeoutError, ValueError):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica {info.rid} never became healthy on "
                        f"{info.host}:{info.port}")
                await asyncio.sleep(0.05)
        if self.current_weights is not None:
            # No traffic yet (still STARTING), so the swap runs at the
            # engine's first idle iteration — immediately. A failure here
            # fails the whole start: the restart path retries with
            # backoff rather than admit a stale-weights replica.
            rep = await send_control(
                info.host, info.port,
                {"cmd": "reload", "weights": self.current_weights,
                 "timeout": 60.0},
                timeout=120.0)
            if "error" in rep:
                raise RuntimeError(
                    f"replica {info.rid} failed to load the fleet's "
                    f"current weights {self.current_weights!r}: "
                    f"{rep['error']}")
        info.status = READY
        info.ready_since = time.monotonic()
        info.consecutive_failures = 0
        self._note_ready()

    async def run(self) -> None:
        """Health loop: probe, detect, restart — until :meth:`stop`.
        Probes run CONCURRENTLY per pass: one wedged replica costs its
        own ``health_timeout_s``, never a serial stall that delays
        detecting the next replica's death."""
        while not self._stopping.is_set():
            # DEAD and STARTING replicas are owned by their restart/start
            # path (which probes readiness itself) — the health loop
            # declaring one dead mid-restart would spawn a SECOND
            # restart task for the same replica.
            await asyncio.gather(*(
                self._probe_once(info)
                for info in list(self.replicas.values())
                if info.status in (READY, DRAINING)))
            try:
                await asyncio.wait_for(
                    self._stopping.wait(), self.health_interval_s)
            except asyncio.TimeoutError:
                pass

    async def _probe_once(self, info: ReplicaInfo) -> None:
        if self._stopping.is_set():
            return
        if not info.handle.alive:
            self._on_dead(info, "process exited")
            return
        try:
            info.last_health = await probe_healthz(
                info.host, info.port, self.health_timeout_s)
        except (OSError, asyncio.TimeoutError, ValueError):
            info.consecutive_failures += 1
            if self._c_health_failures is not None:
                self._c_health_failures.inc()
            if info.consecutive_failures >= self.fail_after:
                self._on_dead(
                    info, f"{info.consecutive_failures} failed probes")
            return
        info.consecutive_failures = 0
        # A replica stable this long has outlived crash-loop suspicion:
        # reset its backoff exponent.
        if (info.consecutive_restarts and info.ready_since is not None
                and time.monotonic() - info.ready_since
                > self.stable_after_s):
            info.consecutive_restarts = 0

    def note_failure(self, rid: str) -> None:
        """Router feedback: a dispatch found this replica's backend gone.
        A handle whose process has exited is marked dead immediately (no
        waiting out ``fail_after`` probe intervals); a still-alive handle
        just accrues one failure (transient resets stay survivable)."""
        info = self.replicas.get(rid)
        if info is None or info.status in (DEAD, STARTING):
            return  # the restart/start path already owns this replica
        if not info.handle.alive:
            self._on_dead(info, "router observed backend loss")
        else:
            info.consecutive_failures += 1
            if info.consecutive_failures >= self.fail_after:
                self._on_dead(info, "router-observed failures")

    def _on_dead(self, info: ReplicaInfo, why: str) -> None:
        if info.status == DEAD or self._stopping.is_set():
            return
        info.status = DEAD
        info.ready_since = None
        self._note_ready()
        entry = {"t": time.time(), "rid": info.rid, "why": why,
                 "prior_restarts": info.restarts}
        self._collect_last_words(info, entry)
        self.restart_log.append(entry)
        for cb in list(self.on_replica_death):
            try:
                cb(info.rid)
            except Exception:  # observers must never block a restart
                pass
        task = asyncio.get_running_loop().create_task(
            self._restart(info), name=f"restart-{info.rid}")
        self._restart_tasks.add(task)
        task.add_done_callback(self._restart_tasks.discard)

    async def _restart(self, info: ReplicaInfo) -> None:
        """Kill the corpse, then bring up a fresh handle with capped
        exponential backoff until READY (or the supervisor stops)."""
        await info.handle.kill()
        while not self._stopping.is_set():
            delay = min(
                self.base_delay_s * (2 ** info.consecutive_restarts),
                self.max_delay_s)
            info.consecutive_restarts += 1
            try:
                await asyncio.wait_for(self._stopping.wait(), delay)
                return  # stopped during backoff
            except asyncio.TimeoutError:
                pass
            info.handle = self._factory(info.index)
            try:
                info.status = STARTING
                info.host, info.port = await info.handle.start()
                # Same invalidation as _start_replica: the restarted
                # replica is a new incarnation even on a reused port.
                info.generation += 1
                info.wire_proto = None
                await self._await_ready(info)
            except Exception:
                await info.handle.kill()
                info.status = DEAD
                continue
            info.restarts += 1
            if self._c_restarts is not None:
                self._c_restarts.inc()
            self.restart_log.append({
                "t": time.time(), "rid": info.rid, "restarted": True,
                "restarts": info.restarts,
                "host": info.host, "port": info.port})
            return

    async def stop(self) -> None:
        """Stop the health loop and gracefully terminate every replica."""
        self._stopping.set()
        for task in list(self._restart_tasks):
            task.cancel()
        if self._restart_tasks:
            await asyncio.gather(*self._restart_tasks,
                                 return_exceptions=True)
        await asyncio.gather(
            *(info.handle.terminate() for info in self.replicas.values()),
            return_exceptions=True)
        for info in self.replicas.values():
            info.status = DEAD
        self._note_ready()
