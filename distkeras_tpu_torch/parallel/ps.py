"""Single-owner parameter-server service.

Counterpart of ``distkeras_tpu/parallel/ps.py:47-291``:

- **Single-owner state.** One service loop owns the center tree and the
  update counter; pulls and commits are messages consumed in order from one
  queue, so data races on PS state are impossible by construction.
- **Transport-agnostic.** :class:`InProcessClient` (queue-based) serves
  workers in the same process: worker threads, each driving its own CUDA
  stream; :mod:`distkeras_tpu_torch.parallel.ps_grpc` serves the same
  service across processes and hosts over gRPC.
- The center lives as host (CPU) tensors and the commit arithmetic is torch
  on the CPU: the loop never touches device memory. Workers' device trees
  become host trees on the worker's side of the queue (:func:`_host_payload`),
  through pinned memory. A reply is the loop's own tree (the loop builds a
  new center at each commit and changes none in place); the client copies
  it on the worker's thread, off the loop's serial path, into pinned memory
  when the center came from a card, so that its host-to-device copy runs
  asynchronously on the worker's stream.

Spans (``telemetry.spans``, free while tracing is off): ``ps_to_host`` on
the worker's side around the device-to-host copy of a payload, ``ps_apply``
on the loop around one commit's health accounting and update.
"""

from __future__ import annotations

import collections
import queue
import threading

import torch

from distkeras_tpu_torch.parallel.protocols import AsyncProtocol
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.utils.pytree import Tree
from distkeras_tpu_torch.utils.pytree import to_host as _to_host

__all__ = ["ParameterServerService", "InProcessClient"]

_PULL = "pull"
_COMMIT = "commit"
_COMMIT_PULL = "commit_pull"
_STOP = "stop"


def _copy(tree: Tree, pin: bool) -> Tree:
    """The receiver's own copy of a reply tree, pinned with ``pin``."""
    return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin).copy_(v)
            for k, v in tree.items()}

class ParameterServerService:
    """The PS loop, with the reference lifecycle API
    (``initialize``/``start``/``run``/``stop``, ``get_model``)."""

    def __init__(self, protocol: AsyncProtocol, center: Tree, num_workers: int,
                 dedupe_window: int = 8192, registry=None, health=None):
        self.protocol = protocol
        # A center handed over from a card means workers on a card: their
        # replies are copied into pinned memory.
        self._pin_replies = any(v.device.type == "cuda" for v in center.values())
        self.num_workers = int(num_workers)
        self._center = _to_host(center)
        # Optional TrainingHealth: per-commit staleness/divergence/goodput
        # accounting, fed from inside the loop with the PRE-commit state.
        self._health = health
        if health is not None:
            health.attach_ps(self)
        self._c_commits = self._c_dups = self._g_depth = None
        if registry is not None:
            self._c_commits = registry.counter("ps_commits_total", help="PS commits applied")
            self._c_dups = registry.counter("ps_duplicate_commits_total",
                                            help="deduped retried commits")
            self._g_depth = registry.gauge("ps_queue_depth", help="pending PS messages")
        self._num_updates = 0
        self._num_commits = 0
        self._num_duplicates = 0
        # Idempotent commits: a retried commit is applied at most once.
        self._seen_ids: collections.OrderedDict = collections.OrderedDict()
        self._dedupe_window = int(dedupe_window)
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self.running = False
        self.snapshot_failures = 0

    # -- lifecycle -----------------------------------------------------------

    def initialize(self) -> None:  # reference API parity; state set in __init__
        pass

    def start(self) -> None:
        if self._thread is not None:
            return
        self.running = True
        self._thread = threading.Thread(target=self._run, name="ps-loop", daemon=True)
        self._thread.start()

    run = start

    def stop(self) -> None:
        if self._thread is None:
            return
        self.running = False
        self._queue.put((_STOP, None, None))
        self._thread.join()
        self._thread = None

    # -- service loop (sole owner of _center/_num_updates) -------------------

    def _observe(self, payload: dict) -> None:
        if self._health is not None:
            if "delta" in payload:
                payload["delta"] = _to_host(payload["delta"])
            self._health.observe_commit(self.protocol, self._center, self._num_updates,
                                        payload, self.num_workers)

    def _count_commit(self) -> None:
        self._num_commits += 1
        if self._c_commits is not None:
            self._c_commits.inc()

    def _run(self) -> None:
        while True:
            action, payload, reply = self._queue.get()
            if self._g_depth is not None:
                self._g_depth.set(self._queue.qsize())
            if action == _STOP:
                break
            if action == _PULL:
                reply.put((self._center, self._num_updates))
            elif action == _COMMIT:
                if self._is_duplicate(payload):
                    if reply is not None:
                        reply.put(False)
                    continue
                with span("ps_apply"):
                    self._observe(payload)
                    self._center, self._num_updates = self.protocol.server_commit(
                        self._center, self._num_updates, payload, self.num_workers)
                self._count_commit()
                if reply is not None:
                    reply.put(True)
            elif action == _COMMIT_PULL:
                # Fused exchange: apply + reply in one PS transition. A
                # deduped retry still gets an answer.
                if self._is_duplicate(payload):
                    out = self.protocol.server_duplicate_reply(
                        self._center, self._num_updates, payload)
                else:
                    before = self._num_updates
                    with span("ps_apply"):
                        self._observe(payload)
                        self._center, self._num_updates, out = self.protocol.server_commit_pull(
                            self._center, self._num_updates, payload, self.num_workers)
                    # An unchanged counter means the protocol applied nothing
                    # (the elastic re-bootstrap answer): not progress.
                    if self._num_updates != before:
                        self._count_commit()
                reply.put(out)

    def _is_duplicate(self, payload: dict) -> bool:
        """Record-and-test the commit id (sole-owner loop; no locking)."""
        cid = payload.get("commit_id")
        if cid is None:
            return False
        if cid in self._seen_ids:
            self._num_duplicates += 1
            if self._c_dups is not None:
                self._c_dups.inc()
            if self._health is not None:
                self._health.record_duplicate(payload)
            return True
        self._seen_ids[cid] = None
        while len(self._seen_ids) > self._dedupe_window:
            self._seen_ids.popitem(last=False)
        return False

    # -- introspection -------------------------------------------------------

    def get_model(self) -> Tree:
        """The center (a copy through the loop while it runs)."""
        if self._thread is not None:
            reply: queue.Queue = queue.Queue()
            self._queue.put((_PULL, None, reply))
            center, _ = reply.get()
            return _copy(center, self._pin_replies)
        return self._center

    @property
    def num_updates(self) -> int:
        return self._num_updates

    @property
    def num_commits(self) -> int:
        return self._num_commits

    @property
    def num_duplicates(self) -> int:
        return self._num_duplicates

    def health(self) -> dict:
        """Liveness and progress snapshot."""
        return {
            "running": self._thread is not None and self._thread.is_alive(),
            "num_updates": self._num_updates,
            "num_commits": self._num_commits,
            "num_duplicates": self._num_duplicates,
            "queue_depth": self._queue.qsize(),
            "snapshot_failures": self.snapshot_failures,
        }

    def client(self) -> "InProcessClient":
        return InProcessClient(self)


class InProcessClient:
    """Worker-side handle: pull/commit round trips through the PS queue.

    ``wire_is_local``: the "wire" is a same-process queue, so bytes are free
    and replies cannot be lost; protocols skip their wire-compression state
    machines (``AEASGDProtocol.worker_window``)."""

    wire_is_local = True

    def __init__(self, service: ParameterServerService):
        self._service = service

    def _receive(self, reply: queue.Queue) -> tuple[Tree, int]:
        tree, counter = reply.get()
        return _copy(tree, self._service._pin_replies), counter

    def pull(self) -> tuple[Tree, int]:
        reply: queue.Queue = queue.Queue()
        self._service._queue.put((_PULL, None, reply))
        return self._receive(reply)

    def commit(self, payload: dict) -> None:
        # Fire-and-forget; device trees become host trees before the enqueue,
        # so the PS never touches device memory.
        with span("ps_to_host"):
            payload = _host_payload(payload)
        self._service._queue.put((_COMMIT, payload, None))

    def commit_pull(self, payload: dict) -> tuple[Tree, int]:
        """Fused commit + pull: one queue round trip, one PS transition."""
        with span("ps_to_host"):
            payload = _host_payload(payload)
        reply: queue.Queue = queue.Queue()
        self._service._queue.put((_COMMIT_PULL, payload, reply))
        return self._receive(reply)


def _host_payload(payload: dict) -> dict:
    return {k: (_to_host(v) if k in ("delta", "local", "elastic_diff") else v)
            for k, v in payload.items()}
