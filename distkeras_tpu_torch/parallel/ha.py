"""High-availability wrappers for PS clients.

Counterpart of ``distkeras_tpu/parallel/ha.py``:

- :class:`RetryingClient` retries pull/commit with exponential backoff and
  raises :class:`ParameterServerUnavailable` only after the budget is spent;
- :class:`StampingClient` attaches a unique ``commit_id`` to every commit,
  so the PS's dedupe window makes retried commits exactly-once;
- :class:`CompressingClient` sends commit deltas as bfloat16 (a torch cast
  on the delta's device, rounding to nearest even as the reference's does);
- :func:`watchdog` polls a client's ``health`` and calls back when the PS
  stops making progress.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import torch

__all__ = [
    "ParameterServerUnavailable",
    "RetryingClient",
    "StampingClient",
    "CompressingClient",
    "watchdog",
]


class ParameterServerUnavailable(RuntimeError):
    pass


class RetryingClient:
    """Wrap any pull/commit client with retry + backoff."""

    def __init__(
        self,
        client,
        max_retries: int = 5,
        base_delay: float = 0.2,
        max_delay: float = 10.0,
        registry=None,
    ):
        self._client = client
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        # Optional telemetry (MetricsRegistry): retries are the early
        # warning of a degrading PS transport — a climbing counter shows
        # up on a scrape long before the retry budget finally exhausts.
        self._c_retries = None
        if registry is not None:
            self._c_retries = registry.counter(
                "ps_client_retries_total", help="PS call retries", op="any")

    def _with_retries(self, fn: Callable, what: str):
        delay = self.base_delay
        last_exc: BaseException | None = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as e:  # transport-level failure
                last_exc = e
                if attempt < self.max_retries:  # no pointless final sleep
                    if self._c_retries is not None:
                        self._c_retries.inc()
                    time.sleep(delay)
                    delay = min(delay * 2, self.max_delay)
        raise ParameterServerUnavailable(
            f"{what} failed after {self.max_retries + 1} attempts"
        ) from last_exc

    def pull(self):
        return self._with_retries(self._client.pull, "pull")

    def commit(self, payload: dict) -> None:
        # Safe to retry only when the commit is idempotent (stamped).
        self._with_retries(lambda: self._client.commit(payload), "commit")

    def commit_pull(self, payload: dict):
        # Same idempotence story: the PS dedupe window makes a retried fused
        # exchange apply-at-most-once, and the dup path still replies.
        return self._with_retries(
            lambda: self._client.commit_pull(payload), "commit_pull"
        )

    def __getattr__(self, name: str) -> Any:
        return getattr(self._client, name)


class StampingClient:
    """Attach monotonically-unique commit_ids for exactly-once application."""

    def __init__(self, client, worker_id: int):
        self._client = client
        self._worker_id = int(worker_id)
        self._counter = 0

    def pull(self):
        return self._client.pull()

    def _stamp(self, payload: dict) -> dict:
        self._counter += 1
        # ``worker`` rides along for the health layer's per-worker
        # accounting (the commit_id encodes the same index, but parsing
        # it back out is a fallback, not the contract).
        return {**payload, "worker": self._worker_id,
                "commit_id": f"w{self._worker_id}:{self._counter}"}

    def commit(self, payload: dict) -> None:
        self._client.commit(self._stamp(payload))

    def commit_pull(self, payload: dict):
        return self._client.commit_pull(self._stamp(payload))

    def __getattr__(self, name: str) -> Any:
        return getattr(self._client, name)


class CompressingClient:
    """Cast commit deltas to bfloat16 before they leave the device: half the
    bytes to the PS. The center accumulates in float32 on the PS (bf16 +
    f32 widens to f32), so the protocol arithmetic is unchanged. Deltas are
    differences of nearby weights, so bf16's 8 mantissa bits cost little;
    pulls stay full precision."""

    def __init__(self, client):
        self._client = client

    def pull(self):
        return self._client.pull()

    @staticmethod
    def _bf16(tree):
        return {k: v.detach().to(torch.bfloat16) for k, v in tree.items()}

    def commit(self, payload: dict) -> None:
        self._client.commit({**payload, "delta": self._bf16(payload["delta"])})

    def commit_pull(self, payload: dict):
        # Only deltas are compressed. A fused elastic exchange compresses
        # itself at the protocol layer (AEASGD ships bf16 mirror-diffs in
        # steady state; its bootstrap "local" frame must stay full precision
        # — absolute weights don't tolerate bf16 truncation the way
        # near-zero deltas do).
        if "delta" in payload:
            payload = {**payload, "delta": self._bf16(payload["delta"])}
        return self._client.commit_pull(payload)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._client, name)


def watchdog(
    health_fn: Callable[[], dict],
    on_stall: Callable[[dict], None],
    interval: float = 5.0,
    stall_after: int = 3,
    stop_event: threading.Event | None = None,
    registry=None,
) -> threading.Thread:
    """Background thread: calls ``health_fn`` every ``interval`` seconds and
    fires ``on_stall(last_health)`` after ``stall_after`` consecutive checks
    with no commit progress (or failed health calls). With a ``registry``,
    each fired stall also bumps ``ps_watchdog_stalls_total``."""
    stop_event = stop_event or threading.Event()
    c_stalls = None
    if registry is not None:
        c_stalls = registry.counter(
            "ps_watchdog_stalls_total", help="watchdog stall callbacks fired")

    def run():
        last_commits = -1
        stalls = 0
        while not stop_event.wait(interval):
            try:
                h = health_fn()
            except Exception:
                h = {"running": False, "num_commits": last_commits}
            if not h.get("running", False) or h.get("num_commits", 0) == last_commits:
                stalls += 1
                if stalls >= stall_after:
                    if c_stalls is not None:
                        c_stalls.inc()
                    on_stall(h)
                    stalls = 0
            else:
                stalls = 0
            last_commits = h.get("num_commits", last_commits)

    t = threading.Thread(target=run, name="ps-watchdog", daemon=True)
    t.stop_event = stop_event
    t.start()
    return t
