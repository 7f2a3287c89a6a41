"""Trainer-side weight publishing: cadence + atomic manifest.

Copy of the reference's ``distkeras_tpu/deploy/publisher.py``, which
imports no JAX; only its imports differ.

The publisher is deliberately passive — trainers drive it (a per-step
call in the step-loop trainers, a background thread over the PS center
in the async family), it decides *whether* this moment is a publish
point and performs the atomic write. Publishing must never take down
training: filesystem failures are counted and logged once, not raised
into the step loop.

Cadence semantics (:class:`PublishPolicy`): a publish is DUE when
``every_steps`` steps or ``every_seconds`` seconds have passed since the
last publish (either alone suffices; the first call is always due so a
short run still leaves one manifest behind). ``min_improvement`` is the
optional metric gate: when set, a due publish additionally requires the
observed loss to have improved by at least that much over the best loss
already published — the knob that keeps a plateaued run from churning
the serving fleet with equivalent checkpoints. The loss is only
*evaluated* when the cadence is due (``loss_fn`` is lazy), so the gate
costs nothing per step.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable

__all__ = ["PublishPolicy", "WeightPublisher", "parse_publish_every"]

log = logging.getLogger(__name__)


def parse_publish_every(spec: str | int | float) -> "PublishPolicy":
    """Parse the CLI form of a publish cadence: ``"30s"`` / ``"2.5s"``
    (wall-clock seconds) or ``"200"`` (steps / PS commits)."""
    if isinstance(spec, (int, float)):
        return PublishPolicy(every_steps=int(spec))
    s = str(spec).strip().lower()
    if s.endswith("s"):
        seconds = float(s[:-1])
        if seconds <= 0:
            raise ValueError(f"publish-every seconds must be > 0: {spec!r}")
        return PublishPolicy(every_seconds=seconds)
    steps = int(s)
    if steps <= 0:
        raise ValueError(f"publish-every steps must be > 0: {spec!r}")
    return PublishPolicy(every_steps=steps)


class PublishPolicy:
    """When to publish: step cadence, wall-clock cadence, loss gate."""

    def __init__(self, every_steps: int | None = None,
                 every_seconds: float | None = None,
                 min_improvement: float | None = None):
        if every_steps is None and every_seconds is None:
            raise ValueError(
                "PublishPolicy needs every_steps and/or every_seconds")
        self.every_steps = int(every_steps) if every_steps else None
        self.every_seconds = float(every_seconds) if every_seconds else None
        self.min_improvement = (float(min_improvement)
                                if min_improvement else None)
        self._last_step: int | None = None
        self._last_time: float | None = None
        self._best_loss: float | None = None

    def due(self, step: int | None, now: float) -> bool:
        """Cadence check only (cheap, per step). First call is due."""
        if self._last_time is None:
            return True
        if (self.every_steps is not None and step is not None
                and self._last_step is not None
                and step - self._last_step >= self.every_steps):
            return True
        if (self.every_seconds is not None
                and now - self._last_time >= self.every_seconds):
            return True
        return False

    def gate(self, loss: float | None) -> bool:
        """The optional metric gate, evaluated only when due: with
        ``min_improvement`` set, a due publish is vetoed unless ``loss``
        improved enough on the best already-published loss (an unknown
        loss passes — the gate is an optimization, not a correctness
        fence)."""
        if self.min_improvement is None or loss is None:
            return True
        if self._best_loss is None:
            return True
        return self._best_loss - float(loss) >= self.min_improvement

    def note_published(self, step: int | None, now: float,
                       loss: float | None) -> None:
        self._last_step = step
        self._last_time = now
        if loss is not None:
            loss = float(loss)
            if self._best_loss is None or loss < self._best_loss:
                self._best_loss = loss


class WeightPublisher:
    """Atomic stamped publishes into one directory, on a policy.

    ``directory`` is the publish directory a
    :class:`~distkeras_tpu_torch.deploy.controller.DeployController` watches;
    ``keep`` bounds retained old versions (see
    :func:`distkeras_tpu_torch.checkpoint.publish_weights`). ``registry`` adds
    ``weights_published_total`` / ``weights_publish_failures_total``
    counters and a ``weights_published_version`` gauge.

    Thread-safe: the async trainers publish from a dedicated thread
    while the main thread may take a final snapshot at exit.
    """

    def __init__(self, directory: str, policy: PublishPolicy | None = None,
                 *, keep: int = 5, registry=None):
        self.directory = directory
        self.policy = policy
        self.keep = int(keep)
        self.published = 0
        self.failures = 0
        self.last_manifest: dict | None = None
        self._lock = threading.Lock()
        self._c_published = self._c_failures = self._g_version = None
        if registry is not None:
            self._c_published = registry.counter(
                "weights_published_total",
                help="stamped weight files published to the publish dir")
            self._c_failures = registry.counter(
                "weights_publish_failures_total",
                help="publishes that failed (filesystem errors; training "
                     "continues)")
            self._g_version = registry.gauge(
                "weights_published_version",
                help="version of the most recent successful publish")

    def maybe_publish(self, variables_fn: Callable[[], Any],
                      step: int | None = None,
                      loss_fn: Callable[[], float | None] | None = None,
                      ) -> dict | None:
        """Publish if the policy says so. ``variables_fn`` and
        ``loss_fn`` are lazy — neither runs unless the cadence is due
        (the per-step cost of an idle publisher is two comparisons).
        Returns the manifest on publish, None otherwise."""
        if self.policy is None:
            return None
        with self._lock:
            now = time.monotonic()
            if not self.policy.due(step, now):
                return None
            loss = None
            if loss_fn is not None:
                try:
                    loss = loss_fn()
                except Exception:
                    loss = None
            if not self.policy.gate(loss):
                # A vetoed cadence point still resets the clock —
                # otherwise every subsequent step re-evaluates the loss.
                self.policy.note_published(step, now, None)
                return None
            try:
                variables = variables_fn()
            except Exception:
                self._note_failure("variables_fn failed")
                self.policy.note_published(step, now, None)
                return None
            manifest = self._publish_locked(variables, step, loss)
            # A FAILED publish must not poison the loss gate: recording
            # its loss as "best published" would veto every later
            # publish against a checkpoint that never landed. The
            # cadence clock still resets (no disk-hammering retry loop;
            # the next due point retries).
            self.policy.note_published(step, now,
                                       loss if manifest else None)
            return manifest

    def publish(self, variables: Any, step: int | None = None,
                loss: float | None = None) -> dict | None:
        """Unconditional publish (final-at-exit snapshots, benches)."""
        with self._lock:
            manifest = self._publish_locked(variables, step, loss)
            if self.policy is not None:
                self.policy.note_published(step, time.monotonic(),
                                           loss if manifest else None)
            return manifest

    def _publish_locked(self, variables: Any, step: int | None,
                        loss: float | None) -> dict | None:
        from distkeras_tpu_torch.checkpoint import publish_weights

        meta: dict = {}
        if step is not None:
            meta["step"] = int(step)
        if loss is not None:
            meta["loss"] = float(loss)
        try:
            manifest = publish_weights(self.directory, variables,
                                       meta=meta, keep=self.keep)
        except Exception as e:
            # Exception, not just OSError: the contract is that
            # publishing NEVER takes down (or silently stops inside)
            # training — a serialization surprise must be counted and
            # logged exactly like a full disk.
            self._note_failure(e)
            return None
        self.published += 1
        self.last_manifest = manifest
        if self._c_published is not None:
            self._c_published.inc()
        if self._g_version is not None:
            self._g_version.set(manifest["version"])
        return manifest

    def _note_failure(self, err) -> None:
        self.failures += 1
        if self._c_failures is not None:
            self._c_failures.inc()
        if self.failures == 1:
            log.exception("weight publish to %s failed", self.directory)
        else:
            log.warning("weight publish to %s failed (%d so far): %s",
                        self.directory, self.failures, err)

    def stats(self) -> dict:
        with self._lock:
            out = {"directory": self.directory, "published": self.published,
                   "failures": self.failures}
            if self.last_manifest:
                out["last_version"] = self.last_manifest.get("version")
                out["last_digest"] = self.last_manifest.get("digest")
            return out
