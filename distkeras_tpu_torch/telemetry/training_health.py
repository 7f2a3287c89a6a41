"""Async-training health: staleness, divergence, goodput, per-worker vitals.

Copy of the reference's ``distkeras_tpu/telemetry/training_health.py``
(jax-free), with the device-memory rows read from ``torch.cuda``. What it
tracks is what makes asynchronous data-parallel training succeed or rot:

- **staleness**: how far behind the PS counter each commit's pull was
  (``num_updates - last_update``, the quantity DynSGD damps by), as
  per-worker and global histograms with worst-sample exemplars, plus exact
  sliding-window percentiles for statusz;
- **divergence**: the elastic family's ``||local - center||_2`` per
  exchange, and a global update-norm histogram for the delta family;
- **goodput**: the L2 mass workers committed against what the protocol
  applied after staleness damping or 1/N normalisation;
- **per-worker vitals**: commit/pull/duplicate/rebase counts, last-commit
  age and commit rate.

One :class:`TrainingHealth` is shared by the PS loop (which calls
:meth:`observe_commit` with each protocol's ``commit_stats``) and the
worker threads (pulls, windows, rebases). Every method is thread-safe and
never raises into its caller: telemetry must not take down training.
:meth:`statusz` renders the picture as a JSON-able snapshot, and every
series also publishes into an optional
:class:`~distkeras_tpu_torch.telemetry.registry.MetricsRegistry`.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

import torch

from distkeras_tpu_torch.telemetry.registry import MetricsRegistry, percentile

__all__ = ["TrainingHealth", "STALENESS_BUCKETS"]

# Integer staleness in commits: 0 = perfectly fresh. Upper bounds chosen
# so a healthy run (staleness ~ num_workers) sits in the low buckets and
# anything past 64 is already pathological.
STALENESS_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)

# Update-norm magnitudes span model scales; wide log buckets.
_NORM_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
                 100.0, 1000.0)


class _WorkerStats:
    """Mutable per-worker record (guarded by TrainingHealth's lock)."""

    __slots__ = ("commits", "duplicates", "pulls", "rebases", "windows",
                 "steps", "last_commit_t", "last_staleness", "staleness",
                 "commit_times", "last_divergence")

    def __init__(self, window: int):
        self.commits = 0
        self.duplicates = 0
        self.pulls = 0
        self.rebases = 0
        self.windows = 0
        self.steps = 0
        self.last_commit_t: float | None = None
        self.last_staleness: int | None = None
        self.last_divergence: float | None = None
        self.staleness: collections.deque = collections.deque(maxlen=window)
        self.commit_times: collections.deque = collections.deque(maxlen=256)


class TrainingHealth:
    """Aggregates async-protocol health; see the module docstring.

    ``registry=None`` keeps everything in-process (statusz still works);
    with a registry, the histograms/counters/gauges below are published
    under ``train_*`` names. ``window`` bounds the exact-percentile
    sliding windows (the registry histograms are O(buckets) regardless).
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 num_workers: int = 0, protocol: str = "",
                 window: int = 1024):
        self.registry = registry
        self.num_workers = int(num_workers)
        self.protocol = str(protocol)
        self._lock = threading.Lock()
        self._window = int(window)
        self._workers: dict = {}
        self._staleness: collections.deque = collections.deque(
            maxlen=4 * self._window)
        self._update_norms: collections.deque = collections.deque(
            maxlen=4 * self._window)
        self._update_mass = 0.0
        self._applied_mass = 0.0
        self._divergence: float | None = None
        self._errors = 0
        self._t0 = time.time()
        self._ps = None  # ParameterServerService, for queue/counter rollup
        self._params_bytes: int | None = None

        self._h_staleness = self._h_norm = self._h_divergence = None
        self._c_commits = self._c_dups = self._c_rebases = None
        self._c_pulls = self._c_mass = self._c_applied = None
        self._g_goodput = self._g_divergence = None
        if registry is not None:
            self._h_staleness = registry.histogram(
                "train_commit_staleness",
                help="PS-counter lag of each commit's pull "
                     "(num_updates - last_update)",
                buckets=STALENESS_BUCKETS)
            self._h_norm = registry.histogram(
                "train_update_norm",
                help="L2 norm of each committed update",
                buckets=_NORM_BUCKETS)
            self._h_divergence = registry.histogram(
                "train_center_divergence",
                help="elastic-family ||local - center||_2 per exchange",
                buckets=_NORM_BUCKETS)
            self._c_commits = registry.counter(
                "train_commits_observed_total",
                help="commits the health layer observed")
            self._c_dups = registry.counter(
                "train_duplicate_commits_observed_total",
                help="deduped retried commits observed")
            self._c_rebases = registry.counter(
                "train_rebases_total",
                help="overlapped-exchange rebases applied by workers")
            self._c_pulls = registry.counter(
                "train_worker_pulls_total",
                help="worker bootstrap/center pulls")
            self._c_mass = registry.counter(
                "train_update_mass_total",
                help="summed L2 mass of updates as committed")
            self._c_applied = registry.counter(
                "train_applied_update_mass_total",
                help="summed L2 mass after protocol damping "
                     "(staleness / 1-over-N)")
            self._g_goodput = registry.gauge(
                "train_goodput_ratio",
                help="applied / committed update mass (1.0 = nothing "
                     "damped away)")
            self._g_divergence = registry.gauge(
                "train_center_divergence_last",
                help="most recent ||local - center||_2")

    # -- identity -----------------------------------------------------------
    @staticmethod
    def worker_of(payload: dict):
        """Worker identity of a commit payload: the stamped ``worker``
        index when present, else parsed from the ``commit_id`` the
        stamping client mints (``w<idx>:<counter>``), else None."""
        w = payload.get("worker")
        if w is not None:
            return w
        cid = payload.get("commit_id")
        if isinstance(cid, str) and cid.startswith("w"):
            head = cid.split(":", 1)[0][1:]
            if head.isdigit():
                return int(head)
        return None

    def _worker(self, worker) -> _WorkerStats:
        key = "?" if worker is None else worker
        st = self._workers.get(key)
        if st is None:
            st = self._workers[key] = _WorkerStats(self._window)
        return st

    # -- PS-side observation ------------------------------------------------
    def observe_commit(self, protocol, center, num_updates: int,
                       payload: dict, num_workers: int) -> None:
        """Record one commit, called by the PS loop BEFORE the protocol
        applies it (``center``/``num_updates`` are the pre-commit state
        the staleness and divergence definitions need). Swallows every
        exception — a telemetry bug must not wedge the PS."""
        try:
            stats = protocol.commit_stats(
                center, num_updates, payload, num_workers)
            self.record_commit(worker=self.worker_of(payload), **stats)
        except Exception:
            self._errors += 1
            if self._errors == 1:
                logging.getLogger(__name__).exception(
                    "training-health observe_commit failed (suppressed "
                    "from now on)")

    def record_commit(self, worker=None, staleness: int | None = None,
                      damping: float = 1.0,
                      update_norm: float | None = None,
                      divergence: float | None = None) -> None:
        now = time.time()
        with self._lock:
            st = self._worker(worker)
            st.commits += 1
            st.last_commit_t = now
            st.commit_times.append(now)
            if staleness is not None:
                staleness = int(staleness)
                st.last_staleness = staleness
                st.staleness.append(staleness)
                self._staleness.append(staleness)
            if update_norm is not None:
                self._update_norms.append(float(update_norm))
                self._update_mass += float(update_norm)
                self._applied_mass += float(update_norm) * float(damping)
            if divergence is not None:
                st.last_divergence = float(divergence)
                self._divergence = float(divergence)
        if self._c_commits is not None:
            self._c_commits.inc()
            if staleness is not None:
                # Exemplar: the worker whose commit set this bucket's
                # worst sample — a staleness p99 spike names its source.
                self._h_staleness.observe(
                    staleness, exemplar=f"worker:{worker}")
            if update_norm is not None:
                self._h_norm.observe(float(update_norm))
                self._c_mass.inc(float(update_norm))
                self._c_applied.inc(float(update_norm) * float(damping))
                mass = self._c_mass.value
                if mass > 0:
                    self._g_goodput.set(self._c_applied.value / mass)
            if divergence is not None:
                self._h_divergence.observe(float(divergence),
                                           exemplar=f"worker:{worker}")
                self._g_divergence.set(float(divergence))

    def record_duplicate(self, payload: dict) -> None:
        with self._lock:
            self._worker(self.worker_of(payload)).duplicates += 1
        if self._c_dups is not None:
            self._c_dups.inc()

    # -- worker-side observation --------------------------------------------
    def record_pull(self, worker) -> None:
        with self._lock:
            self._worker(worker).pulls += 1
        if self._c_pulls is not None:
            self._c_pulls.inc()

    def record_rebase(self, worker) -> None:
        with self._lock:
            self._worker(worker).rebases += 1
        if self._c_rebases is not None:
            self._c_rebases.inc()

    def record_window(self, worker, steps: int = 1) -> None:
        """One completed local window of ``steps`` optimizer steps —
        the worker-side work counter statusz pairs against commits (a
        worker stepping but not committing is wedged in the exchange,
        not the compute)."""
        with self._lock:
            st = self._worker(worker)
            st.windows += 1
            st.steps += int(steps)

    # -- context ------------------------------------------------------------
    def attach_ps(self, service) -> None:
        """Attach the live PS service so statusz can fold in its
        ``health()`` rollup (queue depth, update counter, liveness)."""
        self._ps = service

    def set_params_bytes(self, n: int) -> None:
        self._params_bytes = int(n)

    # -- rollups ------------------------------------------------------------
    @property
    def divergence(self) -> float | None:
        return self._divergence

    @property
    def goodput_ratio(self) -> float | None:
        with self._lock:
            if self._update_mass <= 0:
                return None
            return self._applied_mass / self._update_mass

    def staleness_percentiles(self, qs=(50, 90, 99)) -> dict:
        with self._lock:
            xs = list(self._staleness)
        if not xs:
            return {}
        out = {f"p{q}": percentile(xs, q) for q in qs}
        out["max"] = float(max(xs))
        out["samples"] = len(xs)
        return out

    def statusz(self) -> dict:
        """JSON-able snapshot: global staleness/divergence/goodput, the
        per-worker vitals table, the PS rollup, and a per-device memory
        table."""
        now = time.time()
        with self._lock:
            workers = []
            for key in sorted(self._workers, key=str):
                st = self._workers[key]
                row = {
                    "worker": key,
                    "commits": st.commits,
                    "duplicates": st.duplicates,
                    "pulls": st.pulls,
                    "rebases": st.rebases,
                    "windows": st.windows,
                    "steps": st.steps,
                    "last_commit_age_s": (
                        round(now - st.last_commit_t, 3)
                        if st.last_commit_t is not None else None),
                    "last_staleness": st.last_staleness,
                }
                if st.staleness:
                    xs = list(st.staleness)
                    row["staleness_p50"] = round(percentile(xs, 50), 2)
                    row["staleness_p99"] = round(percentile(xs, 99), 2)
                if st.last_divergence is not None:
                    row["divergence"] = round(st.last_divergence, 6)
                if len(st.commit_times) >= 2:
                    span_s = st.commit_times[-1] - st.commit_times[0]
                    if span_s > 0:
                        row["commit_rate_per_s"] = round(
                            (len(st.commit_times) - 1) / span_s, 3)
                workers.append(row)
            out = {
                "t": now,
                "protocol": self.protocol,
                "num_workers": self.num_workers,
                "uptime_s": round(now - self._t0, 3),
                "workers": workers,
                "observe_errors": self._errors,
            }
            if self._update_mass > 0:
                out["goodput"] = {
                    "update_mass": round(self._update_mass, 6),
                    "applied_mass": round(self._applied_mass, 6),
                    "ratio": round(
                        self._applied_mass / self._update_mass, 6),
                }
            if self._divergence is not None:
                out["divergence"] = round(self._divergence, 6)
        stale = self.staleness_percentiles()
        if stale:
            out["staleness"] = {
                k: (round(v, 2) if isinstance(v, float) else v)
                for k, v in stale.items()}
        if self._ps is not None:
            try:
                out["ps"] = self._ps.health()
            except Exception:
                out["ps"] = {"unreachable": True}
        out["memory"] = self.refresh_memory()
        return out

    def refresh_memory(self) -> list[dict]:
        """One row per CUDA device (``torch.cuda.mem_get_info`` and the
        caching allocator's counters); no rows without CUDA. Never raises:
        a failed probe gives no rows."""
        try:
            if not torch.cuda.is_available():
                return []
            rows = []
            for i in range(torch.cuda.device_count()):
                free, total = torch.cuda.mem_get_info(i)
                rows.append({
                    "device": f"cuda:{i}",
                    "available": True,
                    "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                    "bytes_free": int(free),
                    "bytes_limit": int(total),
                    "params_bytes": self._params_bytes,
                })
            return rows
        except Exception:
            return []
