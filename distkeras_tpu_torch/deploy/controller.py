"""DeployController: manifest watch -> validate -> canary -> roll -> verify.

Copy of the reference's ``distkeras_tpu/deploy/controller.py``; only its
imports differ, and the template check walks the port's flattened
parameter names (``layer_0.attention.query.weight``, ...) with their shapes
and dtypes where the reference walks ``jax.tree.leaves``.

The serving half of the continuous-deployment loop. One controller per
cluster router, driving the safety pipeline for every version a trainer
publishes:

1. **watch** — poll the publish directory's atomic ``MANIFEST.json``
   (:func:`distkeras_tpu_torch.checkpoint.read_manifest`); a version newer
   than the last one processed becomes the *candidate*.
2. **validate** (host-side, no replica touched) — one read of the
   candidate file pairs arrays with their stamp; the file digest must
   agree with the manifest (a ripped copy or tampered file fails here),
   and with a ``template`` the leaf structure/shapes/dtypes must match
   the fleet's model exactly (the same check every replica's
   ``request_param_swap`` enforces, failed once centrally instead of N
   times mid-roll).
3. **canary** — borrow ONE replica: mark it DRAINING (the router stops
   routing to it; the fleet serves on N-1, same budget as a rolling
   reload), wait out its in-flight work, hot-swap it onto the candidate,
   then score the **golden prompt set** straight against that replica:
   every prompt must complete inside the latency budget, twice, with
   identical greedy output (self-parity — a deterministic decode that
   disagrees with itself is broken), and the optional ``score_fn``
   (e.g. golden-batch loss under the candidate weights) must be finite.
   On failure the canary replica is restored to the last-good weights
   and readmitted; the bad file is **quarantined** with a reason record.
4. **roll** — the router's existing zero-downtime ``rolling_reload``
   takes the vetted candidate across the fleet (the canary replica's
   second swap is a no-op-shaped idempotent reload).
5. **verify** — the roll's own per-replica outcome plus a fleet healthz:
   every replica must report the candidate's ``(version, digest)``. Any
   failure triggers **rollback** — a rolling reload back to last-good —
   and quarantine.

Every deploy is one counter + latency-histogram observation in the
metrics registry, one :class:`TimelineRecord` (trace id
``deploy-v<N>``) in the router's trace store, and one entry in the
bounded history ring the ``deployz`` verb serves.
"""

from __future__ import annotations

import asyncio
import collections
import json
import math
import os
import shutil
import time

import numpy as np

from distkeras_tpu_torch.serving.cluster.replicas import DRAINING, READY
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.telemetry.request_trace import TimelineRecord

__all__ = ["DeployController", "CanaryFailure", "ValidationFailure"]


def _check_template(template, variables) -> None:
    """The candidate's leaves against the fleet model's, by the port's
    flattened parameter names: the same names, and each leaf's shape and
    dtype. Raises :class:`ValidationFailure` on the first difference."""
    from distkeras_tpu_torch.utils.bridge import as_state_dict

    try:
        got = as_state_dict(variables)
    except Exception as e:
        raise ValidationFailure(
            f"candidate is not a weight tree of this model family: {e!r}") from e
    want = as_state_dict(template)
    if len(got) != len(want) or set(got) != set(want):
        missing = sorted(set(want) - set(got))[:4]
        extra = sorted(set(got) - set(want))[:4]
        raise ValidationFailure(
            f"candidate has {len(got)} leaves; fleet model has {len(want)} "
            f"(missing {missing}, unexpected {extra})")
    for name, b in want.items():
        a = got[name]
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValidationFailure(
                f"candidate leaf {name} is "
                f"{str(a.dtype).removeprefix('torch.')}{tuple(a.shape)}; fleet "
                f"model expects {str(b.dtype).removeprefix('torch.')}"
                f"{tuple(b.shape)}")


class ValidationFailure(Exception):
    """Candidate rejected before touching any replica."""


class CanaryFailure(Exception):
    """Candidate rejected by the canary replica's golden-set score."""


class DeployController:
    """Watch a publish directory and safely roll each version through a
    :class:`~distkeras_tpu_torch.serving.cluster.router.Router`'s fleet.

    ``template``: a variables pytree with the fleet model's exact leaf
    structure (e.g. ``model.init(0)`` or the boot weights) — enables the
    host-side shape/dtype validation; None skips it (the replica-side
    reload validation still applies). ``golden_prompts``: token-id lists
    scored on the canary; empty disables replica scoring (validation +
    score_fn still run). ``score_fn(variables) -> float``: optional
    host-side scalar (golden-batch loss); a non-finite value fails the
    canary. ``initial_weights``: path the fleet booted from — the
    rollback target before the first successful deploy.

    ``auto_rollback_on_verify``: roll back to last-good when the
    post-roll fleet check fails (default True).
    """

    def __init__(
        self,
        router,
        watch_dir: str,
        *,
        template=None,
        golden_prompts: list | None = None,
        golden_new_tokens: int = 4,
        canary_latency_s: float = 30.0,
        score_fn=None,
        initial_weights: str | None = None,
        poll_interval_s: float = 0.5,
        swap_timeout_s: float = 120.0,
        drain_timeout_s: float = 60.0,
        history: int = 64,
        registry=None,
        trace_store=None,
        quarantine_dir: str | None = None,
        auto_rollback_on_verify: bool = True,
        canary_tenant: str = "canary",
    ):
        self.router = router
        self.supervisor = router.supervisor
        self.watch_dir = watch_dir
        self.template = template
        self.golden_prompts = [list(map(int, p))
                               for p in (golden_prompts or [])]
        self.golden_new_tokens = int(golden_new_tokens)
        self.canary_latency_s = float(canary_latency_s)
        # The QoS identity canary traffic runs under: attributable in
        # every per-tenant metric, and deliberately outside the
        # production quota set (a quota-shed canary would veto deploys).
        self.canary_tenant = str(canary_tenant)
        self.score_fn = score_fn
        self.poll_interval_s = float(poll_interval_s)
        self.swap_timeout_s = float(swap_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.quarantine_dir = quarantine_dir or os.path.join(
            watch_dir, "quarantine")
        # Controller-owned staging: every candidate is hard-linked (or
        # copied) here before any replica touches it, and current/
        # last-good point at the STAGED files. The publisher's bounded
        # retention prunes the watch dir on ITS cadence — without
        # staging, a slow deploy (first-compile canaries, big fleets)
        # can lose the race and roll a path the pruner just deleted.
        self.staging_dir = os.path.join(watch_dir, "staging")
        self.auto_rollback_on_verify = bool(auto_rollback_on_verify)
        self.trace_store = (trace_store if trace_store is not None
                            else router.trace_store)

        # Deployed state: `current` is what the fleet serves NOW (path +
        # provenance), `last_good` the rollback target (== current after
        # a successful deploy), `candidate` the in-flight attempt.
        if initial_weights and os.path.exists(initial_weights):
            # Boot weights get staged too: the first rollback target
            # must outlive the publisher's pruner exactly like any
            # deployed version.
            try:
                initial_weights = self._stage(initial_weights)
            except OSError:
                pass
        self.current: dict | None = (
            self._prov_of(initial_weights) if initial_weights else None)
        self.last_good: dict | None = (dict(self.current)
                                       if self.current else None)
        self.candidate: dict | None = None
        self.history: collections.deque = collections.deque(maxlen=history)
        self.quarantined: collections.deque = collections.deque(maxlen=32)
        self._seen_version = (self.current or {}).get("version", 0) or 0
        self._stopping = asyncio.Event()
        self.deploys = 0
        self.canary_failures = 0
        self.validation_failures = 0
        self.rollbacks = 0
        self._c_deploys = self._c_canary_fail = self._c_rollbacks = None
        self._c_validate_fail = self._h_latency = self._g_version = None
        if registry is not None:
            self._c_deploys = registry.counter(
                "deploy_total", help="successful fleet deploys")
            self._c_canary_fail = registry.counter(
                "deploy_canary_failures_total",
                help="candidates rejected by the canary replica")
            self._c_validate_fail = registry.counter(
                "deploy_validation_failures_total",
                help="candidates rejected by host-side validation")
            self._c_rollbacks = registry.counter(
                "deploy_rollbacks_total",
                help="rolls reverted to the last-good version")
            self._h_latency = registry.histogram(
                "deploy_latency_seconds",
                help="manifest-seen to fleet-verified deploy latency",
                buckets=(0.5, 1, 2, 5, 10, 30, 60, 120, 300))
            self._g_version = registry.gauge(
                "deploy_current_version",
                help="weight version the controller last verified fleet-"
                     "wide")
            if self.current and self.current.get("version"):
                self._g_version.set(self.current["version"])

    # -- helpers ------------------------------------------------------------
    def _stage(self, path: str) -> str:
        """Pin ``path`` into the staging dir (hard link when the
        filesystem allows, byte copy otherwise) and return the staged
        path. Raises OSError if the source vanished — the publisher
        pruned it before we could pin it, which IS a missed candidate
        (the next publish retries)."""
        os.makedirs(self.staging_dir, exist_ok=True)
        dest = os.path.join(self.staging_dir, os.path.basename(path))
        if os.path.exists(dest):
            return dest
        try:
            os.link(path, dest)
        except OSError:
            shutil.copy2(path, dest)
        return dest

    def _prune_staging(self) -> None:
        """Drop staged files no deploy state references (best-effort)."""
        keep = {os.path.basename(s["path"])
                for s in (self.current, self.last_good, self.candidate)
                if s and s.get("path")}
        try:
            names = os.listdir(self.staging_dir)
        except OSError:
            return
        for name in names:
            if name not in keep:
                try:
                    os.unlink(os.path.join(self.staging_dir, name))
                except OSError:
                    pass

    @staticmethod
    def _prov_of(path: str) -> dict:
        from distkeras_tpu_torch.checkpoint import weights_provenance

        try:
            return weights_provenance(path)
        except OSError:
            return {"version": 0, "digest": None, "path": path}

    def stop(self) -> None:
        self._stopping.set()

    # -- watch loop ---------------------------------------------------------
    async def run(self) -> None:
        """Poll the manifest until :meth:`stop`; deploy every new
        version exactly once (failures are recorded, not retried — the
        NEXT publish is the retry, which is what a trainer on a cadence
        provides for free)."""
        from distkeras_tpu_torch.checkpoint import read_manifest

        while not self._stopping.is_set():
            manifest = read_manifest(self.watch_dir)
            if (manifest and int(manifest.get("version", 0))
                    > self._seen_version):
                await self.deploy(manifest)
            try:
                await asyncio.wait_for(self._stopping.wait(),
                                       self.poll_interval_s)
            except asyncio.TimeoutError:
                pass

    async def poll_once(self) -> dict | None:
        """One watch-loop iteration (tests and benches drive this for
        deterministic pacing). Returns the deploy outcome, or None when
        the manifest holds nothing new."""
        from distkeras_tpu_torch.checkpoint import read_manifest

        manifest = read_manifest(self.watch_dir)
        if manifest and int(manifest.get("version", 0)) > self._seen_version:
            return await self.deploy(manifest)
        return None

    # -- the deploy pipeline ------------------------------------------------
    async def deploy(self, manifest: dict) -> dict:
        """Run one candidate through validate -> canary -> roll ->
        verify. Returns (and records) the outcome entry."""
        version = int(manifest.get("version", 0))
        path = orig_path = manifest.get("path")
        t0 = time.monotonic()
        trace = TimelineRecord(f"deploy-v{version}", "deploy", "controller")
        trace.event("manifest_seen", version=version,
                    digest=manifest.get("digest"), step=manifest.get("step"),
                    loss=manifest.get("loss"))
        self._seen_version = version
        # Pin the candidate NOW: from here on the pipeline (validate,
        # canary, roll, a later rollback) reads the controller's staged
        # copy, immune to the publisher pruning the watch dir mid-deploy.
        if path and os.path.exists(path):
            try:
                staged = self._stage(path)
                if staged != path:
                    trace.event("staged", path=os.path.basename(staged))
                path = staged
                manifest = {**manifest, "path": path}
            except OSError:
                pass  # source pruned under us: the exists-check below
                # turns this into a clean validation failure
        self.candidate = {"version": version,
                          "digest": manifest.get("digest"), "path": path}
        entry = {"version": version, "digest": manifest.get("digest"),
                 "path": path, "step": manifest.get("step"),
                 "loss": manifest.get("loss"), "t": time.time()}
        try:
            with span("deploy", version=version):
                await self._deploy_inner(manifest, trace, entry)
            entry["status"] = "deployed"
            self.deploys += 1
            if self._c_deploys is not None:
                self._c_deploys.inc()
            if self._g_version is not None:
                self._g_version.set(version)
            self.current = {"version": version,
                            "digest": manifest.get("digest"), "path": path}
            self.last_good = dict(self.current)
            trace.data["status"] = "deployed"
        except ValidationFailure as e:
            self.validation_failures += 1
            if self._c_validate_fail is not None:
                self._c_validate_fail.inc()
            entry["status"] = "validation_failed"
            entry["reason"] = str(e)
            trace.event("validation_failed", reason=str(e))
            trace.data["status"] = "validation_failed"
            self._quarantine(path, version, f"validation: {e}",
                             orig_path=orig_path)
        except CanaryFailure as e:
            self.canary_failures += 1
            if self._c_canary_fail is not None:
                self._c_canary_fail.inc()
            entry["status"] = "canary_rejected"
            entry["reason"] = str(e)
            trace.event("canary_rejected", reason=str(e))
            trace.data["status"] = "canary_rejected"
            self._quarantine(path, version, f"canary: {e}",
                             orig_path=orig_path)
        except Exception as e:
            # Reached the roll and failed -> rolled back (file suspect:
            # quarantine). Never reached a replica (e.g. fleet down) ->
            # plain failure; the file stays publishable so the trainer's
            # next manifest (or an operator retry) can deploy it.
            rolled = "rolled" in entry
            entry["status"] = "rolled_back" if rolled else "failed"
            entry["reason"] = str(e)
            trace.event("rolled_back" if rolled else "failed",
                        reason=str(e))
            trace.data["status"] = entry["status"]
            if rolled:
                self._quarantine(path, version, f"post-roll: {e}",
                                 orig_path=orig_path)
        finally:
            self.candidate = None
            self._prune_staging()
            latency = time.monotonic() - t0
            entry["latency_s"] = round(latency, 3)
            # Histogram = manifest-seen -> fleet-VERIFIED, deployed
            # outcomes only: a trainer churning out bad checkpoints
            # (rejected host-side in milliseconds) must not drag the
            # p95 an operator alerts on down below the real deploys.
            # Per-outcome latency survives in the history ring.
            # .get: a BaseException (task cancelled mid-deploy) reaches
            # this finally with no status set and must not be masked.
            if (self._h_latency is not None
                    and entry.get("status") == "deployed"):
                self._h_latency.observe(latency)
            trace.data["version"] = version
            trace.data["latency_s"] = round(latency, 3)
            trace.event("done", status=entry.get("status"), dur_s=latency)
            if self.trace_store is not None:
                self.trace_store.put(trace)
            self.history.append(entry)
        return entry

    async def _deploy_inner(self, manifest: dict, trace: TimelineRecord,
                            entry: dict) -> None:
        path = manifest.get("path")
        if not path or not os.path.exists(path):
            raise ValidationFailure(f"manifest names a missing file: "
                                    f"{path!r}")
        variables = await asyncio.get_running_loop().run_in_executor(
            None, self._validate_sync, manifest)
        trace.event("validated")
        canary_rid = await self._canary(path, variables, trace, entry)
        await self._roll_and_verify(manifest, canary_rid, trace, entry)

    # -- stage 2: host-side validation --------------------------------------
    def _validate_sync(self, manifest: dict):
        """Executor half of validation: ONE read pairs arrays with their
        stamp; digest and (with a template) leaf shapes/dtypes checked
        before any replica is touched. Returns the loaded variables (the
        canary's score_fn reuses them — no second read)."""
        from distkeras_tpu_torch.checkpoint import load_weights_file_with_provenance

        path = manifest["path"]
        try:
            variables, prov = load_weights_file_with_provenance(path)
        except Exception as e:
            raise ValidationFailure(f"unreadable weights file: {e!r}") from e
        want = manifest.get("digest")
        if want and prov.get("digest") != want:
            raise ValidationFailure(
                f"digest mismatch: manifest says {want}, file bytes are "
                f"{prov.get('digest')} (torn or tampered publish)")
        if self.template is not None:
            _check_template(self.template, variables)
        return variables

    # -- stage 3: canary -----------------------------------------------------
    def _pick_canary(self):
        ready = [r for r in self.supervisor.replicas.values()
                 if r.status == READY]
        if len(ready) < 1:
            raise RuntimeError("no READY replica to canary on")
        # Least outstanding work thrown out of routing; ties break on rid
        # so repeated deploys spread deterministically.
        return min(ready, key=lambda r: (r.outstanding, r.rid))

    async def _canary(self, path: str, variables, trace: TimelineRecord,
                      entry: dict) -> str:
        """Drain one replica, reload it onto the candidate, score the
        golden set against it. Returns the canary rid on success;
        restores the replica and raises :class:`CanaryFailure` on any
        miss. The replica is readmitted READY either way."""
        # Host-side score first: it needs no replica, so a non-finite
        # golden loss never even drains one.
        if self.score_fn is not None:
            try:
                score = float(await asyncio.get_running_loop()
                              .run_in_executor(None, self.score_fn,
                                               variables))
            except CanaryFailure:
                raise
            except Exception as e:
                raise CanaryFailure(f"score_fn failed: {e!r}") from e
            entry["golden_score"] = (score if math.isfinite(score)
                                     else str(score))
            trace.event("scored", score=entry["golden_score"])
            if not math.isfinite(score):
                raise CanaryFailure(
                    f"golden score is not finite: {score}")
        info = self._pick_canary()
        trace.event("canary_drain", replica=info.rid)
        entry["canary"] = info.rid
        info.status = DRAINING
        try:
            deadline = time.monotonic() + self.drain_timeout_s
            while info.outstanding > 0:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"canary drain timed out with {info.outstanding} "
                        f"outstanding")
                await asyncio.sleep(0.01)
            with span("canary_reload", replica=info.rid):
                rep = await self.router._backend_control(
                    info, {"cmd": "reload", "weights": path,
                           "timeout": self.swap_timeout_s},
                    timeout=self.swap_timeout_s + 10.0)
            if "error" in rep:
                raise CanaryFailure(
                    f"canary replica {info.rid} refused the reload: "
                    f"{rep['error']}")
            trace.event("canary_reloaded", replica=info.rid)
            try:
                results = await self._score_golden(info, trace)
            except CanaryFailure:
                await self._restore_canary(info, trace)
                raise
            entry["canary_golden"] = results
            trace.event("canary_passed", prompts=len(self.golden_prompts))
            return info.rid
        except (OSError, asyncio.TimeoutError, ValueError,
                RuntimeError) as e:
            # Transport/drain trouble around the canary is a candidate
            # rejection too — with the replica restored if we got as far
            # as swapping it.
            await self._restore_canary(info, trace)
            raise CanaryFailure(str(e)) from e
        finally:
            if info.status == DRAINING:
                info.status = READY

    async def _score_golden(self, info, trace: TimelineRecord) -> dict:
        """Golden-set scoring against the (drained) canary replica:
        every prompt completes twice within the latency budget with
        identical greedy output."""
        latencies = []
        for i, prompt in enumerate(self.golden_prompts):
            first, t_first = await self._generate_direct(info, prompt)
            second, t_second = await self._generate_direct(info, prompt)
            latencies.append(max(t_first, t_second))
            if first != second:
                raise CanaryFailure(
                    f"golden prompt {i}: greedy self-parity violated "
                    f"({first[:8]}... vs {second[:8]}...)")
            worst = max(t_first, t_second)
            if worst > self.canary_latency_s:
                raise CanaryFailure(
                    f"golden prompt {i}: {worst:.3f}s exceeds the "
                    f"{self.canary_latency_s}s canary latency budget")
        return {"prompts": len(self.golden_prompts),
                "max_latency_s": round(max(latencies), 4) if latencies
                else None}

    async def _generate_direct(self, info, prompt: list) -> tuple[list,
                                                                  float]:
        """One greedy generation straight against the canary replica
        over a :class:`ServingClient` pointed at its own port (bypasses
        routing — the replica is DRAINING, deliberately invisible to
        the router's pick). No transport retry: a canary that needs one
        has failed."""
        from distkeras_tpu_torch.serving.client import ServingClient
        from distkeras_tpu_torch.serving.scheduler import ServingError

        budget = self.canary_latency_s + 5.0
        t0 = time.monotonic()
        try:
            async with ServingClient(info.host, info.port,
                                     max_retries=0) as client:
                done = await asyncio.wait_for(
                    client.generate(prompt, self.golden_new_tokens,
                                    temperature=0.0,
                                    tenant=self.canary_tenant,
                                    trace_id=f"canary-{info.rid}"),
                    budget)
        except asyncio.TimeoutError as e:
            raise CanaryFailure(
                f"canary stream stalled past {budget:.1f}s") from e
        except ServingError as e:
            raise CanaryFailure(
                f"canary errored on a golden prompt: {e} "
                f"({getattr(e, 'code', 'error')})") from e
        except (OSError, ConnectionError, ValueError) as e:
            raise CanaryFailure(f"canary unreachable: {e}") from e
        return list(done.get("tokens", [])), time.monotonic() - t0

    async def _restore_canary(self, info, trace: TimelineRecord) -> None:
        """Put the canary replica back on the last-good weights. With no
        last-good FILE (inline-booted fleet, nothing deployed yet) the
        replica is killed instead — the supervisor's restart brings back
        a fresh factory-boot replica, which IS the pre-deploy state."""
        target = (self.last_good or {}).get("path")
        if target and os.path.exists(target):
            try:
                rep = await self.router._backend_control(
                    info, {"cmd": "reload", "weights": target,
                           "timeout": self.swap_timeout_s},
                    timeout=self.swap_timeout_s + 10.0)
                if "error" not in rep:
                    trace.event("canary_restored", replica=info.rid,
                                weights=os.path.basename(target))
                    return
            except (OSError, ValueError, asyncio.TimeoutError):
                pass
        # No restorable file, or the restore itself failed: recycle the
        # replica through the supervisor (kill + fresh factory boot =
        # the pre-deploy state) rather than readmit bad weights.
        trace.event("canary_recycled", replica=info.rid)
        self.supervisor._on_dead(info, "deploy canary rollback")

    # -- stages 4+5: roll and verify ----------------------------------------
    async def _roll_and_verify(self, manifest: dict, canary_rid: str,
                               trace: TimelineRecord, entry: dict) -> None:
        path = manifest["path"]
        with span("rolling_reload", version=manifest.get("version")):
            rep = await self.router.rolling_reload(
                {"weights": path, "timeout": self.swap_timeout_s,
                 "drain_timeout": self.drain_timeout_s})
        roll = rep.get("reload", {})
        trace.event("rolled", reloaded=roll.get("reloaded"),
                    failed=list(roll.get("failed", {})) or None)
        entry["rolled"] = roll.get("reloaded", [])
        # Per-replica before/after stamps from the roll's own reply —
        # the deployz history shows each replica's version movement
        # without any extra fan-out.
        if roll.get("replicas"):
            entry["replicas_moved"] = roll["replicas"]
        if roll.get("failed"):
            await self._rollback(trace)
            raise RuntimeError(f"roll failed on {sorted(roll['failed'])}: "
                               f"{roll['failed']}")
        ok, detail = await self._verify_fleet(manifest)
        trace.event("verified", ok=ok)
        entry["verify"] = detail
        if not ok:
            if self.auto_rollback_on_verify:
                await self._rollback(trace)
            raise RuntimeError(f"post-roll verify failed: {detail}")

    async def _verify_fleet(self, manifest: dict,
                            attempts: int = 3) -> tuple[bool, dict]:
        """Fleet healthz: no routable replica may report any OTHER
        (version, digest), and at least one must confirm the
        candidate's. A probe that merely timed out (a loaded host, not a
        wrong version) is retried, then tolerated: an unreachable
        replica is the supervisor's problem — it gets restarted onto
        ``current_weights``, which the roll just moved to the candidate
        — whereas a CONFLICTING version is a failed roll and always
        fails verify.

        Sharded fleets: each replica's healthz carries its ``mesh``
        (axis sizes); a fleet whose routable replicas disagree on mesh
        shape is failed like a version conflict — a restart that came
        back unsharded (or on a different tp) would serve the same
        weights with a different memory/latency envelope than the
        canary vetted, silently."""
        want = f"{manifest.get('version')}:{manifest.get('digest')}"
        detail: dict = {"want": want}
        for attempt in range(attempts):
            health = (await self.router._control({"cmd": "healthz"})).get(
                "healthz", {})
            router_h = health.get("router", {})
            versions = router_h.get("weight_versions", {})
            routable = sum(1 for r in health.get("replicas", {}).values()
                           if r.get("status") in (READY, DRAINING))
            meshes: dict[str, str] = {}
            for rid, r in health.get("replicas", {}).items():
                if r.get("status") not in (READY, DRAINING):
                    continue
                sub = r.get("healthz")
                if isinstance(sub, dict):
                    axes = (sub.get("mesh") or {}).get("axes")
                    meshes[rid] = (json.dumps(axes, sort_keys=True)
                                   if axes else "unsharded")
            detail = {"weight_versions": versions,
                      "replicas_ready": router_h.get("replicas_ready"),
                      "want": want}
            if meshes:
                detail["meshes"] = meshes
            mesh_conflict = len(set(meshes.values())) > 1
            conflict = any(k != want for k in versions) or mesh_conflict
            confirmed = versions.get(want, 0)
            if not conflict and confirmed >= routable and routable >= 1:
                return True, detail
            if conflict or attempt == attempts - 1:
                if not conflict and confirmed >= 1:
                    detail["unconfirmed"] = routable - confirmed
                    return True, detail
                return False, detail
            await asyncio.sleep(0.5)
        return False, detail

    async def _rollback(self, trace: TimelineRecord) -> None:
        target = (self.last_good or {}).get("path")
        self.rollbacks += 1
        if self._c_rollbacks is not None:
            self._c_rollbacks.inc()
        if not target or not os.path.exists(target):
            trace.event("rollback_impossible")
            return
        with span("deploy_rollback", weights=target):
            rep = await self.router.rolling_reload(
                {"weights": target, "timeout": self.swap_timeout_s,
                 "drain_timeout": self.drain_timeout_s})
        trace.event("rollback",
                    weights=os.path.basename(target),
                    failed=list(rep.get("reload", {}).get("failed", {}))
                    or None)

    # -- quarantine ----------------------------------------------------------
    def _quarantine(self, path: str | None, version: int, reason: str,
                    orig_path: str | None = None) -> None:
        """Move a rejected candidate (the controller's staged copy) into
        the quarantine dir — the retention pruner must never make a bad
        file *disappear* before an operator reads it — with a reason
        record beside it. The publisher's original in the watch dir (a
        second name for the same bytes when staging hard-linked) is
        removed so a known-bad file doesn't linger where the next reader
        might trust it."""
        record = {"version": version, "reason": reason, "t": time.time(),
                  "path": path}
        try:
            if path and os.path.exists(path):
                os.makedirs(self.quarantine_dir, exist_ok=True)
                dest = os.path.join(self.quarantine_dir,
                                    os.path.basename(path))
                shutil.move(path, dest)
                record["quarantined_to"] = dest
                with open(dest + ".reason.json", "w") as f:
                    json.dump(record, f)
        except OSError as e:
            record["quarantine_error"] = str(e)
        if orig_path and orig_path != path:
            try:
                os.unlink(orig_path)
            except OSError:
                pass
        self.quarantined.append(record)

    # -- introspection -------------------------------------------------------
    def deployz(self) -> dict:
        """The controller state page the router's ``deployz`` verb (and
        ``run.py deployz``) serves."""
        return {
            "watch_dir": self.watch_dir,
            "current": self.current,
            "last_good": self.last_good,
            "candidate": self.candidate,
            "seen_version": self._seen_version,
            "counters": {
                "deploys": self.deploys,
                "canary_failures": self.canary_failures,
                "validation_failures": self.validation_failures,
                "rollbacks": self.rollbacks,
            },
            "golden_prompts": len(self.golden_prompts),
            "poll_interval_s": self.poll_interval_s,
            "history": list(self.history),
            "quarantined": list(self.quarantined),
        }
