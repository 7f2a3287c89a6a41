"""Continuous deployment: the async trainers feed the serving fleet.

Counterpart of the reference's ``distkeras_tpu/deploy`` package.

dist-keras's identity is asynchronous data-parallel training
(DOWNPOUR/ADAG/EASGD), and the related systems (DeepSpark, SparkNet) are
built around *periodic weight exchange at scale*. This package connects
the trainers and the serving cluster, turning the repo from "a trainer and a
server" into one online-learning system:

- :class:`WeightPublisher` / :class:`PublishPolicy` — the trainer side.
  A trainer given ``--publish-dir``/``--publish-every`` atomically
  publishes stamped weight files plus a ``MANIFEST.json``
  (:func:`distkeras_tpu_torch.checkpoint.publish_weights`) on a step or
  wall-clock cadence, optionally gated on loss improvement; watchers
  never read a torn publish.
- :class:`DeployController` — the serving side. Watches the manifest,
  **validates** each candidate (manifest/file digest agreement, leaf
  shape/dtype against the fleet's model), runs a **canary** (drain one
  replica, reload it, score a golden prompt set for finite loss,
  greedy self-parity, and a latency budget), then drives the router's
  existing zero-downtime ``rolling_reload``. A canary failure or a
  post-roll fleet regression **rolls back** to the last-good version
  and quarantines the bad file with a reason record. State (current /
  last-good / candidate, a history ring of deploy outcomes) is served
  by the router's ``deployz`` verb and ``run.py deployz``; every deploy
  is a counter + latency-histogram event in ``metricsz`` and a traced
  timeline (``tracez deploy-v<N>``).
- :mod:`.harness` — ``run.py deploy`` wiring: a ProcessReplica fleet +
  router + controller over one publish directory, and the in-process
  loop ``benchmarks/deploy_bench.py`` drives for the sustained-churn
  numbers.

The safety invariants, end to end: at most one replica is ever out of
routing (>= N-1 serving through canary and roll alike), a bad checkpoint
never reaches more than the drained canary, every response still names
the exact ``(version, digest)`` that produced it, and the compiled
decode step never retraces across any number of deploys (armed
``RecompileAuditor`` holds).
"""

from distkeras_tpu_torch.deploy.publisher import (
    PublishPolicy,
    WeightPublisher,
    parse_publish_every,
)
from distkeras_tpu_torch.deploy.controller import (
    CanaryFailure,
    DeployController,
    ValidationFailure,
)

__all__ = [
    "WeightPublisher",
    "PublishPolicy",
    "parse_publish_every",
    "DeployController",
    "CanaryFailure",
    "ValidationFailure",
]
