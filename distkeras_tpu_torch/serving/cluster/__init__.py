"""Multi-replica serving cluster: router, supervisor, rolling reloads.

Copy of the reference's ``distkeras_tpu/serving/cluster/__init__.py``;
only its imports differ.

dist-keras's core shape — a thin driver keeping a fleet of workers
productive through individual failures — applied to the serving side.
One process per replica (or one engine per replica in-process for
tests/benches), a :class:`ReplicaSupervisor` that restarts the dead with
capped backoff, and a :class:`Router` on a single front port that speaks
the same JSONL wire protocol as a lone
:class:`~distkeras_tpu_torch.serving.server.ServingServer`:

- least-outstanding routing with prefix-cache affinity (a prompt
  family's shared prefix keeps landing on the replica holding its KV
  blocks);
- zero-streamed requests are transparently retried on a surviving
  replica when a backend dies mid-request;
- ``{"cmd": "reload", "weights": path}`` rolls new weights through the
  fleet one replica at a time (drain -> swap -> rewarm -> readmit) with
  no dropped streams and never fewer than N-1 replicas serving.

Start one with ``python -m distkeras_tpu_torch.run serve --replicas N`` (or
the ``cluster`` subcommand), or in-process via :class:`ServingCluster`.
"""

from distkeras_tpu_torch.serving.cluster.replicas import (
    DEAD,
    DRAINING,
    READY,
    STARTING,
    LocalReplica,
    ProcessReplica,
    ReplicaHandle,
    ReplicaInfo,
    probe_healthz,
)
from distkeras_tpu_torch.serving.cluster.supervisor import (
    ReplicaSupervisor,
    parse_roles,
)
from distkeras_tpu_torch.serving.cluster.router import Router, ServingCluster

__all__ = [
    "ServingCluster",
    "Router",
    "ReplicaSupervisor",
    "parse_roles",
    "ReplicaHandle",
    "ReplicaInfo",
    "LocalReplica",
    "ProcessReplica",
    "probe_healthz",
    "STARTING",
    "READY",
    "DRAINING",
    "DEAD",
]
