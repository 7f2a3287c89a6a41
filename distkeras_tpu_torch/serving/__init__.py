"""Online serving on the port: the continuous-batching engine, dense and
paged.

Counterpart of the reference's ``distkeras_tpu/serving`` package on one
device (ROADMAP.md §A items A7 and A7b):

- :class:`ServingEngine`: fixed-slot continuous batching over the decode
  mode of ``models/bert.py``, with chunked prefill, the overlapped decode
  pipeline, dense per-slot caches with a prefix cache or a paged block
  pool with preemption, the ``score``/``embed``/``sample`` request kinds,
  constrained and speculative decoding, and the parameter swap;
- :class:`PrefixCache` and :class:`KVBlockPool`: the dense engine's
  device-resident pool of KV blocks and the paged engine's block
  allocator, both keyed by a radix trie over prompt prefixes;
- :class:`TokenDFA`: the token automaton of a constrained request;
- :class:`Scheduler` / :class:`Request`: priority-FIFO admission with
  backpressure, deadlines, tenant quotas and cache-aware reordering;
- :class:`ServingServer` / :class:`ServingClient`: the asyncio TCP front
  end, newline-delimited JSON or the negotiated bin1 frames;
- :class:`ServingMetrics`: TTFT, inter-token latency, occupancy and the
  decode pipeline's host gap;
- :mod:`~distkeras_tpu_torch.serving.cluster` (item A8): the fleet —
  :class:`ServingCluster` (the :class:`Router` front port and the
  :class:`ReplicaSupervisor`'s restarts) over :class:`LocalReplica` or
  :class:`ProcessReplica` replicas, with prefix-affine routing, retry of
  zero-streamed requests, rolling reloads and disaggregated
  prefill/decode roles;
- :mod:`~distkeras_tpu_torch.serving.kv_transfer`: the KVX1 block codec,
  its chunk frames and the peer pull/push clients (typed
  :class:`KVTransferError` rejects); :mod:`.kv_tier`: the host and disk
  KV tiers under the paged pool;
- :class:`SLOEngine` / :class:`Objective`: burn-rate SLOs over the fleet's
  pushed telemetry.
"""

from distkeras_tpu_torch.serving.scheduler import (
    EngineStopped,
    PoolExhausted,
    QueueFullError,
    Request,
    RequestCancelled,
    RequestTimeout,
    Scheduler,
    ServingError,
    TenantOverQuota,
    TenantQuota,
)
from distkeras_tpu_torch.serving.kv_transfer import KVTransferError
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.slo import Objective, SLOEngine, default_objectives
from distkeras_tpu_torch.serving.prefix_cache import KVBlockPool, PrefixCache
from distkeras_tpu_torch.serving.constraints import TokenDFA
from distkeras_tpu_torch.serving.engine import ServingEngine
from distkeras_tpu_torch.serving.server import ServingServer
from distkeras_tpu_torch.serving.client import ServingClient
from distkeras_tpu_torch.serving.cluster import (
    LocalReplica,
    ProcessReplica,
    ReplicaSupervisor,
    Router,
    ServingCluster,
)

__all__ = [
    "ServingEngine",
    "PrefixCache",
    "KVBlockPool",
    "TokenDFA",
    "PoolExhausted",
    "Scheduler",
    "Request",
    "ServingServer",
    "ServingClient",
    "ServingMetrics",
    "ServingError",
    "QueueFullError",
    "RequestTimeout",
    "RequestCancelled",
    "EngineStopped",
    "TenantOverQuota",
    "TenantQuota",
    "ServingCluster",
    "Router",
    "ReplicaSupervisor",
    "LocalReplica",
    "ProcessReplica",
    "KVTransferError",
    "SLOEngine",
    "Objective",
    "default_objectives",
]
