"""Online serving on the port: the dense continuous-batching engine.

Counterpart of the reference's ``distkeras_tpu/serving`` package, the
dense single-device half (ROADMAP.md §A item A7):

- :class:`ServingEngine`: fixed-slot continuous batching over the decode
  mode of ``models/bert.py``, with chunked prefill, a prefix cache and the
  overlapped decode pipeline;
- :class:`PrefixCache`: a device-resident pool of fixed-size KV blocks
  keyed by a radix trie over prompt prefixes;
- :class:`Scheduler` / :class:`Request`: priority-FIFO admission with
  backpressure, deadlines, tenant quotas and cache-aware reordering;
- :class:`ServingServer` / :class:`ServingClient`: the asyncio TCP front
  end, newline-delimited JSON or the negotiated bin1 frames;
- :class:`ServingMetrics`: TTFT, inter-token latency, occupancy and the
  decode pipeline's host gap.

Paged KV (``KVBlockPool``) and the request kinds wait for item A7b; the
cluster, KV transfer and SLO engine for item A8.
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
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.prefix_cache import PrefixCache
from distkeras_tpu_torch.serving.engine import ServingEngine
from distkeras_tpu_torch.serving.server import ServingServer
from distkeras_tpu_torch.serving.client import ServingClient

__all__ = [
    "ServingEngine",
    "PrefixCache",
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
]
