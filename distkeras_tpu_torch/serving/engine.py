"""Continuous-batching decode engine: one decode step, rotating slots.

Port of the reference's ``distkeras_tpu/serving/engine.py`` on one device.
The offline path (:func:`distkeras_tpu_torch.inference.generate.generate`)
decodes a *closed* batch: every row starts together and the whole batch
runs ``max_new_tokens`` steps. An online server cannot do that: requests
arrive whenever they arrive, and draining the batch to admit one request
wastes every other slot's compute.

This engine keeps the shape discipline of the offline path (static device
state, ONE decode step of one abstract signature for the lifetime of the
server) while making the batch *open*:

- each of the ``slots`` rows of the decode batch is an independent
  request at its **own** sequence position;
- a finished request frees its row; a queued request is admitted between
  decode iterations by a **prefill**, padded to a power-of-two bucket of
  the prompt: the decode step never changes shape and never stops for
  admission;
- with **chunked prefill** (``prefill_chunk``), the prompt is split into
  fixed-size chunks and ONE chunk runs per engine iteration, interleaved
  with decode ticks, so admitting a long prompt never stalls the decode
  batch for more than one chunk's device time;
- free rows keep decoding garbage (their output is discarded): the cost
  of a fixed-shape batch.

**Dense KV** (the default) keeps ``[slots, L, H, D]`` per-slot caches
(``BertConfig.decode_slots``); a prefill runs on a single-row cache that
``_admit_fn`` writes into the batch row, and a **prefix cache**
(``prefix_cache_mb``, :class:`~distkeras_tpu_torch.serving.prefix_cache.PrefixCache`)
copies a prompt's longest cached block-chain prefix instead of recomputing
it.

**Paged KV** (``paged``, ``kv_pool_mb`` or ``kv_pool_blocks``) replaces
the dense cache with ONE block pool per layer shared by decode slots and
the prefix cache (:class:`~distkeras_tpu_torch.serving.prefix_cache.KVBlockPool`):
each slot's K/V lives in ``kv_block_tokens``-token blocks addressed
through a block table, so capacity scales with resident tokens; a prefix
hit is zero-copy (the table points at the pinned trie blocks) and a
finished slot's complete blocks are adopted into the trie in place. When
the pool runs dry the engine preempts the lowest-priority youngest slot:
its blocks are adopted, its request requeued at the front of its class
with the streamed tokens folded into the resume prefill, so greedy output
stays token-identical. A request whose context can never fit is rejected
at submit with the typed ``kv_oom`` error. The paged step takes positions
and block tables as tensors: it keeps one signature while blocks chain,
slots are preempted and contexts grow; positions advance on the device
and the host re-uploads them and the tables only under a dirty flag.

The paged engine also serves the request kinds ``score`` (per-token
log-probabilities of the prompt), ``embed`` (the mean of the trunk's last
activation) and ``sample`` (``n`` forks of one prefill sharing its
complete prompt blocks copy-on-write), and **constrained decoding**
(``constrained=True``): a per-slot additive token mask from a
:class:`~distkeras_tpu_torch.serving.constraints.TokenDFA` lands on the
logits before sampling, one ``[slots, V]`` operand for every batch.

**Speculative decoding** (``draft_model``, ``draft_variables``, ``spec_k``)
over either KV layout: a draft model with a dense per-slot cache proposes
``spec_k`` greedy tokens per tick, ONE target call scores the window, and
the longest prefix of drafts within ~2 bf16 ulps of the window's maximum
is committed (:func:`_spec_accept`). Committed values are always draft
tokens, computed by one-token steps as ``generate()``'s are. A row that
accepts nothing is owed a one-token fallback tick. Rejected drafts roll
back by rewinding the dense index leaves or by not advancing the paged
watermark.

The **parameter swap** (:meth:`ServingEngine.request_param_swap`, the
server's ``reload`` verb) replaces the target's weights at the first
iteration with no slot in flight, after a shape and dtype check, flushes
the cached K/V and bumps ``weight_version``; a draft is not swapped.

Per-request sampling: ``temperature <= 0`` rows take
:func:`~distkeras_tpu_torch.inference.generate.greedy_ids` inside the same
step as sampled rows (a ``torch.where`` select), so greedy and sampled
requests share one batch. Sampling draws from a ``torch.Generator`` on the
device that the engine owns, seeded from ``seed``; ``top_k`` is
engine-wide.

**Overlapped decode pipeline** (``pipeline_depth=1``, the default): the
run loop dispatches tick N+1 *before* consuming tick N's tokens. CUDA
launches are asynchronous, so the only point the host waits for the
device is the one D2H of each tick's ``[slots]`` token vector (the
**harvest**); a CUDA event recorded after each dispatch tells whether the
tick has finished (``_tick_ready``). A **pipeline barrier** (harvest,
stream and teardown of the in-flight tick) runs before every event that
changes the batch's shape or content: admission, chunked-prefill
progress, paged growth and preemption, the swap, cancel and expiry
teardown, idle and exit. A speculative tick is harvested before the next
dispatch, since the next tick's positions depend on its commits. Greedy
output is token-identical to ``pipeline_depth=0``.

Device work runs in three places: the first decode dispatch and every
prefill in the event loop's executor (a thread), warm decode dispatches
inline on the loop thread. Grad mode is per thread, so every function
that touches the model enters ``torch.inference_mode()`` itself, and all
of them queue on the device's current stream, which threads share.

**KV block transfer** (paged only; :meth:`ServingEngine.request_kv_export`,
:meth:`ServingEngine.request_kv_import`, the fleet's disaggregated
prefill): an export gathers a prompt's cached block chain from the pools
(``index_select`` per KV leaf, copied to pinned host memory) and serializes
it as KVX1 (:mod:`~distkeras_tpu_torch.serving.kv_transfer`); an import
validates geometry and weight provenance, adopts the chain into the trie
(:meth:`KVBlockPool.adopt_foreign`) and scatters the rows in
(``index_copy_`` from pinned memory). Both run between iterations, after a
pipeline barrier, so they never interleave with a tick over the same rows.
The **host and disk KV tiers** (``kv_host_tier_mb``, ``kv_disk_tier_dir``,
``kv_disk_tier_mb``; :class:`~distkeras_tpu_torch.serving.kv_tier.HostKVTier`)
catch the pool's eviction victims as KVX1 bytes, one batched gather per
allocation burst, and readmit them at admission before the prefix match.
The transfer ids are not padded to a power-of-two bucket as the
reference's are: nothing is compiled per shape here.

**Sharded serving** (``mesh``; :mod:`~distkeras_tpu_torch.serving.sharded`):
one replica over the ranks of a serving mesh, tensor-parallel over its
``tp`` axis (``H/tp`` heads a rank, the model's tp sums and gathers) and
pipelined over its ``pp`` stages (:class:`~distkeras_tpu_torch.parallel.pp.StagePlan`).
The mesh's first rank leads: it runs this loop and mirrors every device
operation to the followers, which run :meth:`ServingEngine.follow`.
``pipeline_depth > 1`` on a pp mesh micro-batches each decode tick
across the stages; ``serving_bubble_fraction`` measures the stages' idle
share.

No step is a CUDA graph: a warm decode dispatch is a full eager step on the loop
thread. ``HostGapTracker`` stamps a tick's dispatch before its launches,
so ``serving_device_idle_ratio`` counts the gaps between ticks; inside an
eager tick the device also idles between launches, which only a profiler
sees.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import dataclasses
import functools
import os
import time

import numpy as np
import torch

from distkeras_tpu_torch.inference.generate import (
    _check_context,
    _context_limit,
    _decode_module,
    accept_prefix_length,
    cache_with_index,
    greedy_ids,
    sample_rows,
)
from distkeras_tpu_torch.models.bert import decode_cache
from distkeras_tpu_torch.serving.constraints import TokenDFA
from distkeras_tpu_torch.serving.kv_tier import HostKVTier
from distkeras_tpu_torch.serving.kv_transfer import (
    MAX_TOTAL_TRANSFER_BYTES,
    KVTransferError,
    deserialize_blocks,
    serialize_blocks,
)
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.prefix_cache import KVBlockPool, PrefixCache
from distkeras_tpu_torch.serving.sharded import StagedDecode
from distkeras_tpu_torch.serving.scheduler import (
    REQUEST_KINDS,
    SCORELIKE_KINDS,
    EngineStopped,
    PoolExhausted,
    Request,
    RequestCancelled,
    RequestTimeout,
    Scheduler,
    ServingError,
)
from distkeras_tpu_torch.telemetry.device import publish_memory_gauges
from distkeras_tpu_torch.telemetry.flight_recorder import FlightRecorder
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from distkeras_tpu_torch.telemetry.request_trace import TimelineRecord, TraceStore
from distkeras_tpu_torch.telemetry.spans import span
from distkeras_tpu_torch.telemetry.wide_events import WideEventStore
from distkeras_tpu_torch.utils.bridge import as_state_dict
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["ServingEngine", "check_serving_mesh"]

@torch.inference_mode()
def _prefill_fn(module, top_k, gen, params, cache, padded, start, true_len, temp):
    """Run a right-padded ``[1, P]`` prompt *chunk* through the decode
    module at cache offset ``start``, extending the slot's single-row KV
    cache and sampling the token that follows the chunk (reference
    ``_prefill_fn``).

    Padding is benign: causal attention means real positions never see the
    pad tail, the sampled token comes from the logits at ``true_len - 1``,
    and the garbage K/V at ``[start + true_len, start + P)`` is masked out
    of every later step until overwritten by real tokens. The index leaves
    are set to ``start`` on entry and rewound to ``start + true_len`` on
    exit, so the next chunk (or decode) resumes at the real end."""
    cache = cache_with_index(cache, start)
    logits, cache = module.apply({**params, **cache}, padded)
    cache = cache_with_index(cache, start + true_len)
    last = logits[0, true_len - 1][None]  # [1, V]
    tok = sample_rows(last, temp[None], gen, top_k)[0]
    return cache, tok


@torch.inference_mode()
def _admit_fn(cache, tokens, temps, slot, pre_cache, first_tok, temp):
    """Write a prefilled single-row cache into batch row ``slot`` (the
    reference's leading-axis ``dynamic_update_slice``). Runs only after a
    pipeline barrier, when no dispatched tick still reads the batch cache,
    so the cache rows are written in place; the token and temperature
    vectors are new tensors."""
    for name, big in cache.items():
        big[slot] = pre_cache[name][0].to(big.dtype)
    tokens = tokens.clone()
    tokens[slot] = first_tok
    temps = temps.clone()
    temps[slot] = temp
    return cache, tokens, temps


@torch.inference_mode()
def _decode_fn(module, top_k, gen, params, cache, tokens, temps):
    """ONE decode iteration for the whole slot batch ``[B] -> [B]``."""
    logits, cache = module.apply({**params, **cache}, tokens[:, None])
    nxt = sample_rows(logits[:, -1], temps, gen, top_k)
    return cache, nxt


def _paged_apply(module, params, pools, padded, start, table_row, **kw):
    """One single-row chunk through the paged module at position
    ``start`` over the slot's table row: the chunk's K/V land in the pools
    (writes past the row's allocated blocks are dropped)."""
    positions = torch.full((1,), int(start), dtype=torch.int32, device=padded.device)
    return module.apply({**params, **pools}, padded, positions=positions,
                        block_tables=table_row[None], **kw)


@torch.inference_mode()
def _paged_prefill_fn(module, top_k, gen, params, pools, padded, start, true_len,
                      table_row, temp):
    """Paged twin of :func:`_prefill_fn`: the chunk's K/V go straight into
    the shared pools through the slot's block table (no single-row cache,
    nothing to copy afterwards). Right-padded garbage past the allocated
    blocks is dropped; garbage inside the tail block stays masked until
    real tokens overwrite it."""
    logits, pools = _paged_apply(module, params, pools, padded, start, table_row)
    last = logits[0, true_len - 1][None]  # [1, V]
    tok = sample_rows(last, temp[None], gen, top_k)[0]
    return pools, tok


@torch.inference_mode()
def _paged_admit_fn(tokens, temps, slot, tok, temp):
    """Paged admission epilogue: only the sampling state changes; the K/V
    is already in the pool."""
    tokens = tokens.clone()
    tokens[slot] = tok
    temps = temps.clone()
    temps[slot] = temp
    return tokens, temps


@torch.inference_mode()
def _paged_decode_fn(module, top_k, sentinel, gen, params, pools, tokens, temps,
                     positions, tables):
    """Paged twin of :func:`_decode_fn`: the K/V appends go into the pools
    at each row's position and attention gathers through the block
    tables. Positions advance on the device: each row live in the masked
    table view (first entry not the sentinel, exactly the rows whose write
    lands) comes back at ``position + 1``, so steady-state ticks feed the
    returned vector instead of uploading a host array."""
    logits, pools = module.apply({**params, **pools}, tokens[:, None],
                                 positions=positions, block_tables=tables)
    nxt = sample_rows(logits[:, -1], temps, gen, top_k)
    live = (tables[:, 0] != sentinel).to(positions.dtype)
    return pools, nxt, positions + live


@torch.inference_mode()
def _paged_decode_masked_fn(module, top_k, sentinel, gen, params, pools, tokens,
                            temps, positions, tables, mask):
    """Constrained twin of :func:`_paged_decode_fn`: the per-slot additive
    token mask ``[slots, V]`` (0 allowed, -1e9 forbidden) lands on the
    last-position logits before sampling. Unconstrained rows carry a zero
    row, so one step serves mixed batches."""
    logits, pools = module.apply({**params, **pools}, tokens[:, None],
                                 positions=positions, block_tables=tables)
    nxt = sample_rows(logits[:, -1] + mask, temps, gen, top_k)
    live = (tables[:, 0] != sentinel).to(positions.dtype)
    return pools, nxt, positions + live


@torch.inference_mode()
def _paged_prefill_logits_fn(module, params, pools, padded, start, true_len, table_row):
    """Final-chunk prefill that returns the float32 LOGITS row instead of
    a sampled token: the fork fan-out samples ``n`` first tokens from it
    and constrained admission masks it first."""
    logits, pools = _paged_apply(module, params, pools, padded, start, table_row)
    return pools, logits[0, true_len - 1].float()


@torch.inference_mode()
def _fork_sample_fn(top_k, gen, logits, temps):
    """Sample ``n`` continuations from ONE prefill logits row: the row is
    broadcast to ``[n, V]`` and each fork draws its first token."""
    rows = logits[None, :].expand(temps.shape[0], logits.shape[0])
    return sample_rows(rows, temps, gen, top_k)


@torch.inference_mode()
def _score_chunk_fn(module, params, pools, padded, start, true_len, table_row, targets):
    """Scoring prefill chunk: the paged prefill's K/V writes, and each
    chunk position's log-probability of its NEXT prompt token,
    ``log_softmax(logits[j])[targets[j]]``; the host drops the pad tail
    and the final position."""
    logits, pools = _paged_apply(module, params, pools, padded, start, table_row)
    logp = torch.log_softmax(logits[0].float(), dim=-1)
    picked = logp.gather(1, targets.long()[:, None])[:, 0]
    return pools, picked


@torch.inference_mode()
def _embed_chunk_fn(module, params, pools, padded, start, true_len, table_row):
    """Embedding prefill chunk: the trunk's last activation
    (``return_hidden=True``) summed over the chunk's TRUE positions; the
    host sums the chunks and divides by the prompt length."""
    hidden, pools = _paged_apply(module, params, pools, padded, start, table_row,
                                 return_hidden=True)
    valid = (torch.arange(hidden.shape[1], device=hidden.device) < true_len)[:, None]
    summed = (hidden[0].float() * valid).sum(dim=0)
    return pools, summed


@torch.inference_mode()
def _copy_blocks(pools, src: int, dst: int):
    """Copy pool row ``src`` into row ``dst`` in every pool (the fork's
    copy-on-write of a partially filled tail block; the reference gathers
    and scatters it through its KV transfer functions)."""
    for p in pools.values():
        p[dst] = p[src]
    return pools


@torch.inference_mode()
def _mask_row_fn(logits, mask):
    """A constrained admission's prefill logits row with its additive
    token mask."""
    return logits + mask


@torch.inference_mode()
def _spec_draft_fn(module, K, params, cache, prev, tokens, start):
    """Fixed-K greedy draft: ``K`` one-token steps propose ``K`` tokens per
    row (reference ``_spec_draft_fn``, a ``lax.scan`` there).

    ``start`` is the per-row fed-token count (int32 ``[B]``, the target's
    truth); setting the index leaves to it on entry is the draft cache's
    rollback. The pass begins one position early: a heal step re-feeds
    ``prev`` (the token at ``start - 1``), which repairs the hole a
    one-token fallback tick leaves in the draft's cache. Every step is a
    one-token apply, the lowering shape of ``generate()``'s loop, so with
    draft == target every committed token is the sequential chain's."""
    cache = cache_with_index(cache, torch.clamp(start - 1, min=0))
    _, cache = module.apply({**params, **cache}, prev[:, None])
    cache = cache_with_index(cache, start)
    tok, drafts = tokens, []
    for _ in range(K):
        logits, cache = module.apply({**params, **cache}, tok[:, None])
        tok = greedy_ids(logits[:, -1].float())
        drafts.append(tok)
    return cache, torch.stack(drafts, dim=1)  # [B, K]: d_1..d_K


def _spec_accept(logits, drafts, tokens, temps, spec_ok, remaining, gen, top_k):
    """Shared accept epilogue of both verify functions: from the target's
    ``[B, K, V]`` logits over the window ``[last_tok, d_1..d_{K-1}]``,
    decide how many DRAFT tokens each row commits (reference
    ``_spec_accept``).

    Committed values are always the drafts themselves, never tokens read
    off the window's logits, and draft ``d_{j+1}`` is accepted while its
    verify logit sits within ~2 bf16 ulps of the window's maximum (not on
    exact argmax equality, which cross-width reduction noise breaks at
    ties). A row accepting zero drafts commits nothing and is owed a
    fallback tick; ``temperature > 0`` rows commit one token sampled from
    offset 0's logits; greedy rows that opted out commit nothing here.
    ``remaining`` clamps every row. Returns ``(out, commit)``:
    ``out[b, :commit[b]]`` are row ``b``'s committed tokens."""
    logits = logits.float()
    tok0 = sample_rows(logits[:, 0], temps, gen, top_k)
    eligible = spec_ok & (temps <= 0)
    top = logits.max(dim=-1).values  # [B, K]
    drafted = logits.gather(-1, drafts.long()[..., None])[..., 0]  # [B, K]
    eps = (2.0 ** -7) * torch.clamp(top.abs(), min=1.0)
    accepted = accept_prefix_length(drafted >= top - eps)
    one = torch.ones_like(remaining)
    commit = torch.where(
        eligible, torch.minimum(accepted, remaining),
        torch.where(temps > 0, torch.minimum(one, remaining), torch.zeros_like(remaining)))
    out = torch.cat([torch.where(eligible, drafts[:, 0], tok0)[:, None], drafts[:, 1:]],
                    dim=1)
    return out, commit.to(torch.int32)


def _next_token(out, commit, tokens):
    """Each row's next feed token: its last committed token, unchanged on
    a zero commit."""
    last = out.gather(1, torch.clamp(commit - 1, min=0).long()[:, None])[:, 0]
    return torch.where(commit > 0, last, tokens)


@torch.inference_mode()
def _spec_verify_fn(module, top_k, gen, params, cache, tokens, drafts, temps, spec_ok,
                    remaining, positions):
    """Dense speculative verify: ONE target call scores the K window
    positions per slot, the accept commits a draft prefix, and the
    rejected tail rolls back by rewinding the per-row index leaves to
    ``positions + commit`` (its garbage K/V stays masked until real tokens
    overwrite it). Returns ``(cache, new_tokens, out, commit)``."""
    window = torch.cat([tokens[:, None], drafts[:, :-1]], dim=1)
    cache = cache_with_index(cache, positions)
    logits, cache = module.apply({**params, **cache}, window)
    out, commit = _spec_accept(logits, drafts, tokens, temps, spec_ok, remaining, gen, top_k)
    cache = cache_with_index(cache, positions + commit)
    return cache, _next_token(out, commit, tokens), out, commit


@torch.inference_mode()
def _paged_spec_verify_fn(module, top_k, gen, params, pools, tokens, drafts, temps,
                          spec_ok, remaining, room, positions, tables):
    """Paged twin of :func:`_spec_verify_fn`: the window's K/V go through
    the block tables (writes past a row's blocks are dropped), so
    ``room`` (the contiguous allocated positions from each row's write
    offset) also clamps the commit. Rollback is the host not advancing its
    watermark past the commit."""
    window = torch.cat([tokens[:, None], drafts[:, :-1]], dim=1)
    logits, pools = module.apply({**params, **pools}, window, positions=positions,
                                 block_tables=tables)
    out, commit = _spec_accept(logits, drafts, tokens, temps, spec_ok, remaining, gen, top_k)
    commit = torch.minimum(commit, room)
    return pools, _next_token(out, commit, tokens), out, commit


@torch.inference_mode()
def _draft_prefill_fn(module, params, cache, padded, start, true_len):
    """Draft twin of :func:`_prefill_fn` without sampling: extend the
    draft's single-row cache with a chunk at ``start`` and rewind the
    index leaves to the true end."""
    cache = cache_with_index(cache, start)
    _, cache = module.apply({**params, **cache}, padded)
    return cache_with_index(cache, start + true_len)


@torch.inference_mode()
def _draft_admit_fn(cache, slot, pre_cache):
    """Write a prefilled single-row draft cache into batch row ``slot``,
    in place (after a barrier, as :func:`_admit_fn`)."""
    for name, big in cache.items():
        big[slot] = pre_cache[name][0].to(big.dtype)
    return cache


def _sign_prefill(args, kwargs):
    # (params, cache, padded, start, true_len, temp): start and true_len
    # are the reference's traced scalars, one program for every value.
    return args[1], args[2], args[5]


def _sign_paged_prefill(args, kwargs):
    # (params, pools, padded, start, true_len, table_row, temp)
    return args[1], args[2], args[5], args[6]


def _sign_admit(args, kwargs):
    # Dense (cache, tokens, temps, slot, pre_cache, first_tok, temp) or
    # paged (tokens, temps, slot, tok, temp): slot is a traced scalar in
    # the reference.
    return tuple(a for a in args if not isinstance(a, int))


def _sign_tick(args, kwargs):
    # (params, ...): the params' shapes and dtypes never change (a swap
    # checks them before it is accepted), so they are left out of the
    # per-tick signature.
    return args[1:]


def _sign_draft_prefill(args, kwargs):
    # (params, cache, padded, start, true_len)
    return args[1], args[2]


@dataclasses.dataclass
class _PrefillJob:
    """Partial-prefill progress for a slot still being admitted: the
    single-row cache under construction (dense; None when paged), how far
    into the prompt it is (prefix-cache splice included), and the pinned
    match to release."""

    cache: object                 # single-row KV cache
    pos: int                      # prompt tokens already in the cache
    match: object | None          # PrefixMatch to release on completion
    matched_tokens: int
    chunks_done: int = 0
    device_s: float = 0.0         # prefill device time (TTFT's other half)


def _tick_ready(tick) -> bool:
    """True when the tick's outputs have materialized on the device (the
    CUDA event recorded after its dispatch has completed): the harvest is
    then a plain copy, cheaper run inline than through an executor round
    trip. CPU work is synchronous, so a CPU tick is always ready."""
    ready = tick.ready
    return True if ready is None else bool(ready.query())


@dataclasses.dataclass
class _InflightTick:
    """A dispatched-but-unharvested decode tick: the device tensors the
    harvest will read, the CUDA event that marks it done, the decodable
    rows the dispatch covered (a row streams iff it was decodable AT
    DISPATCH and its slot is still alive) and, for plain paged ticks, the
    slots whose watermark the dispatch advanced, so a teardown found at an
    earlier harvest can roll the advance back before adopting blocks."""

    kind: str                     # "decode" | "spec"
    rows: tuple                   # decodable slots at dispatch
    t_dispatch: float
    tokens: object = None         # plain: device token vector to harvest
    out: object = None            # spec: device [B, K] committed tokens
    commit: object = None         # spec: device per-row commit counts
    caps: object = None           # spec: host per-row draft budgets
    advanced: set = dataclasses.field(default_factory=set)
    ready: object = None          # CUDA event recorded after the dispatch


def _public_provenance(provenance: dict | None) -> dict:
    """The client-facing face of a weights stamp: version + digest ONLY
    (never the server-side file path)."""
    if not provenance:
        return {"version": 0, "digest": None}
    return {"version": int(provenance.get("version") or 0),
            "digest": provenance.get("digest")}


@dataclasses.dataclass
class _SlotState:
    request: Request
    remaining: int  # tokens still to decode after the prefill token
    last_token_t: float
    # Non-None while the slot's prompt is still prefilling (chunked
    # admission): the row sits in the decode batch but its garbage output
    # is discarded until the prompt is complete.
    prefill: _PrefillJob | None = None
    # Paged: when the slot was admitted (preemption takes the youngest),
    # the private block ids it owns (block indices first_block, ... of its
    # table) and the pinned shared-prefix match its table head points at.
    t_admit: float = 0.0
    blocks: list = dataclasses.field(default_factory=list)
    first_block: int = 0
    match: object | None = None
    # Speculative decoding: this slot's draft/accept counters.
    spec_drafted: int = 0
    spec_accepted: int = 0
    # kind="sample": which fork of the shared request this row is, its
    # private token stream, and fork_wait for a child slot claimed at
    # admission but not fanned out yet.
    fork_idx: int | None = None
    fork_tokens: list | None = None
    fork_wait: bool = False
    # Constrained decoding: the request's automaton and its state.
    dfa: object | None = None
    dfa_state: int = 0
    # score/embed accumulators.
    score_acc: list | None = None
    embed_acc: object | None = None


# Returned by _prefill_step when a score/embed request's prompt completed.
_SCORELIKE_DONE = object()


@dataclasses.dataclass
class _ForkReady:
    """Returned by _prefill_step when a fork parent's prompt completed:
    the n first tokens, one per fork."""
    tokens: list


def _kv_leaf_names(cache: dict) -> list[str]:
    """The pool leaves of a paged cache in KVX1 leaf order: the
    reference's ``jax.tree.leaves`` order, which sorts the nested dict
    keys as strings (``layer_0, layer_1, layer_10, ..., layer_2``), so a
    payload crosses between the packages leaf for leaf."""
    return sorted((name for name, leaf in cache.items() if leaf.ndim > 1),
                  key=lambda name: name.split("."))


def check_serving_mesh(model, shape, *, slots: int, pipeline_depth: int = 1,
                       spec: bool = False, constrained: bool = False,
                       kv_host_tier_mb: float = 0.0):
    """The static checks of a serving mesh of axis sizes ``shape`` (None:
    no mesh) for ``model`` and the engine's options, as ``ValueError``s
    with the reference's messages (its ``engine.py:1132-1218``); the
    ``serve`` command runs them in its parent before it starts a rank.
    Returns ``(tp, pp, stage_plan)``."""
    tp = pp = 1
    plan = None
    if shape is not None:
        shape = dict(shape)
        if "tp" not in shape:
            raise ValueError(
                f"serving mesh {shape} has no 'tp' axis; "
                f"build it with parallel.mesh.serving_mesh")
        tp = int(shape["tp"])
        pp = int(shape.get("pp", 1))
        extra = {a: s for a, s in shape.items() if a not in ("tp", "pp") and s > 1}
        if extra:
            raise ValueError(
                f"serving mesh has non-trivial non-tp axes {extra}: "
                f"data parallelism in serving is N replicas (run.py "
                f"cluster), not a dp mesh axis inside one engine")
    if constrained and pp > 1:
        raise ValueError("constrained=True is not supported on a pp mesh yet")
    if pipeline_depth > 1:
        if pp < 2:
            raise ValueError(
                f"pipeline_depth={pipeline_depth} needs a pp>=2 "
                f"serving mesh (micro-batched ticks only overlap "
                f"across pipeline stages; --mesh-shape tp=N,pp=M)")
        if spec:
            raise ValueError(
                f"pipeline_depth={pipeline_depth} is incompatible "
                f"with speculative decoding (draft/verify ticks span "
                f"the whole slot batch); use pipeline_depth<=1")
        if slots % pipeline_depth:
            raise ValueError(
                f"slots={slots} does not divide into pipeline_depth="
                f"{pipeline_depth} equal micro-batches")
    if pp > 1 and kv_host_tier_mb > 0:
        raise ValueError(
            "kv_host_tier_mb > 0 is not supported on a pp mesh yet: "
            "the host tier's gather/scatter programs span the whole "
            "pool, which is stage-partitioned under pp")
    if shape is not None:
        _, cfg = _decode_module(model, slots=True)
        if tp > 1:
            bad = [f"{name}={val}" for name, val in (
                ("num_heads", cfg.num_heads),
                ("mlp_dim", cfg.mlp_dim),
                ("vocab_size", cfg.vocab_size),
            ) if val % tp]
            if bad:
                raise ValueError(
                    f"model {getattr(model, 'name', model)!r} does not "
                    f"shard over tp={tp}: {', '.join(bad)} not "
                    f"divisible — pick a tp that divides all three")
        if pp > 1:
            from distkeras_tpu_torch.parallel.pp import plan_stages

            plan = plan_stages(cfg.num_layers, pp)
    return tp, pp, plan


class ServingEngine:
    """Fixed-slot continuous-batching server core (reference
    ``ServingEngine``).

    ``model``/``variables``: a causal LM from the zoo (gpt_tiny/gpt_small)
    and its weights, the same pair :func:`generate` takes; the weights
    move to ``device`` (CUDA unless ``"cpu"`` is asked for; without a card
    and without ``"cpu"`` the engine raises, as ``generate()`` does).
    ``slots``: decode batch width. ``max_queue``: admission backpressure
    depth (:class:`QueueFullError` beyond it). ``top_k``: engine-wide top-k
    sampling (None = full vocab).

    ``prefill_chunk``: split each prompt's (uncached) prefill into chunks
    of this many tokens, ONE chunk per engine iteration (round-robin across
    admitting slots) interleaved with decode ticks. None (default) keeps
    monolithic admission. Greedy output is token-identical either way.

    ``prefix_cache_mb`` (dense): > 0 enables the device-resident prefix
    cache under that byte budget, with ``prefix_block_tokens``-token
    blocks; the scheduler then prefers cache-hitting requests within a
    priority class. Pass ``prefix_cache=`` to inject a pre-built pool. The
    cache is NOT thread-safe: one engine's loop drives it.

    ``kv_pool_mb`` > 0, ``kv_pool_blocks`` or ``paged=True`` select paged
    KV: one pool of ``kv_block_tokens``-token blocks (``kv_pool_blocks``
    of them, or as many as ``kv_pool_mb`` holds), which is also the prefix
    cache (``prefix_cache=`` is then an error). ``constrained=True``
    (paged only) makes the decode step take the per-slot token mask.

    ``max_context``: cap each request's context (prompt + new tokens)
    below the model's trained length; the dense per-slot cache shrinks to
    it.

    ``draft_model``/``draft_variables``/``spec_k``: speculative decoding;
    the draft shares the target's vocabulary and keeps a dense per-slot
    cache. ``submit(..., speculate=False)`` opts a request out;
    ``temperature > 0`` rows never speculate.

    ``auditor``: a :class:`RecompileAuditor` wrapping the device callables
    (``serving_prefill``, ``serving_admit``, ``serving_decode``, and
    ``serving_draft``/``serving_verify`` with a draft); with
    ``arm_auditor_after_warmup`` the tick callables are armed after the
    first iteration, so a later change of their abstract signature raises
    :class:`RecompileError` at the call.

    Observability, as the reference's: ``trace_store``,
    ``flight_recorder``, ``wide_events`` (a capacity or a store; default
    4096), ``slo_s``; tenant weights and quotas through the scheduler.

    ``kv_host_tier_mb`` > 0 (paged only) adds the host KV tier under the
    pool, with ``kv_disk_tier_dir``/``kv_disk_tier_mb`` a disk level under
    it and ``kv_tier_watermark`` the fraction of a level's budget its
    eviction bursts drain to. :meth:`request_kv_export` and
    :meth:`request_kv_import` move block chains between paged engines.

    ``mesh``: a :func:`~distkeras_tpu_torch.parallel.mesh.serving_mesh`
    over every rank of the process group (``tp``, and ``pp`` stages)
    makes ONE replica of the ranks: each rank builds this engine with the
    same arguments and whole ``variables`` and keeps its share; the rank
    at the mesh's first position serves (:meth:`run`, the scheduler, the
    server), the others call :meth:`follow` (``serving/sharded.py``).
    ``mlp_dim``, ``num_heads`` and ``vocab_size`` must divide over tp and
    the layers over pp. ``pipeline_depth > 1`` (a pp mesh, slots divisible
    by it, no draft) splits each decode tick into that many micro-batches
    that overlap across the stages. On a pp mesh ``constrained``,
    ``kv_host_tier_mb`` and the KV transfers raise, as the reference's do.

    Drive it with :meth:`submit` + :meth:`run` (asyncio).
    """

    def __init__(
        self,
        model,
        variables,
        *,
        slots: int = 4,
        max_queue: int = 64,
        top_k: int | None = None,
        metrics: ServingMetrics | None = None,
        seed: int = 0,
        min_prefill_bucket: int = 8,
        auditor: RecompileAuditor | None = None,
        arm_auditor_after_warmup: bool = False,
        prefill_chunk: int | None = None,
        prefix_cache_mb: float = 0.0,
        prefix_block_tokens: int = 16,
        prefix_cache: PrefixCache | None = None,
        paged: bool = False,
        kv_pool_mb: float = 0.0,
        kv_block_tokens: int = 16,
        kv_pool_blocks: int | None = None,
        kv_host_tier_mb: float = 0.0,
        kv_disk_tier_dir: str | None = None,
        kv_disk_tier_mb: float = 0.0,
        kv_tier_watermark: float = 0.8,
        max_context: int | None = None,
        draft_model=None,
        draft_variables=None,
        spec_k: int = 4,
        mesh=None,
        pipeline_depth: int = 1,
        trace_store: TraceStore | None = None,
        flight_recorder: FlightRecorder | None = None,
        wide_events: "WideEventStore | int | None" = 4096,
        slo_s: float | None = None,
        weight_version: dict | None = None,
        tenant_weights: dict | None = None,
        tenant_quotas: dict | None = None,
        quota_burst_s: float = 2.0,
        constrained: bool = False,
        device: str | torch.device | None = None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None, got {prefill_chunk}")
        if int(pipeline_depth) != pipeline_depth or pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be a non-negative int: 0 (serialized "
                f"dispatch+harvest), 1 (dispatch tick N+1 before consuming "
                f"tick N), or >1 (micro-batched ticks overlapping pipeline "
                f"stages; needs a pp mesh), got {pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        # Dispatched-but-unharvested ticks, oldest first (at most one), and
        # a bounded dispatch->harvest timeline (the tracez tick lane).
        self._inflight: collections.deque = collections.deque()
        self._tick_log: collections.deque = collections.deque(maxlen=256)
        # False until the first decode dispatch has run: it goes through
        # the executor (the first call builds cuBLAS handles and loads
        # kernels), every later one runs inline on the loop thread.
        self._dispatch_warm = False
        self.model = model
        self.device = resolve_device(device)
        self._mesh_setup(mesh, model, slots=slots, spec=draft_model is not None,
                         constrained=constrained, kv_host_tier_mb=kv_host_tier_mb)
        self._spec = draft_model is not None
        self.draft_model = draft_model
        self.spec_k = int(spec_k)
        if self._spec and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if self._spec and draft_variables is None:
            raise ValueError("draft_model needs draft_variables (the draft's "
                             "trained weights)")
        self._paged = bool(paged or kv_pool_mb > 0 or kv_pool_blocks)
        self._constrained_mode = bool(constrained)
        if self._constrained_mode and not self._paged:
            raise ValueError(
                "constrained=True requires paged KV (kv_pool_mb / "
                "kv_pool_blocks): the token-mask hook lives in the paged "
                "decode step")
        _, base_cfg = _decode_module(model, slots=True)
        base_limit = _context_limit(model, base_cfg)
        if max_context is not None:
            if not 1 <= max_context <= base_limit:
                raise ValueError(
                    f"max_context={max_context} outside [1, trained "
                    f"context {base_limit}]")
            self.limit = int(max_context)
        else:
            self.limit = base_limit
        dev = self.device
        if self._paged:
            if prefix_cache is not None:
                raise ValueError(
                    "paged mode subsumes the prefix cache (the KV pool "
                    "IS the prefix cache); do not pass prefix_cache=")
            if kv_block_tokens < 1:
                raise ValueError(
                    f"kv_block_tokens must be >= 1, got {kv_block_tokens}")
            bt = int(kv_block_tokens)
            table_blocks = -(-self.limit // bt)
            # Per-token KV bytes from the uncapped dense row geometry: K
            # and V of every layer, H * D elements each.
            D = base_cfg.hidden_size // base_cfg.num_heads
            itemsize = torch.empty((), dtype=base_cfg.dtype).element_size()
            bytes_per_block = (2 * base_cfg.num_layers * bt * base_cfg.num_heads * D
                               * itemsize)
            if kv_pool_blocks is not None:
                capacity = int(kv_pool_blocks)
            else:
                capacity = int(kv_pool_mb * 2**20) // bytes_per_block
            if capacity < 1:
                raise ValueError(
                    f"kv_pool_mb={kv_pool_mb} holds zero "
                    f"{bt}-token blocks (one block = {bytes_per_block} "
                    f"bytes)")
            self._module, self._cfg = _decode_module(
                model, slots=True, paged_blocks=capacity, page_tokens=bt,
                page_table_blocks=table_blocks, **self._mesh_overrides())
            # Prefill pad-width bound: the context limit, not the table's
            # reach (which rounds up past it when bt does not divide it).
            self._cache_len = self.limit
            self.kv_block_tokens = bt
            self._table_blocks = table_blocks
            # Table sentinel: one past the pool marks "unallocated".
            self._sentinel = capacity
        else:
            dense_len = (int(max_context) if max_context is not None
                         else base_cfg.max_seq_len)
            overrides = {}
            if max_context is not None or self._spec:
                # Speculative headroom: a verify window writes spec_k K/V
                # vectors from the row's fed count; extending the cache
                # (never the positional table) keeps those writes from
                # clamping backward over real prefix K/V.
                overrides["decode_cache_len"] = dense_len + (
                    self.spec_k if self._spec else 0)
            self._module, self._cfg = _decode_module(model, slots=True, **overrides,
                                                     **self._mesh_overrides())
            # Prefill pad-width bound: the request context.
            self._cache_len = dense_len
        if top_k is not None and not 1 <= top_k <= self._cfg.vocab_size:
            raise ValueError(
                f"top_k={top_k} outside [1, vocab_size={self._cfg.vocab_size}]"
            )
        self.slots = int(slots)
        self.metrics = metrics or ServingMetrics()
        if self._pp > 1:
            self._module = StagedDecode(
                self._module, self._cfg, self._stage_plan, self._stage, mesh,
                slots=self.slots, micro_batches=self._mb_count,
                bubble=self.metrics.bubble if self._link.is_leader else None,
                device=self.device)
        # Device-resident params from the start (one transfer at
        # construction); on a mesh this rank's share of them, and the whole
        # weights' geometry, which a swap must match.
        self._whole_params = {k: (tuple(v.shape), v.dtype) for k, v in variables.items()}
        self._params = self._place_params(variables)
        self.scheduler = Scheduler(
            max_depth=max_queue,
            registry=self.metrics.registry,
            tenant_weights=tenant_weights,
            tenant_quotas=tenant_quotas,
            quota_burst_s=quota_burst_s,
            # ONE labeler across the scheduler's and the metrics' tenant
            # families.
            tenant_labeler=getattr(self.metrics, "tenant_labeler", None))
        self._min_bucket = int(min_prefill_bucket)
        self._chunk = None if prefill_chunk is None else int(prefill_chunk)
        self._prefill_rr = 0  # round-robin cursor over prefilling slots
        # The sampling generator, on the device; every prefill and decode
        # tick draws from it in the loop's order.
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))

        # Device-resident batch state: the dense [slots, L, H, D] caches or
        # the paged pools, the last token of each row and its temperature.
        with torch.inference_mode():
            self._cache = self._stage_cache(self.slots, dev)
            self._tokens = torch.zeros((self.slots,), dtype=torch.int32, device=dev)
            self._temps = torch.zeros((self.slots,), dtype=torch.float32, device=dev)
        self._slot_state: list[_SlotState | None] = [None] * self.slots

        self.kv_pool: KVBlockPool | None = None
        self.kv_tier = None
        self.prefix_cache = None
        if self._paged:
            self.kv_pool = KVBlockPool(
                capacity, self.kv_block_tokens,
                bytes_per_block=bytes_per_block,
                registry=self.metrics.registry)
            # Host-side paging state: block tables (row i = slot i's pool
            # row per block index, sentinel = unallocated) and written-KV
            # lengths. The decode step gets masked device views of these.
            self._tables = np.full((self.slots, self._table_blocks),
                                   self._sentinel, np.int32)
            self._lens = np.zeros((self.slots,), np.int64)
            # Admission parking: a popped request that could not get blocks
            # is requeued at its class head, and admission pauses until the
            # pool's version moves.
            self._parked_at_version: int | None = None
            self._parked_req: Request | None = None
            # Device views of the masked tables and of the positions, each
            # rebuilt only when its dirty flag is set.
            self._tables_dev = None
            self._positions_dev = None
            self._mark_tables_dirty()
            self.scheduler.cache_probe = self.kv_pool.probe
            # The pool leaves in KVX1 order, and the queued KV transfers
            # (export/import) the loop services between iterations.
            self._kv_names = _kv_leaf_names(self._cache)
            self._pending_kv: list[tuple] = []
            # Host-RAM (optionally disk-backed) spill tier under the pool:
            # eviction victims spill D2H as KVX1 bytes (one gather per
            # allocation burst through the batched hook) and readmit H2D
            # during admission. Every allocation that can evict runs on
            # the loop after a pipeline barrier, or in the executor while
            # the loop awaits it.
            if kv_host_tier_mb > 0:
                self.kv_tier = HostKVTier(
                    int(kv_host_tier_mb * 2**20), self.kv_block_tokens,
                    disk_dir=kv_disk_tier_dir,
                    disk_budget_bytes=int(kv_disk_tier_mb * 2**20),
                    watermark=kv_tier_watermark,
                    registry=self.metrics.registry)
                self.kv_pool.spill_hook = self._spill_block
                self.kv_pool.spill_many_hook = self._spill_blocks
            # Trace context for spill exemplars: the admission driving
            # allocations.
            self._tier_trace_id: str | None = None
            if self._constrained_mode:
                # Host truth [slots, V] (zero rows = unconstrained) and its
                # device copy, re-uploaded under the dirty flag.
                self._mask_host = np.zeros((self.slots, self._cfg.vocab_size), np.float32)
                self._mask_dev = None
                self._mask_dirty = True
        else:
            # Single-row cache geometry, as meta tensors (the reference's
            # eval_shape structs).
            self._row_shapes = self._stage_cache(1, "meta")
            if prefix_cache is not None:
                self.prefix_cache = prefix_cache
            elif prefix_cache_mb > 0:
                # On a mesh each rank's pool holds its own share of a
                # block (its heads, its stage's layers); the trie is the
                # leader's.
                self.prefix_cache = PrefixCache(
                    self._row_shapes, block_tokens=prefix_block_tokens,
                    budget_bytes=int(prefix_cache_mb * 2**20),
                    registry=self.metrics.registry, device=dev, mesh=mesh,
                    stage_meshes=self._stage_meshes)
            if self.prefix_cache is not None:
                # Cache-aware admission: the scheduler may prefer (within
                # one priority class, bounded window) the queued request
                # whose prefix is already resident.
                self.scheduler.cache_probe = self.prefix_cache.probe
                # The pool's device operations (on a mesh, mirrored).
                self._prefix_materialize = self.prefix_cache.materialize
                self._prefix_store = self.prefix_cache.store_rows

        if self._spec:
            self._draft_module, self._draft_cfg = _decode_module(
                draft_model, slots=True, decode_cache_len=self.limit + self.spec_k)
            if self._draft_cfg.vocab_size != self._cfg.vocab_size:
                raise ValueError(
                    f"draft model vocab {self._draft_cfg.vocab_size} != "
                    f"target vocab {self._cfg.vocab_size}: draft proposals "
                    "must be target token ids")
            self._draft_params = {k: v.to(dev) for k, v in draft_variables.items()}
            with torch.inference_mode():
                self._draft_cache = decode_cache(self._draft_cfg, self.slots, dev)
            # Host fed-token counts of the dense engine (the paged engine
            # keeps the same quantity as _lens).
            self._spec_pos = np.zeros((self.slots,), np.int32)
            # Set when a live row accepted zero drafts: the next tick runs
            # the one-token fallback step.
            self._spec_owe_fallback = False

        self._build_programs(top_k)

        # Recompile auditing: the one-signature invariant of the tick
        # callables as a runtime check. Without a caller's auditor the
        # decode step is still signed by a private one, which
        # decode_compile_count reads.
        self.auditor = auditor
        self._arm_after_warmup = bool(arm_auditor_after_warmup)
        self._decode_audit_names = ["serving_decode"] + (
            ["serving_draft", "serving_verify"] if self._spec else [])
        counter = auditor if auditor is not None else RecompileAuditor()
        self._counting_auditor = counter
        if auditor is not None:
            self._prefill = auditor.wrap(
                self._prefill, "serving_prefill",
                signature=_sign_paged_prefill if self._paged else _sign_prefill)
            self._admit = auditor.wrap(self._admit, "serving_admit", signature=_sign_admit)
            if self._paged:
                # Request-kind callables: admission-path work, report-only.
                self._prefill_logits = auditor.wrap(
                    self._prefill_logits, "serving_prefill_logits", signature=_sign_tick)
                self._fork_sample = auditor.wrap(self._fork_sample, "serving_fork_sample")
                self._score_chunk = auditor.wrap(
                    self._score_chunk, "serving_score_chunk", signature=_sign_tick)
                self._embed_chunk = auditor.wrap(
                    self._embed_chunk, "serving_embed_chunk", signature=_sign_tick)
            if self._spec:
                self._draft_step = auditor.wrap(self._draft_step, "serving_draft",
                                                signature=_sign_tick)
                self._verify_step = auditor.wrap(self._verify_step, "serving_verify",
                                                 signature=_sign_tick)
                self._draft_prefill = auditor.wrap(
                    self._draft_prefill, "serving_draft_prefill",
                    signature=_sign_draft_prefill)
                self._draft_admit = auditor.wrap(
                    self._draft_admit, "serving_draft_admit", signature=_sign_admit)
        self._decode_step = counter.wrap(self._decode_step, "serving_decode",
                                         signature=_sign_tick)

        # Request tracing + flight recording: timelines are built only
        # when at least one sink exists.
        self.trace_store = trace_store
        self.flight_recorder = flight_recorder
        self.trace_source = (flight_recorder.source
                             if flight_recorder is not None
                             else f"pid:{os.getpid()}")
        self.serve_role = "monolithic"
        self.slo_s = None if slo_s is None else float(slo_s)
        self._trace_requests = (trace_store is not None
                                or flight_recorder is not None)
        # Wide-event analytics: one flat record per FINISHED request.
        if isinstance(wide_events, WideEventStore):
            self.wide_events: WideEventStore | None = wide_events
        elif wide_events:
            self.wide_events = WideEventStore(int(wide_events))
        else:
            self.wide_events = None
        if (flight_recorder is not None
                and getattr(flight_recorder, "wide_events", None) is None):
            flight_recorder.wide_events = self.wide_events
        if self.slo_s is not None:
            self.metrics.set_slo(self.slo_s)

        self.weight_version = _public_provenance(weight_version)
        self.metrics.set_weight_version(self.weight_version)
        self._params_bytes = sum(v.numel() * v.element_size()
                                 for v in self._params.values())

        self._running = False
        self._stopping = False
        self._draining = True
        # Fault-injection knob (the ``inject_latency`` control verb): a
        # host-side sleep per decode iteration.
        self.inject_decode_delay_s = 0.0
        # Pending parameter swap: (params, event, result, provenance), run
        # by the loop at the first iteration with no slot in flight.
        self._pending_swap: tuple | None = None

        if self._spec:
            # Run the three tick callables (fallback decode, draft, verify)
            # once on the all-free batch now: which one the first real
            # tick takes depends on traffic, and the auditor is armed after
            # it. Free rows decode garbage anyway.
            self._decode_sync()
            self._spec_sync()
            self._dispatch_warm = True
        if self._link is not None:
            self._bind_mesh()

    # -- the serving mesh (serving/sharded.py) -------------------------------
    def _mesh_setup(self, mesh, model, *, slots, spec, constrained, kv_host_tier_mb) -> None:
        """Validate a serving mesh (:func:`check_serving_mesh`) and join
        it: this rank's stage and the control link whose first rank
        leads."""
        self.mesh = mesh
        self._stage = 0
        self._stage_plan = None
        self._stage_meshes = None
        self._link = None
        shape = None
        if mesh is not None:
            from distkeras_tpu_torch.parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a distkeras_tpu_torch Mesh "
                                f"(parallel.mesh.serving_mesh), not {type(mesh).__name__}")
            shape = mesh.shape
        self._tp, self._pp, self._stage_plan = check_serving_mesh(
            model, shape, slots=slots, pipeline_depth=self.pipeline_depth, spec=spec,
            constrained=constrained, kv_host_tier_mb=kv_host_tier_mb)
        self._mb_count = max(1, self.pipeline_depth) if self._pp > 1 else 1
        if mesh is None:
            return
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"a serving mesh of {mesh.size} ranks needs a process group over "
                f"them (distkeras_tpu_torch.parallel.distributed.initialize)")
        if sorted(int(r) for r in mesh.devices.flat) != list(range(dist.get_world_size())):
            raise ValueError(
                f"serving mesh ranks {mesh.devices.flatten().tolist()} must be the "
                f"process group's {dist.get_world_size()} ranks: one engine spans them all")
        from distkeras_tpu_torch.parallel.mesh import stage_submesh
        from distkeras_tpu_torch.serving.sharded import MeshLink

        if self._pp > 1:
            self._stage = mesh.coords(dist.get_rank())["pp"]
            self._stage_meshes = [stage_submesh(mesh, s) for s in range(self._pp)]
        self._link = MeshLink(mesh.devices.flatten(), self.device)
        # Every rank builds the mesh's groups in one order: the tp axis
        # (the model's sums and gathers), then the pp axis (the hops).
        mesh.group("tp")
        if self._pp > 1:
            mesh.group("pp")

    def _mesh_overrides(self) -> dict:
        """The decode config's tp mesh on a serving mesh (its tp axis may
        be 1: the model then sums nothing)."""
        return {} if self.mesh is None else {"tp_mesh": self.mesh}

    def _stage_cache(self, batch: int, device) -> dict:
        """The zero decode cache of this rank: on a pp mesh its stage's
        leaves only (``StagePlan.split_tree``), built without the rest."""
        if self._pp == 1:
            return decode_cache(self._cfg, batch, device)
        shapes = self._stage_plan.split_tree(decode_cache(self._cfg, batch, "meta"))[self._stage]
        return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                for k, v in shapes.items()}

    def _place_params(self, variables) -> dict:
        """Whole flat weights on this rank's device: all of them, or on a
        mesh this rank's share (``serving/sharded.py local_params``)."""
        dev = self.device
        with torch.inference_mode():
            if self.mesh is None:
                return {k: v.to(dev) for k, v in variables.items()}
            from distkeras_tpu_torch.models.bert import param_axes
            from distkeras_tpu_torch.serving.sharded import local_params

            variables = {k: torch.as_tensor(v) for k, v in variables.items()}
            return local_params(variables, self.mesh,
                                getattr(self.model, "param_axes", None) or param_axes,
                                self._stage_plan, self._stage, dev)

    _MIRRORED = ("_prefill", "_admit", "_decode_step", "_prefill_logits", "_fork_sample",
                 "_score_chunk", "_embed_chunk", "_draft_step", "_verify_step",
                 "_draft_prefill", "_draft_admit", "_copy_blocks", "_mask_row", "_upload",
                 "_fresh_row_cache", "_kv_gather", "_kv_scatter", "_place_params",
                 "_draft_prefill_slot", "_prefix_materialize", "_prefix_store",
                 "_mesh_counts")
    _ROOTS = ("_params", "_cache", "_tokens", "_temps", "_positions_dev", "_tables_dev",
              "_mask_dev", "_draft_params", "_draft_cache")

    def _bind_mesh(self) -> None:
        """Register the device state every rank holds (in one order) and
        turn the device operations into the leader's mirrored calls."""
        from distkeras_tpu_torch.serving.sharded import _registrable

        link = self._link
        # Each rank's device and resident bytes, once (the shapes never
        # change), for mesh_info's per-stage attribution.
        mine = {"device": str(self.device), "params_bytes": self._params_bytes,
                "kv_bytes": sum(v.numel() * v.element_size() for v in self._cache.values())}
        self._rank_info = [None] * len(link.ranks)
        torch.distributed.all_gather_object(self._rank_info, mine, group=link.group)
        for name in self._ROOTS:
            if getattr(self, name, None) is not None:
                setattr(self, name, _registrable(getattr(self, name)))
        link.bind(self, [n for n in self._MIRRORED if hasattr(self, n)], self._ROOTS)
        if self.prefix_cache is not None and link.is_leader:
            self.prefix_cache.store_rows = self._prefix_store
        link.active = True

    @property
    def is_leader(self) -> bool:
        """True on the rank that serves (always, without a mesh)."""
        return self._link is None or self._link.is_leader

    def follow(self) -> int:
        """A follower rank's loop: run the leader's operations on this
        rank's shard until the leader's :meth:`close`; returns how many
        ran. Raises on the leader and without a mesh."""
        if self._link is None or self._link.is_leader:
            raise RuntimeError("follow() runs on a follower rank of a serving mesh; "
                               "the leader runs run()")
        return self._link.follow()

    def close(self) -> None:
        """Leader of a serving mesh: end the followers' loops. A no-op
        without a mesh and on a second call."""
        if self._link is not None and self._link.is_leader:
            self._link.close()

    def _mesh_counts(self) -> list:
        """Every rank's decode compile count, gathered to every rank in
        rank order (a mirrored call: all ranks enter the gather)."""
        mine = self._counting_auditor.compiles("serving_decode")
        out = [None] * len(self._link.ranks)
        torch.distributed.all_gather_object(out, mine, group=self._link.group)
        return out

    def decode_compile_counts(self) -> list[int]:
        """Per-rank decode compile counts, rank order (each must stay 1:
        on a pp mesh that is one count per stage and tp rank); ``[count]``
        without a mesh."""
        if self._link is None:
            return [self.decode_compile_count()]
        return list(self._mesh_counts())

    def mesh_info(self) -> dict | None:
        """Static view of the engine's mesh for healthz/debugz (reference
        ``mesh_info``): axis sizes, tp and pp, the ranks with their devices
        and, on a pp mesh, each stage's ranks, layers and resident
        parameter and KV bytes (gathered once at construction). None
        unsharded."""
        if self.mesh is None:
            return None
        ranks = [int(r) for r in self.mesh.devices.flatten()]

        def name(r):
            return f"rank{r}:{self._rank_info[r]['device']}"

        info = {
            "axes": {a: int(s) for a, s in self.mesh.shape.items()},
            "tp": self._tp,
            "pp": self._pp,
            "devices": [name(r) for r in ranks],
        }
        if self._pp > 1:
            stages = []
            for s in range(self._pp):
                lo, hi = self._stage_plan.layer_range(s)
                members = [int(r) for r in self._stage_meshes[s].devices.flatten()]
                stages.append({
                    "stage": s, "layers": [lo, hi],
                    "devices": [name(r) for r in members],
                    "params_bytes": sum(self._rank_info[r]["params_bytes"] for r in members),
                    "kv_bytes": sum(self._rank_info[r]["kv_bytes"] for r in members),
                })
            info["stages"] = stages
        return info

    def _build_programs(self, top_k) -> None:
        """Bind the device functions of this engine's mode to its module,
        sampling generator and sentinel."""
        module, gen = self._module, self._gen
        if self._paged:
            self._prefill = functools.partial(_paged_prefill_fn, module, top_k, gen)
            self._admit = _paged_admit_fn
            decode = (_paged_decode_masked_fn if self._constrained_mode
                      else _paged_decode_fn)
            self._decode_step = functools.partial(decode, module, top_k, self._sentinel,
                                                  gen)
            self._copy_blocks = _copy_blocks
            self._mask_row = _mask_row_fn
            self._prefill_logits = functools.partial(_paged_prefill_logits_fn, module)
            self._fork_sample = functools.partial(_fork_sample_fn, top_k, gen)
            self._score_chunk = functools.partial(_score_chunk_fn, module)
            self._embed_chunk = functools.partial(_embed_chunk_fn, module)
        else:
            self._prefill = functools.partial(_prefill_fn, module, top_k, gen)
            self._admit = _admit_fn
            self._decode_step = functools.partial(_decode_fn, module, top_k, gen)
        if self._spec:
            self._draft_step = functools.partial(_spec_draft_fn, self._draft_module,
                                                 self.spec_k)
            verify = _paged_spec_verify_fn if self._paged else _spec_verify_fn
            self._verify_step = functools.partial(verify, module, top_k, gen)
            self._draft_prefill = functools.partial(_draft_prefill_fn, self._draft_module)
            self._draft_admit = _draft_admit_fn

    def decode_compile_count(self) -> int:
        """Number of abstract signatures the decode step has seen (must
        stay 1: admission must never change the decode step's shapes).
        Read from the caller's auditor, or the engine's private one."""
        return self._counting_auditor.compiles("serving_decode")

    def tick_timeline(self, n: int | None = None) -> list[dict]:
        """The bounded dispatch→harvest tick lane (most recent last): per
        tick, its dispatch/harvest stamps, how long the harvest blocked on
        the device, and the measured host gap."""
        log = list(self._tick_log)
        return log if n is None else log[-int(n):]

    def refresh_memory_metrics(self) -> list[dict]:
        """Publish the device's memory gauges through
        :func:`~distkeras_tpu_torch.telemetry.device.publish_memory_gauges`
        (``torch.cuda``'s allocator on the card; the typed "no data"
        sentinel on the CPU), this engine's parameter and KV pool bytes;
        return the per-device rows for healthz. Host-only, called per
        metricsz/healthz scrape."""
        kv_bytes = kv_peak = None
        if self.kv_pool is not None and self.kv_pool.bytes_per_block:
            kv_bytes = self.kv_pool.capacity * self.kv_pool.bytes_per_block
            kv_peak = self.kv_pool.peak_blocks_used * self.kv_pool.bytes_per_block
            self.metrics.set_kv_tier_resident_bytes(
                self.kv_pool.blocks_used * self.kv_pool.bytes_per_block)
        try:
            mems = publish_memory_gauges(
                self.metrics.registry, devices=[self.device],
                params_bytes=self._params_bytes, kv_pool_bytes=kv_bytes,
                kv_pool_peak_bytes=kv_peak)
        except Exception:
            return []
        return [m.to_dict() for m in mems]

    def tenant_snapshot(self) -> dict:
        """Per-tenant QoS rollup for healthz/debugz (refreshing the
        labeled tenant gauges on the way)."""
        active: dict[str, int] = {}
        for st in self._slot_state:
            if st is not None:
                t = st.request.tenant
                active[t] = active.get(t, 0) + 1
        out = self.scheduler.tenant_stats()
        for tenant, n in active.items():
            out.setdefault(tenant, {"queued": 0})["active_slots"] = n
        for tenant, counts in self.metrics.tenant_counters().items():
            out.setdefault(tenant, {"queued": 0}).update(counts)
        self.metrics.set_tenant_active(active)
        return out

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slot_state if s is not None)

    @property
    def free_slots(self) -> int:
        return self.slots - self.active_slots

    def debugz(self) -> dict:
        """Live state snapshot for the ``debugz`` control verb: the slot
        table (per-slot phase, trace_id, sequence depth, age; block-table
        depth when paged, automaton state, accept rate), the scheduler
        queue, prefix-cache or pool occupancy, and flight-recorder and SLO
        status. JSON-safe."""
        now = time.monotonic()
        slots = []
        for i, st in enumerate(self._slot_state):
            if st is None:
                slots.append({"slot": i, "state": "free"})
                continue
            req = st.request
            entry = {
                "slot": i,
                "state": ("prefill" if st.prefill is not None
                          else "fork_wait" if st.fork_wait
                          else "decode"),
                "kind": req.kind,
                "trace_id": req.trace_id,
                "tenant": req.tenant,
                "depth": len(req.prompt) + len(req.out_tokens),
                "remaining": st.remaining,
                "age_s": (round(now - req.t_submit, 6)
                          if req.t_submit is not None else None),
            }
            if self._paged:
                entry["blocks"] = st.first_block + len(st.blocks)
                entry["shared_blocks"] = st.first_block
            if st.dfa is not None:
                entry["automaton_state"] = st.dfa_state
            if self._spec and st.spec_drafted:
                entry["accept_rate"] = round(st.spec_accepted / st.spec_drafted, 3)
            if st.prefill is not None:
                entry["prefill"] = {
                    "pos": st.prefill.pos,
                    "prompt_tokens": len(req.prompt),
                    "chunks_done": st.prefill.chunks_done,
                }
            slots.append(entry)
        out = {
            "slots": slots,
            "active_slots": self.active_slots,
            "queue": self.scheduler.debugz(now),
            "tenants": self.tenant_snapshot(),
            "stopping": self._stopping,
            "pending_swap": self._pending_swap is not None,
            "decode_compile_count": self.decode_compile_count(),
            "weight_version": self.weight_version,
            "request_kinds": self.metrics.kind_counters(),
            "pipeline": {
                "depth": self.pipeline_depth,
                "inflight": (self._inflight[-1].kind
                             if self._inflight else None),
                "inflight_ticks": len(self._inflight),
                "ticks_logged": len(self._tick_log),
                "host_gap_p50_s": self.metrics.host_gap.gap_p50,
                "device_idle_ratio": self.metrics.host_gap.idle_ratio,
            },
        }
        if self._pp > 1:
            out["pipeline"]["stages"] = self._pp
            out["pipeline"]["micro_batches"] = self._mb_count
            out["pipeline"]["bubble_fraction"] = self.metrics.bubble.fraction
        if self.mesh is not None:
            out["mesh"] = self.mesh_info()
        if self._spec:
            drafted = self.metrics.spec_draft_tokens
            out["speculative"] = {
                "spec_k": self.spec_k,
                "draft_model": getattr(self.draft_model, "name", str(self.draft_model)),
                "draft_tokens": drafted,
                "accepted_tokens": self.metrics.spec_accepted_tokens,
                "accept_rate": (round(self.metrics.spec_accepted_tokens / drafted, 4)
                                if drafted else None),
            }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.debugz()
        if self.kv_pool is not None:
            out["kv_pool"] = {
                **self.kv_pool.debugz(),
                "blocks_free": self.kv_pool.blocks_free,
                "preemptions": self.metrics.preemptions,
                "oom_rejections": self.metrics.oom_rejections,
                "kv_migrations": self.metrics.kv_migrations,
                "kv_migration_fallbacks": self.metrics.kv_migration_fallbacks,
                "kv_migration_bytes": self.metrics.kv_migration_bytes,
                "kv_exports": self.metrics.kv_exports,
            }
            if self.kv_tier is not None:
                # Occupancy of the host/disk levels and the engine's
                # traffic through them, with the device level's resident
                # bytes, so the three tiers read off one dict.
                resident = self.kv_pool.blocks_used * (self.kv_pool.bytes_per_block or 0)
                self.metrics.set_kv_tier_resident_bytes(resident)
                out["kv_tier"] = {
                    **self.kv_tier.stats(),
                    "resident_bytes": resident,
                    "spills": self.metrics.kv_spills,
                    "spill_bytes": self.metrics.kv_spill_bytes,
                    "readmits": self.metrics.kv_readmits,
                    "readmit_bytes": self.metrics.kv_readmit_bytes,
                    "pushes": self.metrics.kv_pushes,
                    "push_bytes": self.metrics.kv_push_bytes,
                    "push_fallbacks": self.metrics.kv_push_fallbacks,
                }
        if self.flight_recorder is not None:
            out["flight_recorder"] = self.flight_recorder.stats()
        if self.trace_store is not None:
            out["trace_store"] = self.trace_store.stats()
        if self.slo_s is not None:
            out["slo_s"] = self.slo_s
        return out

    # -- submission ---------------------------------------------------------
    def _build_request(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        priority: int = 0,
        timeout: float | None = None,
        trace_id: str | None = None,
        speculate: bool = True,
        tenant: str = "default",
        resume_tokens=None,
        kind: str = "generate",
        n: int = 1,
        constraint=None,
    ) -> Request:
        """Validation half of submission, shared by :meth:`submit` and
        :meth:`submit_many`: everything that can reject a request typed
        BEFORE it touches the scheduler (reference ``_build_request``).
        ``resume_tokens``: output tokens the client already received
        elsewhere; they pre-seed ``out_tokens``, so the prefill covers
        prompt + resume and the first sampled token continues the stream."""
        if self._stopping:
            raise EngineStopped("engine is shutting down; not admitting")
        kind = str(kind or "generate")
        n = int(n or 1)
        if kind not in REQUEST_KINDS:
            raise ValueError(
                f"unknown request kind {kind!r}; expected one of "
                f"{REQUEST_KINDS}")
        if kind != "generate" and not self._paged:
            raise ValueError(
                f"kind={kind!r} requires a paged single-stage engine "
                f"(kv_pool_mb / kv_pool_blocks, pp=1)")
        if kind in SCORELIKE_KINDS:
            if max_new_tokens > 0:
                raise ValueError(
                    f"kind={kind!r} is prefill-only: max_new_tokens must "
                    f"be 0, got {max_new_tokens}")
            speculate = False
        if kind == "sample":
            if n < 2:
                raise ValueError(
                    f"kind='sample' requires n >= 2 forks, got {n}")
            if n > self.slots:
                raise ValueError(
                    f"n={n} forks exceed the engine's {self.slots} slots")
            if self._spec and speculate:
                raise ValueError(
                    "n>1 forked sampling does not compose with "
                    "speculative decoding; pass speculate=False")
            speculate = False
        elif n != 1:
            raise ValueError(f"n={n} requires kind='sample'")
        dfa = None
        if constraint is not None:
            if not self._constrained_mode:
                raise ValueError(
                    "this engine was not built with constrained=True; "
                    "token-mask constraints are unavailable")
            if kind != "generate":
                raise ValueError(
                    f"constraint requires kind='generate', got {kind!r}")
            dfa = (constraint if isinstance(constraint, TokenDFA)
                   else TokenDFA.from_spec(constraint))
            if dfa.max_token() >= self._cfg.vocab_size:
                raise ValueError(
                    f"constraint references token {dfa.max_token()} "
                    f">= vocab_size {self._cfg.vocab_size}")
        prompt_arr = np.asarray(prompt, np.int32)
        if prompt_arr.ndim == 2 and prompt_arr.shape[0] == 1:
            prompt_arr = prompt_arr[0]
        if prompt_arr.ndim != 1 or prompt_arr.size < 1:
            raise ValueError(f"prompt must be a non-empty 1-D token list; "
                             f"got shape {prompt_arr.shape}")
        if kind in SCORELIKE_KINDS:
            # Prefill-only: the whole prompt must fit the context.
            if prompt_arr.size > self.limit:
                raise ValueError(
                    f"prompt ({prompt_arr.size}) exceeds this engine's "
                    f"context cap {self.limit}")
        else:
            _check_context(self.model, self._cfg, prompt_arr[None, :], max_new_tokens)
            if prompt_arr.size + max_new_tokens > self.limit:
                raise ValueError(
                    f"prompt ({prompt_arr.size}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds this engine's context cap "
                    f"{self.limit} (max_context)")
        if self._paged:
            # Resident K/V at completion: every position but the last
            # sampled token's. A request that can never fit the pool is a
            # sizing error, rejected typed up front.
            bt = self.kv_block_tokens
            if kind in SCORELIKE_KINDS:
                need = -(-prompt_arr.size // bt)
            elif kind == "sample":
                # n forks share the prompt's COMPLETE blocks; each owns
                # the rest (partial tail copy + decode growth) itself.
                resident = prompt_arr.size + max_new_tokens - 1
                shared = prompt_arr.size // bt
                need = shared + n * (-(-resident // bt) - shared)
            else:
                resident = prompt_arr.size + max_new_tokens - 1
                need = -(-resident // bt)
            if need > self.kv_pool.capacity:
                self.metrics.record_oom_reject()
                raise PoolExhausted(
                    f"request needs {need} KV blocks at completion; the "
                    f"pool holds {self.kv_pool.capacity} — raise "
                    f"--kv-pool-mb or lower max_new_tokens")
        req = Request(
            prompt_arr.tolist(), max_new_tokens, temperature=temperature,
            priority=priority, timeout=timeout, trace_id=trace_id,
            speculate=speculate, tenant=tenant, kind=kind, n=n, constraint=dfa,
        )
        if resume_tokens:
            try:
                resume = [int(t) for t in resume_tokens]
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad resume_tokens: {e}") from None
            if len(resume) >= max_new_tokens:
                raise ValueError(
                    f"resume_tokens ({len(resume)}) >= max_new_tokens "
                    f"({max_new_tokens}): nothing left to decode")
            req.out_tokens = resume
        if self._trace_requests:
            req.trace = TimelineRecord(req.trace_id, "engine",
                                       self.trace_source)
            req.trace.data["kind"] = req.kind
            req.trace.event("submit", prompt_tokens=len(req.prompt),
                            max_new_tokens=req.max_new_tokens,
                            priority=req.priority, tenant=req.tenant,
                            kind=req.kind)
        return req

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        priority: int = 0,
        timeout: float | None = None,
        trace_id: str | None = None,
        speculate: bool = True,
        tenant: str = "default",
        resume_tokens=None,
        kind: str = "generate",
        n: int = 1,
        constraint=None,
    ) -> Request:
        """Validate and enqueue a request; returns the streaming handle.

        Raises :class:`ValueError` (bad prompt / context overflow / bad
        kind), :class:`PoolExhausted` (can never fit the paged pool),
        :class:`QueueFullError` (backpressure), :class:`TenantOverQuota`,
        or :class:`EngineStopped` (shutting down), all before any device
        work."""
        req = self._build_request(
            prompt, max_new_tokens, temperature=temperature,
            priority=priority, timeout=timeout, trace_id=trace_id,
            speculate=speculate, tenant=tenant,
            resume_tokens=resume_tokens, kind=kind, n=n,
            constraint=constraint)
        try:
            self.scheduler.submit(req)
        except ServingError:
            self.metrics.record_reject()
            raise
        self.metrics.record_request_kind(req.kind)
        return req

    def submit_many(self, specs) -> list:
        """Batched admission for the binary front door: every spec is
        validated and handed to the scheduler in ONE ``submit_many`` call.
        Returns a list aligned with ``specs``: a :class:`Request` per
        accepted entry, the typed exception per rejected one."""
        built: list = []
        for spec in specs:
            try:
                built.append(self._build_request(
                    spec["prompt"], spec["max_new_tokens"],
                    temperature=float(spec.get("temperature", 0.0)),
                    priority=int(spec.get("priority", 0)),
                    timeout=spec.get("timeout"),
                    trace_id=spec.get("trace_id"),
                    speculate=bool(spec.get("speculate", True)),
                    tenant=str(spec.get("tenant") or "default"),
                    resume_tokens=spec.get("resume_tokens"),
                    kind=str(spec.get("kind") or "generate"),
                    n=int(spec.get("n") or 1),
                    constraint=spec.get("constraint"),
                ))
            except (ServingError, KeyError, TypeError, ValueError) as e:
                built.append(e)
        reqs = [r for r in built if isinstance(r, Request)]
        outcomes = iter(self.scheduler.submit_many(reqs))
        out: list = []
        for r in built:
            if not isinstance(r, Request):
                self.metrics.record_reject()
                out.append(r)
                continue
            err = next(outcomes)
            if err is not None:
                self.metrics.record_reject()
                out.append(err)
            else:
                self.metrics.record_request_kind(r.kind)
                out.append(r)
        return out

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self, drain: bool = True) -> None:
        """Stop admitting. ``drain=True`` finishes in-flight requests
        before :meth:`run` returns; ``drain=False`` errors them out."""
        self._stopping = True
        self._draining = drain
        if self.flight_recorder is not None:
            self.flight_recorder.record_event("shutdown", drain=drain)
        self.scheduler.kick()

    def request_param_swap(self, variables, provenance: dict | None = None):
        """Queue an in-place parameter swap of the target model (the
        server's ``reload`` verb; reference ``request_param_swap``).

        ``variables``: the port's flat ``state_dict``, or a reference-layout
        tree (``{"params": ...}`` as a weight file holds it, or the params
        tree itself), which goes through the weight bridge. Every leaf's
        name, shape and dtype must match the serving model's: a mismatch
        raises ``ValueError`` here. ``provenance`` (the new weights'
        version stamp) becomes :attr:`weight_version` when the swap lands;
        without one the version is bumped by one with no digest.

        The swap runs inside the engine loop at the first iteration with
        no slot in flight and no queued request holding streamed tokens:
        the weights move to the device, the cached K/V (computed under the
        old weights) is flushed, and one decode tick rewarms the step,
        which under an armed auditor proves the swap kept its signature.
        Returns ``(event, result)``: await the event, then check
        ``result`` for ``"error"``."""
        if self._pending_swap is not None:
            raise RuntimeError("a parameter swap is already pending")
        params = as_state_dict(variables)
        whole = self._whole_params  # name -> (shape, dtype) of the whole weights
        if set(params) != set(whole):
            missing = sorted(set(whole) - set(params))[:4]
            extra = sorted(set(params) - set(whole))[:4]
            raise ValueError(
                f"reload weights have {len(params)} leaves; serving model has "
                f"{len(whole)} (missing {missing}, unexpected {extra})")
        for name, (shape, dtype) in whole.items():
            new = params[name]
            if tuple(new.shape) != shape or new.dtype != dtype:
                raise ValueError(
                    f"reload weight leaf {name} is "
                    f"{str(new.dtype).removeprefix('torch.')}{tuple(new.shape)}; "
                    f"serving model expects "
                    f"{str(dtype).removeprefix('torch.')}{shape}")
        if provenance is None:
            provenance = {
                "version": int(self.weight_version.get("version") or 0) + 1,
                "digest": None,
            }
        else:
            provenance = _public_provenance(provenance)
        event: asyncio.Event = asyncio.Event()
        result: dict = {}
        self._pending_swap = (params, event, result, provenance)
        self.scheduler.kick()  # wake an idle run loop now
        return event, result

    def cancel_param_swap(self, event: asyncio.Event) -> bool:
        """Withdraw a pending swap (reload-verb timeout path). True if it
        was still pending; False if the loop already consumed it."""
        if self._pending_swap is not None and self._pending_swap[1] is event:
            self._pending_swap = None
            return True
        return False

    # -- KV block migration (serving/kv_transfer.py) -------------------------
    def request_kv_export(self, prompt):
        """Queue a KV block export: serialize the pool's longest
        complete-block chain for ``prompt`` (a prefix-trie walk: a slot
        that finished or was preempted has ADOPTED its blocks there, so
        "export a slot's blocks" and "export a cached prefix" are one
        walk), continued from the host tier where the device chain ends.
        Serviced by the run loop between iterations; returns ``(event,
        result)``: await the event, then read ``result`` (``payload`` bytes
        and ``matched_tokens``, or ``error``). Raises
        :class:`~distkeras_tpu_torch.serving.kv_transfer.KVTransferError`
        at once on a dense engine (blocks only exist paged)."""
        if not self._paged:
            raise KVTransferError(
                "KV export requires a paged engine (--paged / "
                "--kv-pool-mb): dense caches have no block bookkeeping")
        if self._pp > 1:
            raise KVTransferError(
                "KV export is not supported on a pp mesh yet: the "
                "gather program spans the whole pool, which is "
                "stage-partitioned under pp")
        event: asyncio.Event = asyncio.Event()
        result: dict = {}
        self._pending_kv.append(("export", prompt, event, result))
        self.scheduler.kick()
        return event, result

    def request_kv_import(self, payload: bytes):
        """Queue a KV block import: validate a peer's KVX1 payload
        (geometry and weight provenance), adopt its block chain into the
        pool's trie and upload the rows, after which an admission of the
        same prompt is a zero-copy prefix hit. Same ``(event, result)``
        contract as :meth:`request_kv_export`; a dry pool adopts what fits
        (possibly nothing) and reports it in ``result``: an import must
        only ever help."""
        if not self._paged:
            raise KVTransferError(
                "KV import requires a paged engine (--paged / "
                "--kv-pool-mb)")
        if self._pp > 1:
            raise KVTransferError(
                "KV import is not supported on a pp mesh yet: the "
                "scatter program spans the whole pool, which is "
                "stage-partitioned under pp")
        event: asyncio.Event = asyncio.Event()
        result: dict = {}
        self._pending_kv.append(("import", payload, event, result))
        self.scheduler.kick()
        return event, result

    def _tp_heads(self) -> tuple[int, int] | None:
        """``(index, count)`` of this rank along the mesh's tp axis, or None
        below tp=2."""
        if self._tp == 1:
            return None
        return self.mesh.coords(torch.distributed.get_rank())["tp"], self._tp

    def _kv_gather(self, rows) -> list[torch.Tensor]:
        """Pool rows ``rows`` of every KV leaf, in KVX1 leaf order, as host tensors ``[len(rows), block_tokens, H, D]``: one
        ``index_select`` per leaf with a 1-d index tensor, copied into
        pinned memory on the engine's stream, which is then waited for.
        Queued after every dispatched tick, the gather reads what those
        ticks wrote. On a tp mesh every rank gathers the whole heads over
        tp first (the reference's contract, ``kv_transfer.py:25-35``):
        a payload always holds full heads."""
        ids = self._upload(np.asarray(rows, np.int64))
        tp = self._tp_heads()
        out = []
        with torch.inference_mode():
            for name in self._kv_names:
                rows_dev = self._cache[name].index_select(0, ids)
                if tp is not None:
                    parts = [torch.empty_like(rows_dev) for _ in range(tp[1])]
                    with span("tp_gather"):
                        torch.distributed.all_gather(parts, rows_dev.contiguous(),
                                                     group=self.mesh.group("tp"))
                    rows_dev = torch.cat(parts, dim=2)
                if self.device.type == "cuda":
                    host = torch.empty(rows_dev.shape, dtype=rows_dev.dtype,
                                       pin_memory=True)
                    host.copy_(rows_dev, non_blocking=True)
                    rows_dev = host
                out.append(rows_dev)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _kv_scatter(self, rows, leaves) -> None:
        """Write host rows ``leaves`` (KVX1 leaf order, ``[n, ...]`` each,
        whole heads) into pool rows ``rows`` of every KV leaf:
        a pinned non-blocking upload and one in-place ``index_copy_`` per
        leaf, queued on the engine's stream behind every dispatched tick.
        A tp rank keeps its own heads of each row."""
        ids = self._upload(np.asarray(rows, np.int64))
        tp = self._tp_heads()
        with torch.inference_mode():
            for name, data in zip(self._kv_names, leaves):
                pool = self._cache[name]
                if tp is not None:
                    h = pool.shape[2]
                    data = data[:, :, tp[0] * h:(tp[0] + 1) * h]
                src = data.to(pool.dtype)
                if self.device.type == "cuda":
                    src = src.pin_memory().to(self.device, non_blocking=True)
                pool.index_copy_(0, ids, src)

    def _kv_export_sync(self, prompt) -> dict:
        """Executor-thread export: pin the chain, gather its pool rows,
        serialize. The pin only needs to span this call: the engine loop
        serializes every pool mutation."""
        tokens = [int(t) for t in prompt]
        bt = self.kv_block_tokens
        match = self.kv_pool.match_blocks(tokens)
        try:
            n = len(match.ids)
            leaves = self._kv_gather(match.ids) if n else []
            # Continue the chain from the host/disk tier where the device
            # trie ends: an evicted-but-spilled family stays exportable.
            n = self._extend_export_from_tier(tokens, n, leaves)
            if n == 0:
                return {"matched_tokens": 0, "blocks": 0, "payload": None}
            payload = serialize_blocks(
                tokens[:n * bt], leaves, block_tokens=bt,
                provenance=self.weight_version)
        finally:
            self.kv_pool.release(match)
        if len(payload) > MAX_TOTAL_TRANSFER_BYTES:
            # Oversize chains split across sequenced KVBLK frames on the
            # wire (kv_transfer.split_frames); only a chain past the TOTAL
            # cap is refused.
            raise KVTransferError(
                f"serialized blocks ({len(payload)} bytes) exceed the "
                f"transfer cap ({MAX_TOTAL_TRANSFER_BYTES}); receiver "
                f"falls back to monolithic prefill")
        self.metrics.record_kv_export(len(payload))
        return {"matched_tokens": n * bt, "blocks": n,
                "bytes": len(payload), "payload": payload}

    def _check_kv_leaves(self, header) -> None:
        """Typed rejects of a payload this pool cannot adopt: block
        geometry, leaf count, per-leaf shape and dtype, weight
        provenance."""
        if int(header["block_tokens"]) != self.kv_block_tokens:
            raise KVTransferError(
                f"block geometry mismatch: peer blocks hold "
                f"{header['block_tokens']} tokens, this pool "
                f"{self.kv_block_tokens}")
        theirs = header.get("leaves", [])
        if len(theirs) != len(self._kv_names):
            raise KVTransferError(
                f"KV leaf count mismatch: payload has {len(theirs)}, "
                f"this pool {len(self._kv_names)}")
        for i, (meta, name) in enumerate(zip(theirs, self._kv_names)):
            leaf = self._cache[name]
            want = (tuple(int(d) for d in meta["shape"][1:]), str(meta["dtype"]))
            # A payload holds whole heads; a tp rank's pools hold H/tp.
            bt, h, d = leaf.shape[1:]
            have = ((bt, h * self._tp, d), str(leaf.dtype).removeprefix("torch."))
            if want != have:
                raise KVTransferError(
                    f"KV leaf {i} geometry mismatch: payload "
                    f"{want[1]}{want[0]}, this pool {have[1]}{have[0]}")
        if not self._tier_provenance_ok(header):
            # KV is a pure function of (weights, tokens): adopting blocks
            # computed under other weights would poison every later hit.
            prov = header.get("provenance") or {}
            mine = self.weight_version
            raise KVTransferError(
                f"weight provenance mismatch: blocks computed under "
                f"v{prov.get('version')}/{prov.get('digest')}, serving "
                f"v{mine.get('version')}/{mine.get('digest')}")

    def _kv_import_sync(self, payload) -> dict:
        """Executor-thread import: validate geometry and provenance (typed
        rejects), adopt the chain, scatter the new rows."""
        header, leaves = deserialize_blocks(payload)
        self._check_kv_leaves(header)
        tokens = [int(t) for t in header.get("tokens", [])]
        n_blocks = int(header.get("n_blocks") or 0)
        uploads, resident = self.kv_pool.adopt_foreign(tokens, n_blocks)
        if uploads:
            idxs = torch.tensor([i for i, _ in uploads], dtype=torch.int64)
            self._kv_scatter([r for _, r in uploads],
                             [leaf.index_select(0, idxs) for leaf in leaves])
        return {"adopted_blocks": len(uploads),
                "resident_blocks": resident,
                "matched_tokens": resident * self.kv_block_tokens,
                "bytes": len(payload)}

    # -- tiered KV cache (serving/kv_tier.py) --------------------------------
    def _spill_block(self, chain_tokens, row: int) -> None:
        """Pool spill hook: serialize ONE eviction victim's pool row into
        the host tier as KVX1 bytes, keyed by its full root-to-block token
        chain, so a spilled block is readmittable here and exportable to
        the fleet."""
        self._spill_blocks([(chain_tokens, row)])

    def _spill_blocks(self, victims) -> None:
        """Batched pool spill hook (``spill_many_hook``): serialize a whole
        allocation burst's eviction victims from ONE device-to-host gather;
        ``victims`` is the burst's ``(chain_tokens, row)`` list, rows still
        holding their K/V. Each block's spill latency is recorded as its
        share of the burst."""
        tier = self.kv_tier
        if tier is None or not victims:
            return
        t0 = time.monotonic()
        bt = self.kv_block_tokens
        n = len(victims)
        leaves = self._kv_gather([int(r) for _, r in victims])
        stored: list[int] = []
        for i, (chain_tokens, _row) in enumerate(victims):
            chain = [int(t) for t in chain_tokens]
            payload = serialize_blocks(
                chain[-bt:], [leaf[i:i + 1] for leaf in leaves],
                block_tokens=bt, provenance=self.weight_version)
            if tier.put(chain, payload):
                stored.append(len(payload))
        per_block_s = (time.monotonic() - t0) / n
        for nbytes in stored:
            self.metrics.record_kv_spill(nbytes, per_block_s,
                                         trace_id=self._tier_trace_id)
        if stored:
            self.scheduler.note_kv_arrival()

    def _tier_provenance_ok(self, header) -> bool:
        prov = header.get("provenance") or {}
        mine = self.weight_version
        return (int(prov.get("version") or 0), prov.get("digest")) == (
            int(mine.get("version") or 0), mine.get("digest"))

    def _readmit_from_tier(self, tokens, trace_id: str | None = None) -> int:
        """Extend the device trie along ``tokens`` from the host tier: for
        each complete block past the device-resident prefix, fetch its
        KVX1 payload, adopt a pool row (never preempting: adoption only
        reclaims unreferenced leaves) and upload all the rows in ONE
        batched scatter. Runs on the loop thread during admission, after
        the pipeline barrier and BEFORE the trie match, so the readmitted
        blocks count as the prefix hits they are. Returns the number of
        blocks readmitted."""
        tier, pool = self.kv_tier, self.kv_pool
        if tier is None:
            return 0
        bt = self.kv_block_tokens
        toks = [int(t) for t in tokens]
        # Same last-block holdback as match(): prefill needs >= 1 uncached
        # token, so a block match() will not use is a wasted row.
        cap = max(0, (len(toks) - 1) // bt)
        resident = pool.probe(toks) // bt
        if resident >= cap or not tier.contains(toks[:(resident + 1) * bt]):
            return 0
        t0 = time.monotonic()
        staged: list[tuple[int, list]] = []  # (pool row, per-leaf [1, bt, ...])
        nbytes = 0
        k = resident
        while k < cap:
            chain = toks[:(k + 1) * bt]
            payload = tier.get(chain)
            if payload is None:
                break
            try:
                header, leaves = deserialize_blocks(payload)
            except Exception:
                break  # truncated or corrupt entry: stop, never raise
            if (int(header.get("block_tokens") or 0) != bt
                    or len(leaves) != len(self._kv_names)
                    or not self._tier_provenance_ok(header)):
                break
            # adopt_foreign re-walks the chain from the root: the resident
            # prefix is touched, block k gets a fresh row (or none on a dry
            # pool: stop there, what fit is already a win).
            uploads, _ = pool.adopt_foreign(chain, k + 1)
            if not uploads:
                break
            staged.append((uploads[0][1], leaves))
            nbytes += len(payload)
            k += 1
        if not staged:
            return 0
        self._kv_scatter(
            [r for r, _ in staged],
            [torch.cat([blk[li] for _, blk in staged]) for li in range(len(self._kv_names))])
        self.metrics.record_kv_readmit(len(staged), nbytes,
                                       time.monotonic() - t0, trace_id=trace_id)
        self.scheduler.note_kv_arrival()
        return len(staged)

    def _extend_export_from_tier(self, tokens, n: int, leaves: list) -> int:
        """Continue an export chain past the device-resident prefix with
        host-tier payloads: deserialize each contiguous tier block and
        append its rows to ``leaves`` (in place). Returns the new block
        count. Export has NO last-block holdback (as ``match_blocks``): a
        peer adopting the chain wants the whole spilled prefix."""
        tier = self.kv_tier
        if tier is None:
            return n
        bt = self.kv_block_tokens
        n_total = len(tokens) // bt
        extras, k = [], n
        while k < n_total:
            payload = tier.get(tokens[:(k + 1) * bt])
            if payload is None:
                break
            try:
                header, lv = deserialize_blocks(payload)
            except Exception:
                break
            if (int(header.get("block_tokens") or 0) != bt
                    or not self._tier_provenance_ok(header)):
                break
            want = len(leaves) if leaves else (
                len(extras[0]) if extras else len(lv))
            if len(lv) != want or not lv:
                break
            extras.append(lv)
            k += 1
        if not extras:
            return n
        if not leaves:
            leaves.extend(torch.cat([e[i] for e in extras])
                          for i in range(len(extras[0])))
        else:
            for i in range(len(leaves)):
                leaves[i] = torch.cat([leaves[i]] + [e[i] for e in extras])
        return k

    def _tier_pending(self, req) -> bool:
        """True when a parked request's next uncovered block sits in the
        host tier (or a peer import is queued): it waits on a tier
        arrival, not on a slot to free."""
        if self._pending_kv:
            return True
        if self.kv_tier is None:
            return False
        toks = [int(t) for t in req.prompt]
        bt = self.kv_block_tokens
        resident = self.kv_pool.probe(toks) // bt
        return self.kv_tier.contains(toks[:(resident + 1) * bt])

    async def wait_for_kv(self, tokens, timeout_s: float) -> bool:
        """Await KV residency of ``tokens``' first block in ANY local tier
        (device pool or host tier): the decode side's wait behind a
        router-scheduled push (``kv_wait``). True when resident, False on
        timeout (the caller pulls or re-prefills: counted fallbacks, never
        errors)."""
        if not self._paged:
            return False
        toks = [int(t) for t in tokens]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while True:
            if self.kv_pool.probe(toks) > 0 or (
                    self.kv_tier is not None and self.kv_tier.probe(toks) > 0):
                return True
            remaining = deadline - loop.time()
            if remaining <= 0:
                return False
            await self.scheduler.wait_for_kv_arrival(remaining)

    def _swap_sync(self, params) -> None:
        """Executor-thread half of the swap: transfer (on a mesh, each
        rank its share), flush, rewarm."""
        dev = self.device
        self._params = self._place_params(params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if self.prefix_cache is not None:
            # Pooled K/V is a function of (weights, tokens): every cached
            # block is wrong under new weights.
            self.prefix_cache.flush()
        if self.kv_pool is not None:
            # Zero active slots means zero slot-owned blocks: the flush
            # only drops trie entries. flush() bypasses the allocator, so
            # no old-weight block is spilled.
            self.kv_pool.flush()
        if self.kv_tier is not None:
            # The host/disk tiers hold K/V of the OLD weights too.
            self.kv_tier.flush()
        # Rewarm: one decode tick over the all-free batch.
        self._decode_sync()

    def reopen(self) -> None:
        """Re-arm admission after a drain shutdown; the device state
        persists, so one engine can serve several load phases."""
        if self._running:
            raise RuntimeError("cannot reopen while run() is active")
        self._stopping = False
        self._draining = True
        self.scheduler.reset_loop_state()

    async def run(self, idle_poll_s: float = 0.05) -> None:
        """Main loop: expire, swap, admit, grow, decode, stream — until
        shutdown."""
        if self._running:
            raise RuntimeError("engine.run() is already active")
        if not self.is_leader:
            raise RuntimeError("a follower rank of a serving mesh runs follow(), not run()")
        self._running = True
        if self.flight_recorder is not None:
            self.flight_recorder.record_event("engine_start",
                                              slots=self.slots)
        loop = asyncio.get_running_loop()
        try:
            while True:
                now = time.monotonic()
                # 1. Shed queued requests that died waiting: deadline
                # passed, or caller cancelled (client disconnect).
                for req in self.scheduler.expire(now):
                    if req.cancelled:
                        self._finish_error(req, RequestCancelled(
                            "cancelled while queued"))
                    else:
                        self.metrics.record_expire()
                        self._finish_error(req, RequestTimeout(
                            f"deadline exceeded after {req.timeout}s in queue"))
                # 2. Free active slots whose request died mid-decode,
                # after a pipeline barrier (which may FINISH some of them;
                # re-check before tearing down).
                dead = [i for i, st in enumerate(self._slot_state)
                        if st is not None
                        and (st.request.cancelled
                             or (st.request.deadline is not None
                                 and now > st.request.deadline))]
                if dead:
                    await self._pipeline_barrier(loop)
                for i in dead:
                    st = self._slot_state[i]
                    if st is None:
                        continue  # finished at the barrier
                    dl = st.request.deadline
                    if st.request.cancelled:
                        self._finish_error(st.request, RequestCancelled(
                            f"cancelled with {st.remaining} tokens undecoded"))
                        self._release_prefill(st)
                        self._free_slot_paged(i, st)
                        self._slot_state[i] = None
                    elif dl is not None and now > dl:
                        self.metrics.record_expire()
                        self._finish_error(st.request, RequestTimeout(
                            f"deadline exceeded after {st.request.timeout}s "
                            f"with {st.remaining} tokens undecoded"))
                        self._release_prefill(st)
                        self._free_slot_paged(i, st)
                        self._slot_state[i] = None
                # 3. Shutdown: flush the queue with typed errors.
                if self._stopping:
                    for req in self.scheduler.drain():
                        self._finish_error(
                            req, EngineStopped("engine shut down while queued"))
                # 3b. Pending parameter swap: only with NO slot in flight
                # and no queued request holding streamed tokens (a
                # preempted resume finishes under the weights it started
                # with); before admission, so no request reads old-weight
                # blocks.
                if (self._pending_swap is not None
                        and self.active_slots == 0
                        and not self.scheduler.has_streamed()):
                    await self._pipeline_barrier(loop)
                    params, ev, res, prov = self._pending_swap
                    self._pending_swap = None
                    if self.flight_recorder is not None:
                        self.flight_recorder.record_event(
                            "param_swap", version=prov.get("version"),
                            digest=prov.get("digest"))
                    with span("param_swap"):
                        try:
                            await self._in_executor(loop, self._swap_sync, params)
                            self.weight_version = prov
                            self.metrics.set_weight_version(prov)
                            res["ok"] = True
                            res["weight_version"] = prov
                        except Exception as e:
                            res["error"] = e
                        finally:
                            if not res:
                                res["error"] = ServingError("engine died mid-swap")
                            ev.set()
                # 3c. KV block transfers (export to / import from a peer):
                # serviced between iterations after a barrier, so a gather
                # or scatter never interleaves with a tick over the same
                # rows. Device work in the executor, event resolution on
                # the loop thread.
                if self._paged and self._pending_kv:
                    await self._pipeline_barrier(loop)
                    ops, self._pending_kv = self._pending_kv, []
                    for kind, arg, ev, res in ops:
                        with span("kv_transfer", kind=kind):
                            try:
                                res.update(await self._in_executor(
                                    loop,
                                    (self._kv_export_sync if kind == "export"
                                     else self._kv_import_sync), arg))
                            except Exception as e:
                                res["error"] = e
                            finally:
                                ev.set()
                    # Imported blocks ARE a tier arrival: wake a parked
                    # admission and a decode-side wait_for_kv.
                    self.scheduler.note_kv_arrival()
                # 4. Admission: prefill queued requests into free slots.
                # Admission writes into the batch (and, paged, reserves or
                # preempts blocks): barrier first, unless the queue head
                # is parked on a dry pool that nothing has freed since.
                if (not self._stopping and len(self.scheduler)
                        and self.free_slots and not self._parked_head()):
                    await self._pipeline_barrier(loop)
                if not self._stopping:
                    while self.free_slots and len(self.scheduler):
                        if self._parked_head():
                            break
                        # Fresh clock per pop: an earlier admission's
                        # prefill may have outlived more queued deadlines.
                        req = self.scheduler.pop(time.monotonic())
                        if req is None:
                            break
                        if req.kind == "sample" and self.free_slots < req.n:
                            # The fork fan-out claims its n slots up front.
                            self.scheduler.requeue(req)
                            break
                        slot = self._slot_state.index(None)
                        paged_job = None
                        if self._paged:
                            paged_job = self._reserve_paged(req, slot)
                            if paged_job is None:
                                break  # parked until blocks free
                            self._parked_at_version = None
                            self._parked_req = None
                        wait = time.monotonic() - req.t_submit
                        self.metrics.record_admit(wait)
                        if req.queue_wait_s is None:
                            req.queue_wait_s = wait
                            req.admit_iteration = self.metrics.iterations
                        if req.weight_version is None:
                            req.weight_version = self.weight_version
                        if req.trace is not None:
                            req.trace.data["weight_version"] = (
                                req.weight_version)
                            req.trace.event("admit", slot=slot,
                                            dur_s=round(wait, 9))
                            req.trace.data["queue_wait_s"] = round(wait, 9)
                            req.trace.data["admit_iteration"] = (
                                self.metrics.iterations)
                        if self.flight_recorder is not None:
                            self.flight_recorder.record_event(
                                "admit", trace_id=req.trace_id, slot=slot)
                        now_t = time.monotonic()
                        # Resume-aware: a preempted request re-admits with
                        # its streamed tokens folded into the prefill.
                        st = _SlotState(
                            req,
                            req.max_new_tokens - len(req.out_tokens),
                            now_t, t_admit=now_t)
                        if paged_job is not None:
                            (st.prefill, st.blocks, st.first_block,
                             st.match) = paged_job
                        if req.constraint is not None:
                            st.dfa = req.constraint
                            st.dfa_state = req.constraint.start
                        self._slot_state[slot] = st
                        if req.kind == "sample":
                            # Claim the n-1 child slots now, parked out of
                            # the decodable set until the fan-out.
                            st.fork_idx = 0
                            req.fork_completions = [None] * req.n
                            for _ in range(req.n - 1):
                                c = self._slot_state.index(None)
                                self._slot_state[c] = _SlotState(
                                    req, st.remaining, now_t,
                                    t_admit=now_t, fork_wait=True)
                        with span("admit", slot=slot,
                                  trace_id=req.trace_id,
                                  prompt_len=len(req.prompt),
                                  queue_wait_s=round(wait, 6)):
                            if st.prefill is None:
                                # Dense: prefix-cache lookup + copy.
                                st.prefill = await self._in_executor(
                                    loop, self._begin_prefill, req)
                            if self._chunk is None:
                                # Monolithic prefill: the whole uncached
                                # tail, admitted inline (near-context-limit
                                # prompts may take a few pow2 sub-chunks).
                                tok0 = None
                                while tok0 is None:
                                    tok0 = await self._in_executor(
                                        loop, self._prefill_step, st, slot)
                                self._route_admission(st, slot, tok0)
                # 4b. Chunked prefill: ONE chunk per iteration TOTAL,
                # round-robin across prefilling slots, interleaved with
                # the decode tick below. Runs during drain shutdown too.
                if self._chunk is not None:
                    pending = [i for i, st in enumerate(self._slot_state)
                               if st is not None and st.prefill is not None]
                    if pending:
                        await self._pipeline_barrier(loop)
                        start = self._prefill_rr
                        i = min(pending,
                                key=lambda s: (s - start) % self.slots)
                        self._prefill_rr = (i + 1) % self.slots
                        st = self._slot_state[i]
                        with span("prefill_tick", slot=i,
                                  offset=st.prefill.pos):
                            tok0 = await self._in_executor(
                                loop, self._prefill_step, st, i)
                        if tok0 is not None:
                            self._route_admission(st, i, tok0)
                # 5. Nothing active? Flush the pipeline and wait.
                if self.active_slots == 0:
                    await self._pipeline_barrier(loop)
                    if self._stopping:
                        break
                    if self._paged and self._parked_req is not None and self._parked_head():
                        # Fully parked: only an arrival, a cancel or a kick
                        # can change the picture; waiting for a request
                        # would return at once on the non-empty queue. A
                        # head whose next block sits in the host tier (or
                        # behind a queued import) waits on the tier-arrival
                        # event instead.
                        if self._tier_pending(self._parked_req):
                            await self.scheduler.wait_for_kv_arrival(idle_poll_s)
                        else:
                            await self.scheduler.wait_for_wake(idle_poll_s)
                    else:
                        await self.scheduler.wait_for_request(idle_poll_s)
                    continue
                if self._stopping and not self._draining:
                    await self._pipeline_barrier(loop)
                    for i, st in enumerate(self._slot_state):
                        if st is not None:
                            self._finish_error(st.request, EngineStopped(
                                "engine shut down mid-decode"))
                            self._release_prefill(st)
                            self._free_slot_paged(i, st)
                            self._slot_state[i] = None
                    break
                # 5c. Paged growth: every decoding slot whose next write
                # crosses into an unallocated block chains one more,
                # preempting the lowest-priority youngest slot (possibly
                # itself) on a dry pool. Barrier first only when some slot
                # needs a block.
                if self._paged:
                    needy = [i for i, st in enumerate(self._slot_state)
                             if st is not None and st.prefill is None
                             and self._needs_tail_block(i)]
                    if needy and not self._grow_from_free_list(needy):
                        await self._pipeline_barrier(loop)
                    for i in range(self.slots):
                        st = self._slot_state[i]
                        if st is not None and st.prefill is None:
                            self._ensure_tail_block(i)
                # 6. One decode (or speculative) iteration for the whole
                # batch, skipped while EVERY active slot is still
                # mid-prefill.
                await self._tick_step(loop)
                if self.inject_decode_delay_s > 0:
                    await asyncio.sleep(self.inject_decode_delay_s)
                self.metrics.sample(
                    len(self.scheduler), self.active_slots, self.slots)
                # Yield so the server can read sockets between iterations.
                await asyncio.sleep(0)
        except BaseException as e:
            # A device failure, or the embedder cancelling the run() task,
            # must not strand clients: every in-flight and queued request
            # gets a terminal error event before the exception propagates.
            err = ServingError(f"engine failure: {e!r}")
            self._inflight.clear()
            for i, st in enumerate(self._slot_state):
                if st is not None:
                    self._finish_error(st.request, err)
                    self._release_prefill(st)
                    self._free_slot_paged(i, st, adopt=False)
                    self._slot_state[i] = None
            for req in self.scheduler.drain():
                self._finish_error(req, err)
            if self._pending_swap is not None:
                _, ev, res, _ = self._pending_swap
                self._pending_swap = None
                res["error"] = err
                ev.set()
            # Same for pending KV transfers: a peer awaiting an export gets
            # its typed failure now, not a hung timeout.
            if self._paged and self._pending_kv:
                ops, self._pending_kv = self._pending_kv, []
                for _, _, ev, res in ops:
                    res["error"] = err
                    ev.set()
            self._stopping = True
            if self.flight_recorder is not None:
                self.flight_recorder.crash_dump(error=repr(e))
            raise
        finally:
            self._running = False

    def _parked_head(self) -> bool:
        """True while the queue head is the request parked on a dry pool
        and the pool's version has not moved since."""
        return (self._paged and self._parked_req is not None
                and self._parked_at_version == self.kv_pool.version
                and self.scheduler.peek() is self._parked_req)

    # -- decode pipeline ----------------------------------------------------
    async def _tick_step(self, loop) -> None:
        """One decode (or speculative) tick, pipelined: a plain tick is
        dispatched FIRST, then tick N harvested and streamed while N+1
        executes. A speculative tick (or ``pipeline_depth=0``, or a live
        constrained row, whose mask depends on the last token) harvests
        before the next dispatch."""
        decodable = self._decodable()
        if not decodable:
            if self._inflight:
                # Every dispatched row disappeared (a cancel barrier tore
                # them down before the harvest): flush.
                await self._pipeline_barrier(loop)
            return

        def want_spec() -> bool:
            # A zero-accept row committed nothing: one interleaved
            # fallback tick gives it a token before speculation resumes.
            return (self._spec
                    and not self._spec_owe_fallback
                    and any(self._slot_state[i].request.temperature <= 0
                            and self._slot_state[i].request.speculate
                            for i in decodable))

        spec_tick = want_spec()
        constrained_live = (self._constrained_mode and any(
            self._slot_state[i].dfa is not None for i in decodable))
        if self._inflight and (spec_tick or constrained_live
                               or any(t.kind == "spec" for t in self._inflight)):
            await self._pipeline_barrier(loop)
            decodable = self._decodable()
            if not decodable:
                return
            spec_tick = want_spec()
        if spec_tick:
            if self._paged:
                for i in decodable:
                    req = self._slot_state[i].request
                    # Lookahead only for rows that will speculate.
                    if req.temperature <= 0 and req.speculate:
                        self._alloc_lookahead(i)
            with span("spec_tick", active=self.active_slots, k=self.spec_k):
                self._inflight.append(await self._dispatch(loop, self._spec_dispatch))
        else:
            with span("decode_tick", active=self.active_slots):
                self._inflight.append(await self._dispatch(loop, self._decode_dispatch))
            # Harvest the oldest tick past the in-flight window, with the
            # newest already on the device.
            while len(self._inflight) > 1:
                await self._complete_tick(loop, self._inflight.popleft())
        if self._arm_after_warmup and self.auditor is not None:
            # The first dispatch IS the warmup (a speculative engine ran
            # all three tick callables at construction).
            self._arm_after_warmup = False
            self.auditor.arm(*self._decode_audit_names)
        if self.pipeline_depth == 0:
            await self._pipeline_barrier(loop)

    async def _dispatch(self, loop, fn) -> _InflightTick:
        """Run one tick dispatch: the first ever in the executor, warm
        ones inline on the loop thread."""
        if self._dispatch_warm:
            return fn()
        tick = await self._in_executor(loop, fn)
        self._dispatch_warm = True
        return tick

    async def _pipeline_barrier(self, loop) -> None:
        """Drain the pipeline: harvest, stream, and tear down the in-flight
        tick (if any)."""
        while self._inflight:
            await self._complete_tick(loop, self._inflight.popleft())

    async def _complete_tick(self, loop, tick: _InflightTick) -> None:
        """Harvest one dispatched tick and do its host half: stream the
        committed tokens of every row that was decodable at dispatch and
        is still alive, then tear down rows that finished. A row whose
        slot emptied between dispatch and harvest is dropped like a
        mid-prefill garbage row."""
        if tick.kind == "spec":
            if _tick_ready(tick):
                out, commit, caps = self._harvest_spec(tick)
            else:
                out, commit, caps = await self._in_executor(
                    loop, self._harvest_spec, tick)
            self._spec_owe_fallback = any(
                int(commit[i]) == 0 for i in tick.rows
                if self._slot_state[i] is not None)
        else:
            if _tick_ready(tick):
                nxt = self._harvest_decode(tick)
            else:
                nxt = await self._in_executor(loop, self._harvest_decode, tick)
            if self._spec:
                self._spec_owe_fallback = False
        t = time.monotonic()
        with span("stream", active=self.active_slots):
            for i in tick.rows:
                st = self._slot_state[i]
                if st is None or st.prefill is not None:
                    continue
                if tick.kind == "spec":
                    self._stream_spec(st, out[i], int(commit[i]), int(caps[i]), t)
                else:
                    self._push_token(st, int(nxt[i]), t)
                if st.remaining == 0:
                    if self._paged:
                        # A still-dispatched later tick advanced this
                        # slot's watermark; roll it back BEFORE adoption,
                        # so the trie never claims an in-flight write.
                        for later in self._inflight:
                            if i in later.advanced:
                                self._lens[i] -= 1
                                later.advanced.discard(i)
                                self._positions_dirty = True
                    if st.fork_idx is not None:
                        self._finish_fork_row(i, st)
                    else:
                        self._finish_ok(st.request)
                        self._free_slot_paged(i, st)
                        self._slot_state[i] = None

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _in_executor(loop, fn, *args):
        """run_in_executor with contextvars propagated, so telemetry spans
        opened in the executor thread parent to the loop-side span that
        dispatched them."""
        ctx = contextvars.copy_context()
        return loop.run_in_executor(None, lambda: ctx.run(fn, *args))

    @staticmethod
    def _pow2_fit(P: int, room: int) -> int:
        """Shrink a pad width to the largest power of two that fits the
        remaining cache room (the prefill overshoot guard — see
        :meth:`_prefill_step`). Shared by the target and draft prefills."""
        if P > room:
            P = 1
            while P * 2 <= room:
                P *= 2
        return P

    def _bucket(self, n: int, cap: int | None = None) -> int:
        """Prefill pad length: next power of two >= n (>= min bucket),
        capped at the decodable context (and at ``cap``, the chunk size,
        for a ragged final chunk)."""
        b = self._min_bucket
        while b < n:
            b *= 2
        return min(b, self.limit if cap is None else min(cap, self.limit))

    def _release_prefill(self, st: _SlotState) -> None:
        """Drop a slot's pending prefill (cancel/expiry/shutdown paths):
        unpin its prefix-cache match so the blocks become evictable."""
        if st.prefill is not None:
            if self.prefix_cache is not None:
                self.prefix_cache.release(st.prefill.match)
            st.prefill = None

    def _route_admission(self, st: _SlotState, slot: int, tok0) -> None:
        """Hand a completed prefill to its kind's finisher: a first token
        to decode admission, the scorelike sentinel to the prefill-only
        completion, fork tokens to the fan-out."""
        if tok0 is _SCORELIKE_DONE:
            self._finish_scorelike(st, slot)
        elif isinstance(tok0, _ForkReady):
            self._finish_fork(st, slot, tok0.tokens)
        else:
            self._finish_admission(st, slot, tok0)

    def _table_row(self, slot: int) -> torch.Tensor:
        return self._upload(self._tables[slot])

    def _scorelike_chunk(self, st: _SlotState, slot: int, padded, c: int, s0: int) -> None:
        """One score/embed prefill chunk (executor thread): the paged
        prefill's K/V writes with the kind's epilogue accumulated on the
        host: the next-token log-probabilities for score, the hidden-state
        sum for embed."""
        job, req = st.prefill, st.request
        hg = self.metrics.host_gap
        dev = self.device
        padded_dev = self._upload(padded)
        if req.kind == "score":
            targets = np.zeros((padded.shape[1],), np.int32)
            for j in range(c):
                p = job.pos + j + 1
                if p < s0:
                    targets[j] = req.prompt[p]
            self._cache, picked = self._score_chunk(
                self._params, self._cache, padded_dev, job.pos, c,
                self._table_row(slot), self._upload(targets))
            hg.harvest_started()
            vals = picked.cpu().numpy()
            hg.harvest_ended()
            if st.score_acc is None:
                st.score_acc = []
            for j in range(c):
                if job.pos + j + 1 < s0:
                    st.score_acc.append(float(vals[j]))
        else:
            self._cache, vec = self._embed_chunk(
                self._params, self._cache, padded_dev, job.pos, c, self._table_row(slot))
            hg.harvest_started()
            v = vec.cpu().numpy().astype(np.float64)
            hg.harvest_ended()
            st.embed_acc = v if st.embed_acc is None else st.embed_acc + v

    def _finish_scorelike(self, st: _SlotState, slot: int) -> None:
        """Complete a score/embed request: publish its result on the
        Request, adopt the prompt's K/V into the prefix trie, and free the
        slot (it never entered the decodable set)."""
        req = st.request
        t = time.monotonic()
        req.t_first_token = t
        self.metrics.record_first_token(t - req.t_submit, trace_id=req.trace_id)
        if req.kind == "score":
            req.logprobs = list(st.score_acc or [])
        else:
            s0 = max(1, len(req.prompt))
            vec = (st.embed_acc if st.embed_acc is not None
                   else np.zeros((1,), np.float64))
            req.embedding = [float(v) / s0 for v in vec]
        self._finish_ok(req)
        self._free_slot_paged(slot, st)
        self._slot_state[slot] = None

    def _finish_fork(self, st: _SlotState, slot: int, toks: list) -> None:
        """Fan a completed fork-parent prefill out to its n rows (loop
        thread). The prompt's COMPLETE blocks are shared copy-on-write
        through pool refcounts (:meth:`KVBlockPool.fork`); a partially
        filled tail block, the one site a fork would write, is copied per
        child (counted as a CoW copy). Each row then owns its table row,
        sampling state and private token stream; the done record carries
        all n completions."""
        req = st.request
        pool = self.kv_pool
        bt = self.kv_block_tokens
        s0 = len(req.prompt)
        n = req.n
        children = [i for i, s in enumerate(self._slot_state)
                    if s is not None and s.fork_wait and s.request is req]
        complete = s0 // bt
        partial = s0 % bt
        shared = [int(b) for b in self._tables[slot][:complete]]
        if shared and children:
            pool.fork(shared, n)
            self.metrics.record_fork_blocks((n - 1) * len(shared))
        parent_tail = int(self._tables[slot][complete]) if partial and children else None
        t = time.monotonic()
        req.t_first_token = t
        self.metrics.record_first_token(t - req.t_submit, trace_id=req.trace_id)
        rows = [(slot, st)] + [(c, self._slot_state[c]) for c in children]
        dry = False
        dev = self.device
        for k, (i, row_st) in enumerate(rows):
            row_st.fork_idx = k
            row_st.fork_tokens = [int(toks[k])]
            row_st.fork_wait = False
            row_st.last_token_t = t
            row_st.remaining = req.max_new_tokens - 1
            if i != slot:
                table = self._tables[i]
                table[:] = self._sentinel
                table[:complete] = shared
                row_st.blocks = list(shared)
                if partial:
                    ids = pool.alloc(1)
                    if ids is None:
                        dry = True
                        break
                    table[complete] = ids[0]
                    row_st.blocks.append(int(ids[0]))
                    self._cache = self._copy_blocks(self._cache, parent_tail, int(ids[0]))
                    pool.note_cow_copy()
                self._lens[i] = s0
            with span("cache_admit", slot=i):
                self._tokens, self._temps = self._admit(
                    self._tokens, self._temps, i, self._upload(np.int32(toks[k])),
                    self._upload(np.float32(req.temperature)))
        self._mark_tables_dirty()
        if dry:
            # Pool dry mid-fan-out: error the whole group typed, never a
            # partial fork.
            self.metrics.record_oom_reject()
            self._finish_error(req, PoolExhausted("KV pool exhausted during fork fan-out"))
            self._teardown_fork(req)
            return
        if req.trace is not None:
            req.trace.event("fork", n=n, shared_blocks=len(shared),
                            cow_copies=(n - 1) if partial else 0)
        if req.max_new_tokens <= 1:
            for i, row_st in rows:
                self._finish_fork_row(i, row_st)

    def _finish_fork_row(self, i: int, st: _SlotState) -> None:
        """One fork row finished: bank its completion; the LAST row to
        finish resolves the shared request (one done with all n)."""
        req = st.request
        req.fork_completions[st.fork_idx] = list(st.fork_tokens or [])
        self._free_slot_paged(i, st, adopt=False)
        self._slot_state[i] = None
        if all(c is not None for c in req.fork_completions):
            self._finish_ok(req)

    def _teardown_fork(self, req: Request) -> None:
        """Free every slot of a fork group (error paths): shared blocks
        drop one refcount per row, so the pool drains exactly."""
        for i, s in enumerate(self._slot_state):
            if s is not None and s.request is req:
                self._free_slot_paged(i, s, adopt=False)
                self._slot_state[i] = None

    def _finish_admission(self, st: _SlotState, slot: int, tok0: int) -> None:
        """Loop-thread bookkeeping once a slot's prefill completed: stream
        the first token (TTFT stamp, unless a preempted request resumes)
        and free the slot if one token was all the request wanted."""
        t = time.monotonic()
        if st.request.t_first_token is None:
            self._push_token(st, tok0, t, first=True)
            st.remaining -= 1
        else:
            self._push_token(st, tok0, t)
        if st.remaining == 0:
            self._finish_ok(st.request)
            self._free_slot_paged(slot, st)
            self._slot_state[slot] = None

    def _fresh_row_cache(self) -> dict:
        with torch.inference_mode():
            return self._stage_cache(1, self.device)

    def _begin_prefill(self, req: Request) -> _PrefillJob:
        """Start a prompt's prefill (executor thread, dense): build the
        single-row cache, on a prefix-cache hit straight from the matched
        pool blocks, on a miss as zeros. The uncached tail runs through
        :meth:`_prefill_step` chunk by chunk."""
        match, matched = None, 0
        if self.prefix_cache is not None:
            match = self.prefix_cache.match(req.prompt)
            matched = match.matched_tokens
        if matched:
            with span("prefix_splice", blocks=len(match.ids),
                      tokens=matched):
                cache = self._prefix_materialize(match.ids)
        else:
            cache = self._fresh_row_cache()
        if req.trace is not None and matched:
            req.trace.event("prefix_splice", tokens=matched,
                            blocks=len(match.ids))
        return _PrefillJob(cache=cache, pos=matched, match=match,
                           matched_tokens=matched)

    @staticmethod
    def _resident_tokens(req: Request) -> list:
        """The slot's full resident sequence: prompt plus already-streamed
        tokens (a preempted request resumes with its output folded in)."""
        return (req.prompt + req.out_tokens if req.out_tokens
                else req.prompt)

    def _prefill_step(self, st: _SlotState, slot: int):
        """Run ONE prefill chunk for the slot (executor thread). Returns
        None while the prompt is still incomplete. On the final chunk the
        dense engine stores the prompt's new blocks into the prefix cache
        and writes the single-row cache into batch row ``slot``, while the
        paged engine has nothing to move (the chunks wrote into the slot's
        blocks) and only sets the sampling state. Returns the first token,
        :data:`_SCORELIKE_DONE` for score/embed, or a :class:`_ForkReady`
        for a fork parent."""
        req, job = st.request, st.prefill
        tokens = self._resident_tokens(req)
        s0 = len(tokens)
        rem = s0 - job.pos
        c = rem if self._chunk is None else min(self._chunk, rem)
        if self._chunk is None:
            P = self._bucket(c)
        elif c == self._chunk:
            P = self._chunk  # full chunk: ONE fixed width
        else:
            P = self._bucket(c, cap=self._chunk)  # ragged final chunk
        # The pad width must never overshoot the cache: with job.pos + P >
        # cache length the dense per-slot KV write would clamp its start
        # backward over the spliced prefix rows (paged writes past the
        # table are dropped, but the positional window would clamp). Shrink
        # to the largest power of two that fits; the next call(s) finish
        # the remainder.
        room = self._cache_len - job.pos
        if P > room:
            P = self._pow2_fit(P, room)
            c = min(c, P)
        padded = np.zeros((1, P), np.int32)
        padded[0, :c] = tokens[job.pos:job.pos + c]
        dev = self.device
        t0 = time.monotonic()
        hg = self.metrics.host_gap
        final = job.pos + c >= s0
        special = None
        tok = temp = None
        with span("prefill", bucket=P, offset=job.pos, prompt_len=s0):
            padded_dev = self._upload(padded)
            temp = self._upload(np.float32(req.temperature))
            # The chunk counts as dispatched device work (stamped before
            # its launches, as a decode tick is), so admission phases do
            # not book their prefill time as device idle.
            hg.tick_dispatched()
            if self._paged and req.kind in SCORELIKE_KINDS:
                tok0 = None
                self._scorelike_chunk(st, slot, padded, c, s0)
            elif self._paged and final and (req.kind == "sample" or st.dfa is not None):
                # The final chunk hands the logits row back: the fork
                # fan-out samples n first tokens from it, constrained
                # admission masks it first.
                self._cache, logits = self._prefill_logits(
                    self._params, self._cache, padded_dev, job.pos, c,
                    self._table_row(slot))
                hg.harvest_started()
                if req.kind == "sample":
                    temps_n = self._upload(np.full((req.n,), req.temperature, np.float32))
                    forks = self._fork_sample(logits, temps_n)
                    special = _ForkReady([int(t) for t in forks.cpu().numpy()])
                    tok0 = None
                else:
                    mask = st.dfa.mask_row(st.dfa_state, self._cfg.vocab_size)
                    if req.temperature > 0:
                        row = self._mask_row(logits, self._upload(mask))
                        tok = self._fork_sample(row, temp[None])[0]
                        tok0 = int(tok)
                    else:
                        # The reference's host argmax over the masked row.
                        tok0 = int(np.argmax(logits.cpu().numpy() + mask))
                        tok = self._upload(np.int32(tok0))
                hg.harvest_ended()
            elif self._paged:
                self._cache, tok = self._prefill(
                    self._params, self._cache, padded_dev, job.pos, c,
                    self._table_row(slot), temp)
                hg.harvest_started()
                tok0 = int(tok)  # blocks: honest device time per chunk
                hg.harvest_ended()
            else:
                job.cache, tok = self._prefill(
                    self._params, job.cache, padded_dev, job.pos, c, temp)
                hg.harvest_started()
                tok0 = int(tok)  # blocks: honest device time per chunk
                hg.harvest_ended()
        chunk_s = time.monotonic() - t0
        job.device_s += chunk_s
        job.chunks_done += 1
        if req.trace is not None:
            req.trace.event("prefill_chunk", offset=job.pos, tokens=c,
                            bucket=P, dur_s=round(chunk_s, 9))
        job.pos += c
        if self._paged:
            # Written-KV watermark: a preemption between chunks adopts or
            # frees exactly the positions written so far.
            self._lens[slot] = job.pos
        if job.pos < s0:
            return None
        # Prompt complete.
        if req.kind in SCORELIKE_KINDS or special is not None:
            # score/embed never join the decodable set; a fork parent's
            # per-row admits happen at the fan-out on the loop thread.
            self.metrics.record_prefill(
                job.device_s, job.chunks_done, job.matched_tokens, s0)
            self._note_prefill(req, job)
            st.prefill = None
            return special if special is not None else _SCORELIKE_DONE
        if self._paged:
            with span("cache_admit", slot=slot):
                self._tokens, self._temps = self._admit(
                    self._tokens, self._temps, slot, tok, temp)
            # The slot joins the decodable set: re-upload at the next tick.
            self._mark_tables_dirty()
        else:
            # Store the complete blocks this prefill computed (future
            # requests sharing the prefix hit them), then write the row
            # into the live batch cache.
            if self.prefix_cache is not None:
                with span("prefix_insert", prompt_len=s0):
                    self.prefix_cache.insert(req.prompt, job.cache)
                self.prefix_cache.release(job.match)
            with span("cache_splice", slot=slot):
                self._cache, self._tokens, self._temps = self._admit(
                    self._cache, self._tokens, self._temps, slot,
                    job.cache, tok, temp)
        self.metrics.record_prefill(
            job.device_s, job.chunks_done,
            job.matched_tokens if (self._paged or self.prefix_cache is not None) else None,
            s0)
        if self._spec:
            # The draft's prompt K/V, built once the target prefill
            # finished; the slot's fed-token truth is s0 for both models.
            with span("draft_prefill", slot=slot, prompt_len=s0):
                self._draft_prefill_slot(slot, tokens)
            self._spec_pos[slot] = s0
        self._note_prefill(req, job)
        st.prefill = None
        return tok0

    @staticmethod
    def _note_prefill(req: Request, job: _PrefillJob) -> None:
        req.prefill_device_s += job.device_s
        req.prefill_chunks += job.chunks_done
        req.prefix_hit_tokens = int(job.matched_tokens or 0)
        if req.trace is not None:
            req.trace.data.update(
                prefill_device_s=round(job.device_s, 9),
                prefill_chunks=job.chunks_done,
                cache_hit_tokens=job.matched_tokens)

    def _decodable(self) -> list[int]:
        """Slots whose row is live and past prefill: the rows whose tick
        output is streamed (everyone else decodes garbage)."""
        return [i for i in range(self.slots)
                if self._slot_state[i] is not None
                and self._slot_state[i].prefill is None
                and not self._slot_state[i].fork_wait]

    def _mark_tables_dirty(self) -> None:
        """A table row (or the decodable set) changed: the next dispatch
        rebuilds and uploads both the masked tables and the positions."""
        self._tables_dirty = True
        self._positions_dirty = True

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of host array ``arr`` on the device. On the card it goes
        through pinned memory with a non-blocking copy: a copy from
        pageable memory would wait for the stream, that is for the tick
        still in flight, and undo the pipeline's overlap."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _upload_tables(self, decodable):
        """Device view of the block tables, MASKED to the sentinel for rows
        that must not write (free and mid-prefill slots: their output is
        discarded and the dropped writes keep them off live blocks).
        Rebuilt only when the dirty flag is set."""
        if self._tables_dirty or self._tables_dev is None:
            tables = np.full_like(self._tables, self._sentinel)
            for i in decodable:
                tables[i] = self._tables[i]
            self._tables_dev = self._upload(tables)
            self._tables_dirty = False
        return self._tables_dev

    def _upload_positions(self, rows):
        """Device positions, rebuilt from the host ``_lens`` truth only
        when the dirty flag is set; otherwise the vector the last decode
        step returned."""
        if self._positions_dirty or self._positions_dev is None:
            positions = np.zeros((self.slots,), np.int32)
            for i in rows:
                positions[i] = self._lens[i]
            self._positions_dev = self._upload(positions)
            self._positions_dirty = False
        return self._positions_dev

    def _upload_mask(self):
        """Device view of the per-slot token mask, re-uploaded only when a
        DFA advanced (or a constrained slot was torn down) since the last
        tick; the upload is timed into ``mask_upload_seconds``."""
        if self._mask_dirty or self._mask_dev is None:
            t0 = time.monotonic()
            self._mask_dev = self._upload(self._mask_host)
            self.metrics.record_mask_upload(time.monotonic() - t0)
            self._mask_dirty = False
        return self._mask_dev

    def _set_slot_mask(self, i: int, st: _SlotState | None) -> None:
        """Refresh slot ``i``'s mask row from its DFA state; clears the row
        for non-DFA slots."""
        if not self._constrained_mode:
            return
        if st is not None and st.dfa is not None:
            self._mask_host[i, :] = st.dfa.mask_row(st.dfa_state, self._cfg.vocab_size)
            st.request.mask_uploads += 1
        else:
            self._mask_host[i, :] = 0.0
        self._mask_dirty = True

    def _ready_event(self):
        if self.device.type != "cuda":
            return None
        ready = torch.cuda.Event()
        ready.record()
        return ready

    def _decode_dispatch(self) -> _InflightTick:
        """Queue ONE plain decode tick and return WITHOUT waiting for the
        device. The new token vector is the tick's harvest handle; the
        next tick reads it as its input and writes a new one. Paged: each
        decodable row's watermark advances by one, recorded in
        ``advanced`` so a teardown found before the harvest can undo it."""
        rows = tuple(self._decodable())
        # Stamped before the launches: an eager step queues its first
        # kernel at once, so the device's queue stops being empty here.
        t = self.metrics.host_gap.tick_dispatched()
        if self._paged:
            tables_dev = self._upload_tables(rows)
            positions_dev = self._upload_positions(rows)
            extra = (self._upload_mask(),) if self._constrained_mode else ()
            self._cache, self._tokens, self._positions_dev = self._decode_step(
                self._params, self._cache, self._tokens, self._temps,
                positions_dev, tables_dev, *extra)
            for i in rows:
                self._lens[i] += 1
        else:
            self._cache, self._tokens = self._decode_step(
                self._params, self._cache, self._tokens, self._temps)
            if self._spec:
                for i in rows:
                    self._spec_pos[i] += 1
        return _InflightTick(kind="decode", rows=rows, t_dispatch=t,
                             tokens=self._tokens, advanced=set(rows),
                             ready=self._ready_event())

    def _harvest_decode(self, tick: _InflightTick) -> np.ndarray:
        """The one D2H per tick: blocks until the device finishes the tick,
        then hands its token vector to the loop thread for streaming."""
        hg = self.metrics.host_gap
        hg.harvest_started()
        nxt = tick.tokens.cpu().numpy()
        t = hg.harvest_ended()
        self._log_tick(tick, t)
        return nxt

    def _log_tick(self, tick: _InflightTick, t: float) -> None:
        hg = self.metrics.host_gap
        self._tick_log.append({
            "kind": tick.kind, "rows": len(tick.rows),
            "t_dispatch": tick.t_dispatch, "t_harvest": t,
            "harvest_wait_s": round(hg.last_harvest_wait, 9),
            "host_gap_s": round(hg.last_gap, 9),
        })

    def _decode_sync(self) -> np.ndarray:
        """Serialized dispatch + harvest: the construction warm-up and the
        swap rewarm."""
        return self._harvest_decode(self._decode_dispatch())

    # -- speculative decoding (draft/verify) --------------------------------
    def _spec_dispatch(self) -> _InflightTick:
        """Queue one speculative tick: the draft proposes spec_k tokens per
        row, ONE target call verifies them, the accept decides each row's
        commit. No position advances here: the advance is the commit,
        which only the harvest knows."""
        decodable = self._decodable()
        spec_ok = np.zeros((self.slots,), bool)
        remaining = np.zeros((self.slots,), np.int32)
        positions = np.zeros((self.slots,), np.int32)
        prev = np.zeros((self.slots,), np.int32)
        for i in decodable:
            st = self._slot_state[i]
            spec_ok[i] = st.request.temperature <= 0 and st.request.speculate
            remaining[i] = st.remaining
            positions[i] = self._lens[i] if self._paged else self._spec_pos[i]
            # The token at position fed-1, for the draft's heal step: the
            # resident sequence's second-to-last element.
            out_t = st.request.out_tokens
            if len(out_t) >= 2:
                prev[i] = out_t[-2]
            elif out_t:
                prev[i] = st.request.prompt[-1]
            else:
                prev[i] = st.request.prompt[-2 if len(st.request.prompt) >= 2 else -1]
        t = self.metrics.host_gap.tick_dispatched()
        start = self._upload(positions)
        self._draft_cache, drafts = self._draft_step(
            self._draft_params, self._draft_cache, self._upload(prev),
            self._tokens, start)
        spec_ok_dev = self._upload(spec_ok)
        remaining_dev = self._upload(remaining)
        if self._paged:
            # ``room`` doubles as the accounting cap: a commit clamped by
            # allocation pressure must not read as a draft rejection.
            caps = np.zeros((self.slots,), np.int32)
            for i in decodable:
                caps[i] = self._spec_room(i)
            if self._constrained_mode:
                # Forbidden drafts are rejected before the verify can
                # commit them: each constrained greedy row's cap is the
                # DFA-valid prefix of its drafts; sampled constrained rows
                # cap at 0 and are served by masked fallback ticks.
                drafts_host = None
                for i in decodable:
                    sti = self._slot_state[i]
                    if sti.dfa is None:
                        continue
                    if not spec_ok[i]:
                        caps[i] = 0
                        continue
                    if drafts_host is None:
                        drafts_host = drafts.cpu().numpy()
                    caps[i] = min(int(caps[i]),
                                  sti.dfa.valid_prefix(sti.dfa_state, drafts_host[i]))
            tables_dev = self._upload_tables(decodable)
            self._cache, self._tokens, out, commit = self._verify_step(
                self._params, self._cache, self._tokens, drafts, self._temps,
                spec_ok_dev, remaining_dev, self._upload(caps), start,
                tables_dev)
        else:
            caps = np.full((self.slots,), self.spec_k, np.int32)
            self._cache, self._tokens, out, commit = self._verify_step(
                self._params, self._cache, self._tokens, drafts, self._temps,
                spec_ok_dev, remaining_dev, start)
        return _InflightTick(kind="spec", rows=tuple(decodable), t_dispatch=t,
                             out=out, commit=commit, caps=caps,
                             ready=self._ready_event())

    def _harvest_spec(self, tick: _InflightTick):
        """Spec-tick harvest: the one D2H reads the committed tokens and
        commit counts, then the watermarks advance by each row's commit."""
        hg = self.metrics.host_gap
        hg.harvest_started()
        out = tick.out.cpu().numpy()
        commit = tick.commit.cpu().numpy()
        t = hg.harvest_ended()
        for i in tick.rows:
            if self._paged:
                self._lens[i] += int(commit[i])
            else:
                self._spec_pos[i] += int(commit[i])
        if self._paged:
            # Variable-width commits: the device positions no longer match.
            self._positions_dirty = True
        self._log_tick(tick, t)
        return out, commit, tick.caps

    def _spec_sync(self):
        """Serialized spec tick (construction warm-up): dispatch and
        harvest on the spot; returns ``(out, commit, caps)``."""
        return self._harvest_spec(self._spec_dispatch())

    def _spec_room(self, i: int) -> int:
        """Contiguous allocated K/V positions from slot ``i``'s write
        offset, capped at the window: how many of this tick's window
        writes will land."""
        bt = self.kv_block_tokens
        lens = int(self._lens[i])
        blk = lens // bt
        allocated = 0
        while blk < self._table_blocks and self._tables[i, blk] != self._sentinel:
            allocated += bt
            blk += 1
        return min(allocated - lens % bt, self.spec_k)

    def _alloc_lookahead(self, i: int) -> None:
        """Pre-tick growth for a speculating slot: chain blocks so the
        whole window can land. Never preempts: a dry pool only shrinks the
        row's room."""
        st = self._slot_state[i]
        bt = self.kv_block_tokens
        last = (int(self._lens[i]) + self.spec_k - 1) // bt
        for blk in range(int(self._lens[i]) // bt, min(last, self._table_blocks - 1) + 1):
            if self._tables[i, blk] != self._sentinel:
                continue
            ids = self.kv_pool.alloc(1)
            if ids is None:
                return
            self._tables[i, blk] = ids[0]
            st.blocks.extend(ids)
            self._mark_tables_dirty()

    def _draft_prefill_slot(self, slot: int, tokens) -> None:
        """Build the draft's prompt K/V for a freshly admitted slot
        (executor thread): pow2-bucketed chunks into a single-row cache,
        then one write into the draft's batch cache."""
        with torch.inference_mode():
            row = decode_cache(self._draft_cfg, 1, self.device)
        pos, s0 = 0, len(tokens)
        while pos < s0:
            c = s0 - pos
            P = self._pow2_fit(self._bucket(c), self._cache_len - pos)
            c = min(c, P)
            padded = np.zeros((1, P), np.int32)
            padded[0, :c] = tokens[pos:pos + c]
            row = self._draft_prefill(self._draft_params, row,
                                      torch.from_numpy(padded).to(self.device), pos, c)
            pos += c
        self._draft_cache = self._draft_admit(self._draft_cache, slot, row)

    # -- paged-KV internals (host bookkeeping; no device work) --------------
    def _blocks_for(self, first_token: int, last_token: int) -> int:
        """Blocks covering token positions [first_token, last_token]."""
        bt = self.kv_block_tokens
        return last_token // bt - first_token // bt + 1

    def _reserve_paged(self, req: Request, slot: int):
        """Admission-time reservation (loop thread): pin the longest shared
        prefix chain, allocate private blocks for the rest of the prompt,
        and point the slot's table at both. Returns ``(job, blocks,
        first_block, match)``, or None after parking the request (requeued
        at its class head) because the pool is dry and nobody strictly
        lower-priority is running. Admission only preempts strictly
        lower-priority slots; growth may preempt within a class."""
        pool = self.kv_pool
        tokens = self._resident_tokens(req)
        if self.kv_tier is not None:
            # Host-tier readmission BEFORE the match: blocks the trie evicted
            # (but the tier kept) scatter back and then count as the prefix
            # hits they are. The spill exemplar points at this admission.
            self._tier_trace_id = req.trace_id
            try:
                self._readmit_from_tier(tokens, trace_id=req.trace_id)
            finally:
                self._tier_trace_id = None
        # Scorelike requests skip the match: their point is the values the
        # prefill computes at every position.
        match = pool.match(tokens if req.kind not in SCORELIKE_KINDS else tokens[:0])
        m = match.matched_tokens
        first_block = m // self.kv_block_tokens
        needed = self._blocks_for(m, len(tokens) - 1)
        ids = pool.alloc(needed)
        while ids is None:
            # Fork and scorelike rows are never preemption victims.
            victims = [
                (i, s) for i, s in enumerate(self._slot_state)
                if s is not None and s.request.priority > req.priority
                and s.request.kind == "generate"]
            if not victims:
                pool.release(match)
                self.scheduler.requeue(req)
                self._parked_at_version = pool.version
                self._parked_req = req
                return None
            i, _ = max(victims, key=lambda v: (v[1].request.priority, v[1].t_admit))
            self._preempt_slot(i)
            ids = pool.alloc(needed)
        row = self._tables[slot]
        row[:] = self._sentinel
        row[:first_block] = match.ids
        row[first_block:first_block + needed] = ids
        self._mark_tables_dirty()
        self._lens[slot] = m
        if req.trace is not None and m:
            req.trace.event("prefix_splice", tokens=m, blocks=first_block)
        job = _PrefillJob(cache=None, pos=m, match=None, matched_tokens=m)
        return job, ids, first_block, match

    def _needs_tail_block(self, i: int) -> bool:
        """True when slot ``i``'s next write position crosses into an
        unallocated block. A row whose watermark reached the table's end
        needs nothing (a finishing row's depth-1 advance)."""
        blk = int(self._lens[i]) // self.kv_block_tokens
        return blk < self._table_blocks and self._tables[i, blk] == self._sentinel

    def _grow_from_free_list(self, needy: list) -> bool:
        """Growth without a pipeline barrier, where the barrier could
        change nothing: a plain engine (no speculative or constrained
        tick, whose rows may finish or shift at the harvest), no row of
        ``needy`` finishing at the in-flight tick's harvest, and enough
        blocks on the free list, so that no allocation evicts or
        preempts. The in-flight tick reads its own uploaded tables, and
        the next tick's writes queue behind it. Returns False, having
        changed nothing, when a barrier is needed."""
        if (not self._inflight or self._spec or self._constrained_mode
                or self.kv_pool.blocks_free < len(needy)
                or any(self._slot_state[i].remaining <= 1 for i in needy)):
            return False
        for i in needy:
            blk = int(self._lens[i]) // self.kv_block_tokens
            ids = self.kv_pool.alloc(1)
            self._tables[i, blk] = ids[0]
            self._slot_state[i].blocks.extend(ids)
        self._mark_tables_dirty()
        return True

    def _ensure_tail_block(self, i: int) -> bool:
        """Pre-tick growth: give slot ``i``'s next write position a block,
        preempting the lowest-priority youngest slot (itself included) on
        a dry pool. Returns False when slot ``i`` itself went."""
        st = self._slot_state[i]
        if not self._needs_tail_block(i):
            return True
        blk = int(self._lens[i]) // self.kv_block_tokens
        ids = self.kv_pool.alloc(1)
        while ids is None:
            victims = [(j, s) for j, s in enumerate(self._slot_state)
                       if s is not None and s.request.kind == "generate"]
            if not victims:
                # Only fork/scorelike rows are resident and the pool is
                # dry: the wedged row's request errors typed.
                self.metrics.record_oom_reject()
                self._finish_error(st.request, PoolExhausted(
                    "KV pool exhausted with no preemptible slot"))
                if st.fork_idx is not None or st.fork_wait:
                    self._teardown_fork(st.request)
                else:
                    self._free_slot_paged(i, st, adopt=False)
                    self._slot_state[i] = None
                return False
            j, _ = max(victims, key=lambda v: (v[1].request.priority, v[1].t_admit))
            self._preempt_slot(j)
            if j == i:
                return False
            ids = self.kv_pool.alloc(1)
        self._tables[i, blk] = ids[0]
        st.blocks.extend(ids)
        self._mark_tables_dirty()
        return True

    def _preempt_slot(self, i: int) -> None:
        """Evict slot ``i`` for its blocks and requeue its request at the
        front of its priority class. The complete blocks of its written
        K/V are adopted into the trie (a re-admission re-matches them) and
        its streamed tokens ride along in ``req.out_tokens``, so the resume
        prefill continues the sequence token-identically."""
        st = self._slot_state[i]
        req = st.request
        valid = int(self._lens[i])
        tokens = self._resident_tokens(req)
        self.kv_pool.adopt(tokens[:valid], st.blocks, st.first_block)
        self.kv_pool.release(st.match)
        st.blocks = []
        st.match = None
        st.prefill = None
        self._tables[i, :] = self._sentinel
        self._set_slot_mask(i, None)
        self._mark_tables_dirty()
        self._lens[i] = 0
        self._slot_state[i] = None
        self.metrics.record_preemption()
        req.preemptions += 1
        if req.trace is not None:
            req.trace.event("preempt", slot=i, resident_tokens=valid,
                            streamed=len(req.out_tokens))
        if self.flight_recorder is not None:
            self.flight_recorder.record_event("preempt", trace_id=req.trace_id, slot=i)
        self.scheduler.requeue(req)

    def _free_slot_paged(self, i: int, st: _SlotState, adopt: bool = True) -> None:
        """Slot teardown (paged; dense only resets the draft position):
        adopt the complete blocks of the slot's K/V into the trie, free the
        rest, and unpin the shared chain."""
        if self._spec:
            self._spec_pos[i] = 0
        if not self._paged:
            return
        self._set_slot_mask(i, None)
        req = st.request
        if st.fork_idx is not None or st.fork_wait:
            # Fork rows never adopt: their tail lives in fork_tokens, and
            # their shared prompt blocks are refcounted.
            adopt = False
        req.kv_blocks = max(req.kv_blocks, len(st.blocks))
        valid = int(self._lens[i])
        if adopt and valid:
            tokens = self._resident_tokens(req)
            self.kv_pool.adopt(tokens[:valid], st.blocks, st.first_block)
        else:
            self.kv_pool.free(st.blocks)
        self.kv_pool.release(st.match)
        st.blocks = []
        st.match = None
        self._tables[i, :] = self._sentinel
        self._mark_tables_dirty()
        self._lens[i] = 0

    def _stream_spec(self, st: _SlotState, row_out, commit: int, cap: int,
                     t: float) -> None:
        """Stream one slot's committed tokens from a speculative tick and
        book the accept accounting: drafts the row could have used are
        spec_k clamped by its remaining budget and its room, and every
        committed token is an accepted draft. The tokens of one tick share
        a timestamp."""
        req = st.request
        if req.temperature <= 0 and req.speculate:
            usable = min(self.spec_k, st.remaining, cap)
            if usable > 0:
                st.spec_drafted += usable
                st.spec_accepted += commit
                req.spec_drafted += usable
                req.spec_accepted += commit
                self.metrics.record_spec(usable, commit, trace_id=req.trace_id)
                if req.trace is not None:
                    req.trace.data["spec_drafted"] = st.spec_drafted
                    req.trace.data["spec_accepted"] = st.spec_accepted
        for j in range(commit):
            self._push_token(st, int(row_out[j]), t)

    def _push_token(self, st: _SlotState, tok: int, t: float,
                    first: bool = False) -> None:
        req = st.request
        if first:
            req.t_first_token = t
            self.metrics.record_first_token(t - req.t_submit,
                                            trace_id=req.trace_id)
            if req.trace is not None:
                req.trace.event("first_token",
                                ttft_s=round(t - req.t_submit, 9))
        else:
            self.metrics.record_inter_token(t - st.last_token_t,
                                            trace_id=req.trace_id)
            st.remaining -= 1
        st.last_token_t = t
        if st.dfa is not None:
            # Advance the automaton; a terminal state finishes the request.
            nxt_state = st.dfa.step(st.dfa_state, tok)
            if nxt_state is None:
                st.remaining = 0
            else:
                st.dfa_state = nxt_state
                if st.dfa.is_terminal(st.dfa_state):
                    st.remaining = 0
            self._set_slot_mask(self._slot_state.index(st), st)
        if st.fork_tokens is not None:
            # Fork rows keep a private stream; the done record carries all
            # n completions.
            st.fork_tokens.append(tok)
            return
        req.out_tokens.append(tok)
        req.events.put_nowait(("token", tok))

    def _finish_ok(self, req: Request) -> None:
        if req.t_done is not None:
            return  # a fork group's rows share one Request
        req.t_done = time.monotonic()
        self.scheduler.release_quota(req)
        self.metrics.record_finish(req.t_done - req.t_submit)
        done_tokens = (sum(len(c) for c in req.fork_completions)
                       if req.fork_completions is not None
                       else len(req.out_tokens))
        self.metrics.record_tenant_done(req.tenant, done_tokens)
        self._finalize_trace(req, "ok")
        done = {
            "tokens": done_tokens,
            "ttft_s": req.ttft,
            "latency_s": req.t_done - req.t_submit,
            "weight_version": req.weight_version,
            "tenant": req.tenant,
            "kind": req.kind,
        }
        if req.fork_completions is not None:
            done["completions"] = req.fork_completions
        if req.logprobs is not None:
            done["logprobs"] = req.logprobs
        if req.embedding is not None:
            done["embedding"] = req.embedding
        req.events.put_nowait(("done", done))
        req.done.set()

    def _finish_error(self, req: Request, err: ServingError) -> None:
        if req.t_done is not None:
            return
        req.error = err
        req.t_done = time.monotonic()
        # Quota credit on EVERY terminal path.
        self.scheduler.release_quota(req)
        self._finalize_trace(req, err.code, message=str(err))
        req.events.put_nowait(("error", err))
        req.done.set()

    def _finalize_trace(self, req: Request, status: str,
                        message: str | None = None) -> None:
        """Terminal bookkeeping for one request: SLO verdict, the
        wide-event append, and timeline finalization into the trace store
        and flight recorder."""
        latency = (req.t_done - req.t_submit
                   if req.t_done is not None and req.t_submit is not None
                   else None)
        slow = (self.slo_s is not None and latency is not None
                and latency > self.slo_s)
        if slow:
            self.metrics.record_slo_violation()
        if self.wide_events is not None:
            self._emit_wide_event(req, status, latency, slow)
        rec = req.trace
        if rec is None:
            return
        req.trace = None  # finalize exactly once
        if status == "ok":
            rec.event("done", tokens=len(req.out_tokens))
        else:
            rec.event("error", code=status,
                      message=(message or "")[:200] or None)
        d = rec.data
        d["status"] = status
        d["tenant"] = req.tenant
        d["tokens_out"] = len(req.out_tokens)
        d["prompt_tokens"] = len(req.prompt)
        if latency is not None:
            d["latency_s"] = round(latency, 9)
        if req.ttft is not None:
            d["ttft_s"] = round(req.ttft, 9)
        if "admit_iteration" in d:
            d["decode_iterations"] = (self.metrics.iterations
                                      - d.pop("admit_iteration"))
        if slow:
            d["slo_violation"] = True
        recd = rec.to_dict()
        if self.trace_store is not None:
            self.trace_store.put(recd)
        if self.flight_recorder is not None:
            self.flight_recorder.record_timeline(recd, slow=slow)

    def _emit_wide_event(self, req: Request, status: str,
                         latency: float | None, slow: bool) -> None:
        """Append the one canonical flat record for a finished request,
        with the reference's columns (those of later slices at their
        empty values)."""
        prov = req.weight_version or self.weight_version or {}
        forks = 0
        out_tokens = len(req.out_tokens)
        if req.fork_completions is not None:
            done_forks = [c for c in req.fork_completions if c is not None]
            forks = len(done_forks)
            out_tokens = sum(len(c) for c in done_forks)
        migration = ""
        kv_info = getattr(req, "kv_migration", None)
        if isinstance(kv_info, dict):
            migration = "fallback" if kv_info.get("fallback") else "imported"
        err_kind = ""
        if status != "ok":
            err_kind = (type(req.error).__name__
                        if req.error is not None else status)
        record = {
            "trace_id": req.trace_id,
            "t_done": time.time(),
            "tenant": req.tenant,
            "kind": req.kind,
            "priority": req.priority,
            "replica": self.trace_source,
            "role": self.serve_role,
            "mesh": "",
            "pp_depth": 1,
            "pp_stage": None,
            "weight_version": prov.get("version"),
            "weight_digest": prov.get("digest") or "",
            "prompt_tokens": len(req.prompt),
            "output_tokens": out_tokens,
            "max_new_tokens": req.max_new_tokens,
            "prefix_hit_tokens": req.prefix_hit_tokens,
            "kv_blocks": req.kv_blocks,
            "forks": forks,
            "n": req.n,
            "preemptions": req.preemptions,
            "migration": migration,
            "queue_wait_s": req.queue_wait_s,
            "prefill_device_s": (req.prefill_device_s
                                 if req.prefill_chunks else None),
            "prefill_chunks": req.prefill_chunks,
            "ttft_s": req.ttft,
            "latency_s": latency,
            "decode_iterations": (
                self.metrics.iterations - req.admit_iteration
                if req.admit_iteration is not None else None),
            "spec_drafted": req.spec_drafted,
            "spec_accepted": req.spec_accepted,
            "spec_accept_rate": (req.spec_accepted / req.spec_drafted
                                 if req.spec_drafted else None),
            "mask_uploads": req.mask_uploads,
            "constrained": int(req.constraint is not None),
            "cache_overtaken": int(req.cache_overtaken),
            "speculate": int(req.speculate),
            "temperature": req.temperature,
            "status": status,
            "error_kind": err_kind,
            "slo_verdict": "slow" if slow else "ok",
            "timeout_s": req.timeout,
            "stream": int(req.kind == "generate"),
        }
        self.wide_events.append(record)
