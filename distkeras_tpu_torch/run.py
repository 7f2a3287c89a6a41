"""CLI runner: ``python -m distkeras_tpu_torch.run --config job.json --data d.npz``.

Counterpart of the reference's ``distkeras_tpu/run.py`` with its subcommands
and flags: ``train`` (the default), ``serve``, ``cluster``, ``debugz``,
``queryz``, ``deploy``, ``deployz`` and ``statusz``.

The executable form of a ``TrainerConfig``: the config JSON carries the
trainer spec (see :mod:`distkeras_tpu_torch.utils.config`); data arrives as
an ``.npz`` with ``features``/``label`` arrays or a headered CSV; the model
comes from the built-in zoo by name.

Example config:
    {"trainer": "ADAG", "worker_optimizer": "adam", "learning_rate": 1e-3,
     "num_workers": 4, "batch_size": 64, "num_epoch": 2,
     "communication_window": 12}

Online serving (``python -m distkeras_tpu_torch.run serve --model gpt_small
--port 8500``) starts the continuous-batching TCP server
(:mod:`distkeras_tpu_torch.serving`) over a causal LM from the zoo;
``serve --replicas N`` (or the ``cluster`` subcommand) starts N replica
processes behind a supervised router with automatic restarts and
zero-downtime rolling weight reloads
(:mod:`distkeras_tpu_torch.serving.cluster`); ``deploy`` adds the
continuous-deployment controller (:mod:`distkeras_tpu_torch.deploy`).

Every command runs on the card: ``--device`` defaults to ``cuda``, and
without one the command fails unless ``--device cpu`` is given (replica
children inherit the flag). A serving mesh (``--mesh``, ``--mesh-shape``),
``--force-host-devices`` and ``--pipeline-depth`` above 1 are refused,
naming ROADMAP.md §A item A10.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

MODEL_ZOO = {
    "mnist_mlp": ("distkeras_tpu_torch.models.mlp", "mnist_mlp"),
    "higgs_mlp": ("distkeras_tpu_torch.models.mlp", "higgs_mlp"),
    "mnist_cnn": ("distkeras_tpu_torch.models.cnn", "mnist_cnn"),
    "cifar10_cnn": ("distkeras_tpu_torch.models.cnn", "cifar10_cnn"),
    "resnet18": ("distkeras_tpu_torch.models.resnet", "resnet18"),
    "resnet50": ("distkeras_tpu_torch.models.resnet", "resnet50"),
    "bert_tiny_mlm": ("distkeras_tpu_torch.models.bert", "bert_tiny_mlm"),
    "bert_base_mlm": ("distkeras_tpu_torch.models.bert", "bert_base_mlm"),
    "gpt_tiny": ("distkeras_tpu_torch.models.bert", "gpt_tiny"),
    "gpt_small": ("distkeras_tpu_torch.models.bert", "gpt_small"),
}


def load_model(name: str, kwargs: dict):
    import importlib

    if name not in MODEL_ZOO:
        raise SystemExit(f"unknown model {name!r}; known: {sorted(MODEL_ZOO)}")
    mod, fn = MODEL_ZOO[name]
    return getattr(importlib.import_module(mod), fn)(**kwargs)


def load_data(path: str, features_col: str, label_col: str):
    from distkeras_tpu_torch.data.dataset import Dataset

    if path.endswith(".npz"):
        with np.load(path) as d:
            return Dataset.from_arrays(
                **{features_col: d["features"], label_col: d["label"]}
            )
    header = open(path).readline().strip().split(",")
    return Dataset.from_csv(
        path, features=[c for c in header if c != label_col], label=label_col,
        features_col=features_col, label_col=label_col,
    )


_A10 = "the multi-device slice (ROADMAP.md §A item A10)"


def _refuse_multi_device(args) -> None:
    """The mesh flags and ``--pipeline-depth`` above 1 need more than one
    device: a typed CLI error naming their ROADMAP item, before anything
    is built."""
    if getattr(args, "force_host_devices", None):
        raise SystemExit(f"--force-host-devices is not ported yet: it comes with {_A10}")
    if getattr(args, "mesh", False) or getattr(args, "mesh_shape", None):
        raise SystemExit(f"--mesh/--mesh-shape (sharded serving) is not ported yet: it "
                         f"comes with {_A10}")
    depth = getattr(args, "pipeline_depth", None)
    if depth is not None and depth > 1:
        raise SystemExit(f"--pipeline-depth {depth} needs a pp serving mesh, which is "
                         f"not ported yet: it comes with {_A10}")


def _resolve_device(name: str):
    """``--device`` as a torch device: ``cuda`` (the default) fails
    without a card; the CPU only when named."""
    from distkeras_tpu_torch.utils.device import resolve_device

    try:
        return resolve_device(name)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--device {name}: {e}") from None


def _load_params(path: str, device):
    """A weight file of either package as the port's flat ``state_dict``
    on ``device``, with its provenance stamp."""
    from distkeras_tpu_torch.checkpoint import load_weights_file_with_provenance
    from distkeras_tpu_torch.utils.bridge import params_from_jax

    tree, provenance = load_weights_file_with_provenance(path)
    return params_from_jax(tree, device=device), provenance


def _add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: 'cuda' (default; fails "
                         "without a card) or 'cpu', which must be asked "
                         "for by name")


def serve_main(argv=None, prog="serve", default_replicas=1) -> int:
    """``serve`` subcommand: continuous-batching TCP server over a causal
    LM from the zoo (random-init demo weights unless --weights given).
    ``--replicas N`` (or the ``cluster`` subcommand) instead starts N
    replica processes behind a supervised router on ``--port``."""
    ap = argparse.ArgumentParser(prog=f"distkeras_tpu_torch.run {prog}")
    _add_device_flag(ap)
    ap.add_argument("--model", default="gpt_tiny",
                    help="causal LM from the zoo (gpt_tiny/gpt_small)")
    ap.add_argument("--model-args", default="{}",
                    help="JSON kwargs for the model fn")
    ap.add_argument("--weights", default=None,
                    help="serialized-pytree weights (save_weights output); "
                         "random init when omitted")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500, help="0 = ephemeral")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (concurrent requests)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission queue depth before queue_full rejects")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split prompt prefill into chunks of this many "
                         "tokens, one per decode tick — bounds the decode "
                         "stall (p99 ITL) a long prompt can cause; "
                         "default: monolithic prefill")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="decode pipeline depth: 1 (default) dispatches "
                         "tick N+1 before consuming tick N's tokens, so "
                         "host bookkeeping (streaming, admission, socket "
                         "reads) overlaps device compute; >=2 on a pp "
                         "mesh micro-batches the slots to keep every "
                         "stage busy (depth>=pp hides stage bubbles); "
                         "0 serializes "
                         "dispatch and harvest (the pre-pipeline "
                         "behavior). Greedy output is token-identical "
                         "either way — see docs/serving.md 'Decode "
                         "pipeline'")
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="> 0 enables the device-resident prompt prefix "
                         "cache under this byte budget: shared prefixes "
                         "(system prompts, templates) splice cached KV "
                         "blocks instead of recomputing prefill")
    ap.add_argument("--prefix-block", type=int, default=16,
                    help="prefix-cache block granularity in tokens")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV: decode slots allocate fixed-size "
                         "blocks from ONE shared pool (which doubles as "
                         "the prefix cache) via per-slot block tables — "
                         "capacity scales with resident tokens, the pool "
                         "may be oversubscribed (preempt-and-requeue), "
                         "and long-context requests chain blocks up to "
                         "the trained context")
    ap.add_argument("--constrained", action="store_true",
                    help="constrained decoding: compile the decode step "
                         "with a per-slot additive token-mask input so "
                         "requests may carry a 'constraint' automaton "
                         "(docs/serving.md 'Request kinds'). Requires "
                         "--paged/--kv-pool-mb; without this flag such "
                         "requests are rejected as bad_request")
    ap.add_argument("--kv-pool-mb", type=float, default=0.0,
                    help="paged-KV pool byte budget (MB); > 0 implies "
                         "--paged. See docs/serving.md 'KV pool sizing'")
    ap.add_argument("--kv-block-tokens", type=int, default=16,
                    help="paged-KV block granularity in tokens")
    ap.add_argument("--kv-host-tier-mb", type=float, default=0.0,
                    help="tiered KV cache: host-RAM spill tier byte "
                         "budget (MB). > 0: unreferenced hot blocks "
                         "evicted from the device pool spill to host "
                         "RAM (exact serialized KV bytes) and re-admit "
                         "on the next prefix hit instead of "
                         "re-prefilling. Requires --paged/--kv-pool-mb. "
                         "See docs/serving.md 'Tiered KV cache'")
    ap.add_argument("--kv-disk-tier-dir", default=None, metavar="DIR",
                    help="tiered KV cache: optional disk tier under the "
                         "host tier — host-tier evictions demote to "
                         "files in DIR instead of being dropped")
    ap.add_argument("--kv-disk-tier-mb", type=float, default=0.0,
                    help="disk tier byte budget (MB); must be > 0 for "
                         "the disk tier to hold anything")
    ap.add_argument("--kv-tier-watermark", type=float, default=0.8,
                    help="tier eviction low-watermark: an over-budget "
                         "tier evicts LRU entries down to this fraction "
                         "of its budget (batched eviction, not "
                         "per-put thrash)")
    ap.add_argument("--max-context", type=int, default=None,
                    help="cap per-request context below the trained "
                         "length; in dense mode also shrinks the "
                         "pre-reserved per-slot KV cache to this many "
                         "positions")
    ap.add_argument("--draft-model", default=None,
                    help="speculative decoding: a small causal LM from "
                         "the zoo drafts --spec-k tokens per tick and "
                         "ONE batched target call verifies them — "
                         "greedy output stays token-identical (exactly "
                         "with draft==target; a different draft can "
                         "differ only where the target scores two "
                         "tokens as numerically tied at its own "
                         "compute precision — see docs/serving.md "
                         "'Speculative decoding') while decode "
                         "throughput rises with the accept rate. Same "
                         "model+args as --model shares the target's "
                         "weights (the accept-rate sanity config); "
                         "otherwise the draft runs its own seed-init "
                         "weights unless --draft-weights")
    ap.add_argument("--draft-args", default="{}",
                    help="JSON kwargs for the draft model fn")
    ap.add_argument("--draft-weights", default=None,
                    help="serialized-pytree weights for the draft model")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative tick")
    ap.add_argument("--mesh", action="store_true",
                    help="sharded serving over a device mesh: refused, "
                         "it comes with ROADMAP.md §A item A10")
    ap.add_argument("--mesh-shape", default=None, metavar="AXIS=N[,..]",
                    help="explicit serving mesh shape: refused (A10)")
    ap.add_argument("--force-host-devices", type=int, default=None,
                    metavar="N", help="virtual host devices: refused (A10)")
    ap.add_argument("--wire", default="auto",
                    choices=["auto", "bin1", "jsonl"],
                    help="front-door protocol policy: 'auto'/'bin1' "
                         "serve JSONL as always AND accept the "
                         "length-prefixed bin1 upgrade from clients "
                         "that offer it (cluster mode also negotiates "
                         "bin1 to each replica); 'jsonl' pins "
                         "everything to the original protocol — the "
                         "rollback knob")
    ap.add_argument("--tenant-quota", action="append", default=None,
                    metavar="TENANT=TOK_S",
                    help="repeatable; per-tenant token-rate quota in "
                         "tokens/second — an over-quota tenant gets a "
                         "typed tenant_over_quota reject at submit, "
                         "never a mid-stream kill")
    ap.add_argument("--tenant-weight", action="append", default=None,
                    metavar="TENANT=W",
                    help="repeatable; per-tenant weighted-fair-queueing "
                         "weight (default 1.0) — within a priority "
                         "class, a weight-2 tenant is offered twice "
                         "the token bandwidth under contention")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=default_replicas,
                    help="> 1: start this many replica processes behind a "
                         "supervised router on --port (least-outstanding "
                         "routing with prefix-cache affinity, automatic "
                         "restarts, rolling weight reloads)")
    ap.add_argument("--roles", default=None, metavar="prefill=N,decode=M",
                    help="disaggregated cluster: N prefill replicas + M "
                         "decode replicas (implies cluster mode, "
                         "overrides --replicas; requires --paged/"
                         "--kv-pool-mb). The router prefills each "
                         "prompt family ONCE on its prefill replica "
                         "and decode replicas adopt the KV blocks over "
                         "the wire (KVBLK frames) — chunked prefill "
                         "stops stealing decode ticks, hot prefixes "
                         "are prefilled once per FLEET, and every "
                         "transfer failure falls back to monolithic "
                         "serving. See docs/serving.md 'Disaggregated "
                         "serving'")
    ap.add_argument("--kv-push", action="store_true",
                    help="disaggregated cluster (--roles): the router "
                         "push-schedules prefill→decode KV transfers — "
                         "right after each prefill handoff it tells the "
                         "prefill replica to PUSH the blocks at the "
                         "picked decode replica while that replica "
                         "works on earlier requests, replacing the "
                         "adopt-time pull; the fleet cache directory "
                         "skips the transfer entirely when the decode "
                         "replica already holds the prefix family. "
                         "Every miss falls back to pull, then "
                         "monolithic — counted, never a client error")
    ap.add_argument("--affinity-slack", type=int, default=4,
                    help="cluster mode: max outstanding-request imbalance "
                         "the prefix-affinity pin may create before plain "
                         "least-outstanding routing wins")
    ap.add_argument("--replica-env", action="append", default=[],
                    metavar="KEY=VAL",
                    help="cluster mode, repeatable: extra env var for each "
                         "replica child; '{i}' expands to the replica "
                         "index — the device-partitioning hook (e.g. "
                         "CUDA_VISIBLE_DEVICES={i} so N replicas on one "
                         "accelerator host each claim one chip instead of "
                         "all of them)")
    ap.add_argument("--metrics-out", default=None,
                    help="JSONL per-iteration serving metrics")
    ap.add_argument("--trace-out", default=None,
                    help="enable spans; write Chrome-trace JSON (Perfetto-"
                         "loadable) here on shutdown")
    ap.add_argument("--audit-recompiles", nargs="?", const="report",
                    choices=["report", "arm"], default=None,
                    help="count compiles per jitted program (report at "
                         "exit); 'arm' additionally fails loudly if the "
                         "decode step ever recompiles after its first "
                         "iteration")
    ap.add_argument("--request-trace", type=int, default=None, metavar="N",
                    help="> 0: keep the last N per-request timeline "
                         "records queryable via the tracez verb / "
                         "`run.py debugz --trace ID`. Default: off for "
                         "serve, 512 for cluster mode; 0 disables "
                         "explicitly")
    ap.add_argument("--request-trace-out", default=None,
                    help="write the request-timeline store as Chrome-"
                         "trace JSON (one lane per request) on shutdown; "
                         "implies --request-trace")
    ap.add_argument("--wide-events", type=int, default=4096, metavar="N",
                    help="per-request wide-event ring capacity (one flat "
                         "~40-column record per finished request, "
                         "queryable via the queryz verb / `run.py "
                         "queryz`); 0 disables")
    ap.add_argument("--flight-recorder", type=int, default=None,
                    metavar="N",
                    help="> 0: arm the flight recorder with an N-event "
                         "black box of recent engine state + request "
                         "timelines. Default: off for serve (unless "
                         "--flight-dump is given), 256 for cluster "
                         "mode; 0 disables explicitly")
    ap.add_argument("--flight-dump", default=None,
                    help="where the flight recorder dumps on crash/exit "
                         "(the replica's 'last words' file the cluster "
                         "supervisor collects); implies --flight-recorder")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="request-latency SLO in ms: slower requests bump "
                         "serving_slo_violations_total and pin their full "
                         "timeline as a flight-recorder slow exemplar")
    ap.add_argument("--profile-out", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the whole "
                         "serve into this directory — the device-timeline "
                         "complement to the host spans --trace-out writes")
    ap.add_argument("--flight-dir", default=None,
                    help="cluster mode: directory for per-replica flight-"
                         "recorder dumps (default: a fresh temp dir, "
                         "printed in the banner); each replica child gets "
                         "--flight-dump <dir>/flight-r<i>.json and the "
                         "supervisor collects a dead replica's file into "
                         "its restart log")
    args = ap.parse_args(argv)
    _refuse_multi_device(args)
    if args.replicas > 1 or args.roles:
        return cluster_main(args)

    import asyncio

    from distkeras_tpu_torch.serving import (
        ServingEngine, ServingMetrics, ServingServer,
    )
    from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
    from distkeras_tpu_torch.telemetry.registry import MetricsRegistry
    from distkeras_tpu_torch.telemetry.spans import enable_tracing
    from distkeras_tpu_torch.tracing import MetricStream

    device = _resolve_device(args.device)
    tracer = enable_tracing() if args.trace_out else None
    model = load_model(args.model, json.loads(args.model_args))
    weight_version = None
    if args.weights:
        variables, weight_version = _load_params(args.weights, device)
    else:
        variables = model.init(args.seed, device=device)
    # One registry behind everything this process publishes — serving
    # metrics, the scheduler, the stream's last-value gauges, the auditor
    # — so a metricsz scrape shows the whole picture.
    registry = MetricsRegistry()
    metrics = ServingMetrics(
        MetricStream.to_jsonl(args.metrics_out, registry=registry)
        if args.metrics_out else None,
        registry=registry)
    auditor = (RecompileAuditor(registry=registry)
               if args.audit_recompiles else None)
    from distkeras_tpu_torch.telemetry.flight_recorder import FlightRecorder
    from distkeras_tpu_torch.telemetry.request_trace import TailRetention, TraceStore

    # None = unset (flag defaults apply); an EXPLICIT 0 always disables.
    trace_cap = args.request_trace
    if trace_cap is None and args.request_trace_out:
        trace_cap = 512
    # Tail-based retention rides every armed trace store: errors, SLO
    # breaches, per-kind latency tails, rare tenants, and a 1/N
    # baseline survive the sliding window in a keeper reservoir.
    trace_store = (TraceStore(trace_cap, retention=TailRetention())
                   if trace_cap else None)
    recorder_cap = args.flight_recorder
    if recorder_cap is None and args.flight_dump:
        recorder_cap = 256
    recorder = None
    if recorder_cap:
        recorder = FlightRecorder(
            capacity=recorder_cap,
            dump_path=args.flight_dump,
            source=f"serve:{args.model}:pid{os.getpid()}")
    # --paged with no explicit budget gets a sane default pool; an
    # explicit --kv-pool-mb implies --paged.
    kv_pool_mb = args.kv_pool_mb or (64.0 if args.paged else 0.0)
    if args.kv_host_tier_mb and not kv_pool_mb:
        raise SystemExit("--kv-host-tier-mb requires --paged or "
                         "--kv-pool-mb: the host tier spills paged-KV "
                         "blocks")
    if args.constrained and not kv_pool_mb:
        raise SystemExit("--constrained requires --paged or "
                         "--kv-pool-mb: the token-mask decode step "
                         "runs on the paged pool")
    draft_model = draft_variables = None
    if args.draft_model:
        draft_kwargs = json.loads(args.draft_args)
        if "vocab_size" not in draft_kwargs:
            # Draft proposals are TARGET token ids, so the draft must
            # share the target's vocab — default it so the documented
            # zoo pairing (`--model gpt_small --draft-model gpt_tiny`)
            # works without hand-passing 50257 through --draft-args.
            try:
                draft_model = load_model(
                    args.draft_model,
                    {**draft_kwargs, "vocab_size": model.output_dim})
            except TypeError:  # model fn without a vocab_size kwarg
                draft_model = None
        if draft_model is None:
            draft_model = load_model(args.draft_model, draft_kwargs)
        if (args.draft_model == args.model
                and json.loads(args.draft_args) == json.loads(
                    args.model_args)
                and not args.draft_weights):
            # Identical spec with no weights of its own: the draft IS
            # the target (the draft==target sanity config — acceptance
            # ~100%, the speedup is pure dispatch amortization).
            draft_variables = variables
        else:
            if args.draft_weights:
                draft_variables, _ = _load_params(args.draft_weights, device)
            else:
                draft_variables = draft_model.init(args.seed, device=device)
    engine = ServingEngine(
        model, variables, slots=args.slots, max_queue=args.max_queue,
        top_k=args.top_k, metrics=metrics, seed=args.seed,
        auditor=auditor,
        arm_auditor_after_warmup=args.audit_recompiles == "arm",
        prefill_chunk=args.prefill_chunk,
        prefix_cache_mb=0.0 if kv_pool_mb else args.prefix_cache_mb,
        prefix_block_tokens=args.prefix_block,
        kv_pool_mb=kv_pool_mb,
        kv_block_tokens=args.kv_block_tokens,
        kv_host_tier_mb=args.kv_host_tier_mb,
        kv_disk_tier_dir=args.kv_disk_tier_dir,
        kv_disk_tier_mb=args.kv_disk_tier_mb,
        kv_tier_watermark=args.kv_tier_watermark,
        constrained=args.constrained,
        max_context=args.max_context,
        draft_model=draft_model, draft_variables=draft_variables,
        spec_k=args.spec_k,
        pipeline_depth=args.pipeline_depth,
        trace_store=trace_store, flight_recorder=recorder,
        wide_events=args.wide_events,
        slo_s=args.slo_ms / 1e3 if args.slo_ms else None,
        weight_version=weight_version,
        tenant_quotas=_parse_tenant_rates(args.tenant_quota,
                                          "--tenant-quota"),
        tenant_weights=_parse_tenant_rates(args.tenant_weight,
                                           "--tenant-weight"),
        device=device)
    server = ServingServer(
        engine, host=args.host, port=args.port,
        wire_mode="jsonl" if args.wire == "jsonl" else "auto")

    async def go():
        import signal

        await server.start()
        print(json.dumps({
            "serving": args.model, "host": args.host, "port": server.port,
            "slots": args.slots, "max_queue": args.max_queue,
            "prefill_chunk": args.prefill_chunk,
            "prefix_cache_mb": args.prefix_cache_mb,
            "kv_pool_mb": kv_pool_mb,
            "kv_pool_blocks": (engine.kv_pool.capacity
                               if engine.kv_pool is not None else 0),
            "draft_model": args.draft_model,
            "spec_k": args.spec_k if args.draft_model else 0,
            "mesh": None,
            "device": str(device),
        }), flush=True)
        # Signal-driven shutdown INSIDE the loop: a raw KeyboardInterrupt
        # out of asyncio.run would cancel the engine task before the
        # drain, skipping the graceful stop and the summary line.
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # non-unix
                pass
        await stop.wait()
        await server.stop(drain=True)
        summary = {k: round(v, 6) for k, v in metrics.summary().items()}
        if engine.prefix_cache is not None:
            summary["prefix_cache"] = engine.prefix_cache.stats()
        if engine.kv_pool is not None:
            summary["kv_pool"] = engine.kv_pool.stats()
        if auditor is not None:
            summary["recompile_audit"] = auditor.report()
        print(json.dumps(summary), flush=True)

    import contextlib

    from distkeras_tpu_torch.telemetry.device import profile_trace

    profiler = (profile_trace(args.profile_out) if args.profile_out
                else contextlib.nullcontext())
    try:
        with profiler:
            asyncio.run(go())
    except KeyboardInterrupt:
        pass
    finally:
        if metrics.stream is not None:
            metrics.stream.close()
        if tracer is not None:
            tracer.export_chrome_trace(args.trace_out)
            print(json.dumps({"trace_out": args.trace_out}), flush=True)
        # Graceful-exit black box: the crash path already dumped inside
        # the engine loop; this covers SIGTERM drains so the file exists
        # either way.
        if recorder is not None and recorder.dump_path:
            try:
                recorder.dump()
            except OSError:
                pass
        if trace_store is not None and args.request_trace_out:
            trace_store.export_chrome_trace(args.request_trace_out)
            print(json.dumps(
                {"request_trace_out": args.request_trace_out}), flush=True)
    return 0


def _parse_tenant_rates(items, flag: str) -> dict | None:
    """Repeated ``TENANT=VALUE`` CLI items into a dict (None when the
    flag was never given). Bad input is a typed CLI error, never a deep
    float() traceback out of the engine ctor."""
    if not items:
        return None
    out = {}
    for item in items:
        name, sep, value = str(item).partition("=")
        if not sep or not name:
            raise SystemExit(f"{flag} needs TENANT=VALUE, got {item!r}")
        try:
            out[name] = float(value)
        except ValueError:
            raise SystemExit(
                f"{flag}: bad numeric value in {item!r}") from None
    return out


def _serving_config_flags(args) -> list[str]:
    """Serving-engine configuration flags a parent process forwards to
    every replica child — ONE helper shared by ``cluster`` and
    ``deploy``, so the whole fleet (and, in deploy's case, the canary
    replica, which is a drained member of that same fleet) runs the
    configuration the operator asked for. Before deploy used this, its
    canary always validated candidates on the dense one-token default —
    a paged or speculative production config shipped unvetted."""
    extra = [
        "--prefix-cache-mb", str(args.prefix_cache_mb),
        "--prefix-block", str(args.prefix_block),
    ]
    if args.top_k is not None:
        extra += ["--top-k", str(args.top_k)]
    if args.prefill_chunk is not None:
        extra += ["--prefill-chunk", str(args.prefill_chunk)]
    if getattr(args, "pipeline_depth", None) is not None:
        extra += ["--pipeline-depth", str(args.pipeline_depth)]
    if args.paged or args.kv_pool_mb:
        if args.paged:
            extra += ["--paged"]
        extra += ["--kv-pool-mb", str(args.kv_pool_mb),
                  "--kv-block-tokens", str(args.kv_block_tokens)]
        if getattr(args, "kv_host_tier_mb", 0.0):
            extra += ["--kv-host-tier-mb", str(args.kv_host_tier_mb),
                      "--kv-tier-watermark", str(args.kv_tier_watermark)]
            if getattr(args, "kv_disk_tier_dir", None):
                # One shared dir is safe: spill file names carry the
                # replica pid.
                extra += ["--kv-disk-tier-dir", args.kv_disk_tier_dir,
                          "--kv-disk-tier-mb", str(args.kv_disk_tier_mb)]
        if getattr(args, "constrained", False):
            extra += ["--constrained"]
    if args.max_context is not None:
        extra += ["--max-context", str(args.max_context)]
    if args.draft_model:
        extra += ["--draft-model", args.draft_model,
                  "--draft-args", args.draft_args,
                  "--spec-k", str(args.spec_k)]
        if args.draft_weights:
            extra += ["--draft-weights", args.draft_weights]
    # Every replica child runs on the device its parent was asked for:
    # a cluster started with --device cpu never puts a child on a card,
    # and one started on the card never falls back to the CPU.
    extra += ["--device", str(getattr(args, "device", "cuda"))]
    # Front-door wire policy + multi-tenant QoS ride to every replica
    # (and therefore through deploy's canary), so the production wire
    # configuration is exactly what gets validated.
    if getattr(args, "wire", None):
        extra += ["--wire", args.wire]
    for item in getattr(args, "tenant_quota", None) or []:
        extra += ["--tenant-quota", str(item)]
    for item in getattr(args, "tenant_weight", None) or []:
        extra += ["--tenant-weight", str(item)]
    if getattr(args, "wide_events", None) is not None:
        extra += ["--wide-events", str(args.wide_events)]
    return extra


def _parse_roles(spec: str | None) -> list[str] | None:
    """``--roles prefill=N,decode=M`` via the ONE shared parser
    (``serving.cluster.parse_roles``); bad input is a typed CLI exit,
    never a deep traceback out of the supervisor."""
    from distkeras_tpu_torch.serving.cluster import parse_roles

    try:
        return parse_roles(spec)
    except ValueError as e:
        raise SystemExit(f"--roles: {e}") from None


def cluster_main(args) -> int:
    """Multi-replica serving: N child processes (each a full ``serve``
    on an ephemeral port) behind a supervised router on ``--port``.
    Replica death -> capped-backoff restart; ``{"cmd": "reload",
    "weights": path}`` on the router rolls new weights with zero
    downtime. ``--roles prefill=N,decode=M`` splits the fleet into
    prefill and decode roles with KV block migration between them.
    See docs/operations.md for the runbook."""
    import asyncio
    import signal
    import tempfile

    # Typed validation in the PARENT: a refused flag or a missing card
    # fails the cluster command with one clear line, not N crash-looping
    # replica children.
    _refuse_multi_device(args)
    _resolve_device(args.device)
    roles = _parse_roles(getattr(args, "roles", None))
    if roles is not None:
        if not (args.paged or args.kv_pool_mb):
            raise SystemExit(
                "--roles requires --paged or --kv-pool-mb: KV block "
                "migration (the prefill->decode handoff) only exists "
                "on the paged pool")
        args.replicas = len(roles)
    if getattr(args, "kv_push", False) and roles is None:
        raise SystemExit("--kv-push requires --roles: push scheduling "
                         "rides the prefill->decode handoff")

    from distkeras_tpu_torch.serving.cluster import ProcessReplica, ServingCluster
    from distkeras_tpu_torch.telemetry.registry import MetricsRegistry

    # Observability defaults are ON in cluster mode: per-request tracing
    # and flight recording cost per-REQUEST bookkeeping only (the
    # per-token path is untouched), and a fleet without them cannot
    # answer "where did this request go" — the reason the cluster
    # subcommand exists is operating at that scale.
    flight_dir = args.flight_dir or tempfile.mkdtemp(
        prefix="distkeras-flight-")
    os.makedirs(flight_dir, exist_ok=True)

    def flight_dump(i: int) -> str:
        return os.path.join(flight_dir, f"flight-r{i}.json")

    def replica_args(i: int) -> list[str]:
        extra = [
            "--model", args.model, "--model-args", args.model_args,
            "--slots", str(args.slots),
            "--max-queue", str(args.max_queue),
            "--seed", str(args.seed),
            *_serving_config_flags(args),
            "--request-trace",
            str(512 if args.request_trace is None else args.request_trace),
            "--flight-recorder",
            str(256 if args.flight_recorder is None else args.flight_recorder),
            "--flight-dump", flight_dump(i),
        ]
        if args.weights:
            extra += ["--weights", args.weights]
        if args.audit_recompiles:
            extra += ["--audit-recompiles", args.audit_recompiles]
        if args.slo_ms is not None:
            extra += ["--slo-ms", str(args.slo_ms)]
        if args.metrics_out:
            extra += ["--metrics-out", f"{args.metrics_out}.r{i}"]
        if args.trace_out:
            extra += ["--trace-out", f"{args.trace_out}.r{i}"]
        if args.profile_out:
            # Each replica is its own process: per-replica profiler dirs.
            extra += ["--profile-out",
                      os.path.join(args.profile_out, f"r{i}")]
        return extra

    def replica_env(i: int) -> dict[str, str]:
        env = {}
        for item in args.replica_env:
            key, sep, val = item.partition("=")
            if not sep:
                raise SystemExit(f"--replica-env needs KEY=VAL, got {item!r}")
            env[key] = val.replace("{i}", str(i))
        return env

    from distkeras_tpu_torch.telemetry.spans import enable_tracing

    # Parent-side spans cover the router hop (route / rolling_reload);
    # each replica writes its own engine timeline to {trace_out}.r{i}.
    tracer = enable_tracing() if args.trace_out else None
    registry = MetricsRegistry()
    cluster = ServingCluster(
        lambda i: ProcessReplica(replica_args(i), host=args.host,
                                 env=replica_env(i),
                                 last_words_path=flight_dump(i)),
        args.replicas, host=args.host, port=args.port, registry=registry,
        roles=roles,
        router_kwargs={
            "affinity_tokens": args.prefix_block,
            "affinity_slack": args.affinity_slack,
            "wire_mode": "jsonl" if args.wire == "jsonl" else "auto",
            "trace_capacity":
                512 if args.request_trace is None else args.request_trace,
            # Handoff threshold tracks the KV BLOCK size, not the
            # affinity prefix: a prompt shorter than one block exports
            # nothing, so handing it off would pay two prefills + two
            # round trips for a guaranteed peer_miss.
            **({"min_handoff_tokens": args.kv_block_tokens}
               if roles is not None else {}),
            **({"kv_push": True} if getattr(args, "kv_push", False)
               else {}),
        })

    async def go():
        await cluster.start()
        print(json.dumps({
            "cluster": args.model, "host": args.host, "port": cluster.port,
            "replicas": {rid: {"host": info.host, "port": info.port,
                               "role": info.role}
                         for rid, info in cluster.replicas.items()},
            "slots": args.slots, "prefix_cache_mb": args.prefix_cache_mb,
            "flight_dir": flight_dir,
        }), flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # non-unix
                pass
        try:
            await stop.wait()
        finally:
            # Even when the wait is cancelled (KeyboardInterrupt on
            # platforms without signal handlers), the replica children
            # must be reaped — they are real processes, not tasks.
            await cluster.stop()
        print(json.dumps({
            "restarts": {rid: info.restarts
                         for rid, info in cluster.replicas.items()},
            "restart_log": cluster.supervisor.restart_log_entries(),
            "router": registry.snapshot(),
        }), flush=True)

    try:
        asyncio.run(go())
    except KeyboardInterrupt:
        pass
    finally:
        if tracer is not None:
            tracer.export_chrome_trace(args.trace_out)
            print(json.dumps({"trace_out": args.trace_out}), flush=True)
    return 0


def deploy_main(argv=None) -> int:
    """``deploy`` subcommand: the continuous-deployment loop — a
    ProcessReplica serving fleet behind the supervised router, plus a
    :class:`~distkeras_tpu_torch.deploy.controller.DeployController` watching
    a publish directory. Every version a trainer publishes there
    (``run.py train --publish-dir``) is validated, canaried on one
    drained replica against a golden prompt set, rolled through the
    fleet with zero downtime, and rolled back + quarantined if anything
    regresses. Inspect live state with ``run.py deployz``."""
    ap = argparse.ArgumentParser(prog="distkeras_tpu_torch.run deploy")
    _add_device_flag(ap)
    ap.add_argument("--watch-dir", required=True, metavar="DIR",
                    help="publish directory to watch (the trainer's "
                         "--publish-dir). With no manifest yet, the "
                         "fleet bootstraps on (and publishes) seed-init "
                         "weights as v1")
    ap.add_argument("--model", default="gpt_tiny",
                    help="causal LM from the zoo (gpt_tiny/gpt_small)")
    ap.add_argument("--model-args", default="{}",
                    help="JSON kwargs for the model fn")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500,
                    help="router front port (0 = ephemeral)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    # The fleet's REAL serving configuration, forwarded to every
    # replica (the canary is a drained member of this same fleet, so a
    # candidate is validated under the configuration production
    # actually runs — paged KV, chunked prefill, speculation and all —
    # not the dense one-token default).
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="replica chunked-prefill size (tokens)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="replica decode pipeline depth (1 overlaps host "
                         "bookkeeping with device compute; >=2 "
                         "micro-batches a pp mesh; 0 serializes)")
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="replica prefix-cache byte budget (MB)")
    ap.add_argument("--prefix-block", type=int, default=16,
                    help="prefix-cache block granularity (tokens)")
    ap.add_argument("--paged", action="store_true",
                    help="replicas serve with paged KV")
    ap.add_argument("--kv-pool-mb", type=float, default=0.0,
                    help="replica paged-KV pool budget (MB); > 0 "
                         "implies --paged")
    ap.add_argument("--kv-block-tokens", type=int, default=16)
    ap.add_argument("--max-context", type=int, default=None)
    ap.add_argument("--draft-model", default=None,
                    help="replicas serve with speculative decoding "
                         "(this zoo model drafts --spec-k tokens/tick)")
    ap.add_argument("--draft-args", default="{}")
    ap.add_argument("--draft-weights", default=None)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--mesh", action="store_true",
                    help="sharded replicas: refused, it comes with "
                         "ROADMAP.md §A item A10")
    ap.add_argument("--mesh-shape", default=None, metavar="AXIS=N[,..]",
                    help="per-replica serving mesh shape: refused (A10)")
    ap.add_argument("--force-host-devices", type=int, default=None,
                    metavar="N", help="virtual host devices: refused (A10)")
    ap.add_argument("--golden", type=int, default=4,
                    help="golden prompt count the canary replica must "
                         "serve (twice each, identical greedy output, "
                         "within the latency budget); 0 disables "
                         "replica-side scoring")
    ap.add_argument("--golden-len", type=int, default=8,
                    help="golden prompt length in tokens")
    ap.add_argument("--golden-new-tokens", type=int, default=4,
                    help="tokens decoded per golden prompt")
    ap.add_argument("--canary-latency-ms", type=float, default=30000.0,
                    help="per-golden-prompt canary latency budget")
    ap.add_argument("--poll-ms", type=float, default=500.0,
                    help="manifest poll interval")
    ap.add_argument("--publish-keep", type=int, default=5,
                    help="retention for the bootstrap publish")
    ap.add_argument("--audit-recompiles", nargs="?", const="arm",
                    choices=["report", "arm", "off"], default="arm",
                    help="replica recompile auditing (default: arm — a "
                         "decode retrace under weight churn fails "
                         "loudly; 'off' disables)")
    ap.add_argument("--replica-env", action="append", default=[],
                    metavar="KEY=VAL",
                    help="repeatable; extra env per replica child, {i} "
                         "expands to the index (device partitioning)")
    ap.add_argument("--wire", default="auto",
                    choices=["auto", "bin1", "jsonl"],
                    help="front-door protocol policy, forwarded to every "
                         "replica AND applied to the deploy router — the "
                         "canary validates candidates under the "
                         "production wire configuration")
    ap.add_argument("--tenant-quota", action="append", default=None,
                    metavar="TENANT=TOK_S",
                    help="repeatable; per-tenant token-rate quotas, "
                         "forwarded to every replica")
    ap.add_argument("--tenant-weight", action="append", default=None,
                    metavar="TENANT=W",
                    help="repeatable; per-tenant fair-queueing weights, "
                         "forwarded to every replica")
    ap.add_argument("--tenant", default="canary",
                    help="client-side tenant id the canary's golden "
                         "requests run under — keep it OUT of the "
                         "production quota set (a quota-shed canary "
                         "would fail every deploy) and it makes canary "
                         "traffic attributable in every tenant metric")
    args = ap.parse_args(argv)
    _refuse_multi_device(args)
    device = _resolve_device(args.device)

    import asyncio
    import signal

    from distkeras_tpu_torch.checkpoint import publish_weights, read_manifest
    from distkeras_tpu_torch.deploy.harness import wire_controller
    from distkeras_tpu_torch.serving.cluster import ProcessReplica, ServingCluster
    from distkeras_tpu_torch.telemetry.registry import MetricsRegistry
    from distkeras_tpu_torch.utils.bridge import params_to_jax

    model = load_model(args.model, json.loads(args.model_args))
    manifest = read_manifest(args.watch_dir)
    if manifest is None or not os.path.exists(manifest.get("path") or ""):
        # Nothing (usable) published yet: bootstrap the directory with
        # seed-init weights so the fleet boots on a FILE (the
        # controller's last-good rollback target must exist from the
        # first deploy). The exists-check also covers a restart whose
        # manifest still names a file the controller quarantined or the
        # publisher pruned — a fresh publish beats a crash-looping boot.
        manifest = publish_weights(
            args.watch_dir,
            params_to_jax(model.init(args.seed, device="cpu"), model.module),
            meta={"bootstrap": True}, keep=args.publish_keep)
        print(json.dumps({"bootstrap_published": manifest["path"],
                          "version": manifest["version"]}), flush=True)
    boot_weights = manifest["path"]

    def replica_args(i: int) -> list[str]:
        # No --weights: replicas boot random-init and the supervisor
        # reloads the fleet's current_weights (a controller-STAGED
        # file) before each becomes routable — initial start and every
        # later restart converge on the deployed version through one
        # path, immune to the watch dir's retention pruning the
        # original boot file.
        extra = [
            "--model", args.model, "--model-args", args.model_args,
            "--slots", str(args.slots),
            "--max-queue", str(args.max_queue),
            "--seed", str(args.seed),
            *_serving_config_flags(args),
            "--request-trace", "512",
            "--flight-recorder", "256",
        ]
        if args.audit_recompiles != "off":
            extra += ["--audit-recompiles", args.audit_recompiles]
        return extra

    def replica_env(i: int) -> dict[str, str]:
        env = {}
        for item in args.replica_env:
            key, sep, val = item.partition("=")
            if not sep:
                raise SystemExit(
                    f"--replica-env needs KEY=VAL, got {item!r}")
            env[key] = val.replace("{i}", str(i))
        return env

    registry = MetricsRegistry()
    cluster = ServingCluster(
        lambda i: ProcessReplica(replica_args(i), host=args.host,
                                 env=replica_env(i)),
        args.replicas, host=args.host, port=args.port, registry=registry,
        router_kwargs={
            "wire_mode": "jsonl" if args.wire == "jsonl" else "auto"})

    async def go():
        # Controller first: its ctor stages the boot weights, and the
        # supervisor must know the fleet's current_weights BEFORE the
        # replicas start (each is brought to it pre-READY).
        controller = wire_controller(
            cluster.router, args.watch_dir, model=model,
            vocab=model.output_dim, golden_count=args.golden,
            golden_len=args.golden_len,
            golden_new_tokens=args.golden_new_tokens, seed=args.seed,
            registry=registry, device=device,
            canary_latency_s=args.canary_latency_ms / 1e3,
            poll_interval_s=args.poll_ms / 1e3,
            canary_tenant=args.tenant,
            initial_weights=boot_weights)
        cluster.supervisor.current_weights = (
            (controller.last_good or {}).get("path") or boot_weights)
        await cluster.start()
        controller_task = asyncio.get_running_loop().create_task(
            controller.run(), name="deploy-controller")
        print(json.dumps({
            "deploy": args.model, "host": args.host, "port": cluster.port,
            "watch_dir": args.watch_dir,
            "boot_weights": boot_weights,
            "replicas": {rid: {"host": info.host, "port": info.port}
                         for rid, info in cluster.replicas.items()},
        }), flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # non-unix
                pass
        try:
            await stop.wait()
        finally:
            controller.stop()
            try:
                await asyncio.wait_for(controller_task, 10.0)
            except asyncio.TimeoutError:
                controller_task.cancel()
            await cluster.stop()
        print(json.dumps({"deployz": controller.deployz()}), flush=True)

    try:
        asyncio.run(go())
    except KeyboardInterrupt:
        pass
    return 0


def deployz_main(argv=None) -> int:
    """``deployz`` subcommand: fetch and pretty-print a live deploy
    controller's state page (current/last-good/candidate versions,
    deploy history ring, quarantine records) from a ``run.py deploy``
    router. ``--json`` prints the raw payload for scripts."""
    import asyncio

    ap = argparse.ArgumentParser(prog="distkeras_tpu_torch.run deployz")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500,
                    help="the deploy router's front port")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON payload instead of the pretty page")
    args = ap.parse_args(argv)

    from distkeras_tpu_torch.serving import ServingClient, ServingError
    from distkeras_tpu_torch.serving.debugz import format_deployz

    async def go():
        async with ServingClient(args.host, args.port,
                                 max_retries=0) as client:
            return await client.deployz()

    try:
        payload = asyncio.run(go())
    except (OSError, ConnectionError) as e:
        print(f"deployz: cannot reach {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 1
    except ServingError as e:
        print(f"deployz: server refused: {e}", file=sys.stderr)
        return 1
    print(json.dumps(payload, indent=1) if args.json
          else format_deployz(payload))
    return 0


def debugz_main(argv=None) -> int:
    """``debugz`` subcommand: fetch and pretty-print a live server's (or
    router's) introspection page — slot table, queue ages, prefix-cache
    occupancy, replica table with restart log — or, with ``--trace ID``,
    the merged cross-process timeline of one request. ``--json`` prints
    the raw payload for scripts."""
    import asyncio

    ap = argparse.ArgumentParser(prog="distkeras_tpu_torch.run debugz")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500,
                    help="a serving server's port, or a cluster router's "
                         "front port (fleet-aggregated page)")
    ap.add_argument("--trace", default=None, metavar="TRACE_ID",
                    help="fetch ONE request's (merged) timeline instead "
                         "of the debugz page")
    ap.add_argument("--recent", type=int, default=None, metavar="N",
                    help="list the N most recent request timelines")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON payload instead of the pretty page")
    args = ap.parse_args(argv)

    from distkeras_tpu_torch.serving import ServingClient, ServingError
    from distkeras_tpu_torch.serving.debugz import format_debugz, format_tracez

    async def go():
        async with ServingClient(args.host, args.port,
                                 max_retries=0) as client:
            if args.trace is not None:
                return "tracez", await client.tracez(args.trace)
            if args.recent is not None:
                return "tracez", await client.tracez(n=args.recent)
            return "debugz", await client.debugz()

    try:
        kind, payload = asyncio.run(go())
    except (OSError, ConnectionError) as e:
        print(f"debugz: cannot reach {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 1
    except ServingError as e:
        print(f"debugz: server refused: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(payload, indent=1))
    else:
        print(format_tracez(payload) if kind == "tracez"
              else format_debugz(payload))
    return 0


def queryz_main(argv=None) -> int:
    """``queryz`` subcommand: filter / group / aggregate the wide-event
    per-request store of a live server — or a whole fleet through its
    router, where percentile aggregates merge bucket-exactly. E.g.::

        run.py queryz --where kind=sample --group-by tenant \\
            --agg count --agg p99:ttft_s

    ``--json`` prints the raw payload (including the mergeable
    histogram states) for scripts."""
    import asyncio

    ap = argparse.ArgumentParser(prog="distkeras_tpu_torch.run queryz")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500,
                    help="a serving server's port, or a cluster router's "
                         "front port (fleet-merged result)")
    ap.add_argument("--where", action="append", default=[],
                    metavar="COL<OP>VALUE",
                    help="filter term like kind=sample or ttft_s>0.25 "
                         "(repeatable; ops = != >= <= > <)")
    ap.add_argument("--group-by", action="append", default=[],
                    metavar="COL",
                    help="group-by column, up to 2 (repeatable, or one "
                         "comma-separated list)")
    ap.add_argument("--agg", action="append", default=[], metavar="SPEC",
                    help="aggregate spec: count, sum:COL, mean:COL, or "
                         "pX:COL like p99:ttft_s (repeatable; default "
                         "count)")
    ap.add_argument("--max-groups", type=int, default=None,
                    help="distinct group keys beyond this fold into "
                         "__other__ (server default 64)")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON payload instead of the pretty table")
    args = ap.parse_args(argv)
    group_by = [c for chunk in args.group_by
                for c in chunk.split(",") if c]

    from distkeras_tpu_torch.serving import ServingClient, ServingError
    from distkeras_tpu_torch.serving.debugz import format_queryz

    async def go():
        async with ServingClient(args.host, args.port,
                                 max_retries=0) as client:
            return await client.queryz(
                where=args.where or None, group_by=group_by or None,
                aggs=args.agg or None, max_groups=args.max_groups)

    try:
        payload = asyncio.run(go())
    except (OSError, ConnectionError) as e:
        print(f"queryz: cannot reach {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 1
    except ServingError as e:
        print(f"queryz: server refused: {e}", file=sys.stderr)
        return 1
    print(json.dumps(payload, indent=1) if args.json
          else format_queryz(payload))
    return 0


def _write_statusz(trainer, path: str) -> bool:
    """One atomic statusz snapshot (tmp + replace, same contract as the
    weight publisher: a concurrent reader sees old or new, never torn).
    False when the trainer has no training-health layer (yet)."""
    health = getattr(trainer, "training_health", None)
    if health is None:
        return False
    import threading

    # Per-thread tmp name: the periodic writer thread and the final
    # main-thread snapshot may overlap when join() times out on a
    # wedged statusz() — two writers on ONE tmp path would interleave
    # and os.replace would publish the torn result.
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            json.dump(health.statusz(), f)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def statusz_main(argv=None) -> int:
    """``statusz`` subcommand: pretty-print a training-health snapshot
    file (the JSON ``train --statusz-out`` rewrites live) — worker
    table, staleness percentiles, divergence, goodput, device memory.
    Run it in a second terminal against a live run's file."""
    ap = argparse.ArgumentParser(prog="distkeras_tpu_torch.run statusz")
    ap.add_argument("--file", required=True,
                    help="statusz JSON written by train --statusz-out")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON payload instead of the pretty page")
    args = ap.parse_args(argv)

    from distkeras_tpu_torch.serving.debugz import format_statusz

    try:
        with open(args.file) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        print(f"statusz: cannot read {args.file}: {e}", file=sys.stderr)
        return 1
    print(json.dumps(payload, indent=1) if args.json
          else format_statusz(payload))
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "cluster":
        return serve_main(argv[1:], prog="cluster", default_replicas=2)
    if argv and argv[0] == "debugz":
        return debugz_main(argv[1:])
    if argv and argv[0] == "queryz":
        return queryz_main(argv[1:])
    if argv and argv[0] == "deploy":
        return deploy_main(argv[1:])
    if argv and argv[0] == "deployz":
        return deployz_main(argv[1:])
    if argv and argv[0] == "statusz":
        return statusz_main(argv[1:])
    if argv and argv[0] == "train":  # explicit alias for the default mode
        argv = argv[1:]
    ap = argparse.ArgumentParser(prog="distkeras_tpu_torch.run")
    _add_device_flag(ap)
    ap.add_argument("--config", required=True, help="TrainerConfig JSON file")
    ap.add_argument("--data", required=True, help=".npz (features/label) or CSV")
    ap.add_argument("--model", default="mnist_mlp", help=f"one of {sorted(MODEL_ZOO)}")
    ap.add_argument("--model-args", default="{}", help="JSON kwargs for the model fn")
    ap.add_argument("--out", default=None, help="path to save trained weights")
    ap.add_argument("--metrics-out", default=None, help="JSONL per-step metrics")
    ap.add_argument("--trace-out", default=None,
                    help="enable spans; write Chrome-trace JSON (Perfetto-"
                         "loadable) of the whole run here")
    ap.add_argument("--profile-out", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the whole "
                         "run into this directory — the device-timeline "
                         "complement to --trace-out's host spans")
    ap.add_argument("--statusz-out", default=None, metavar="PATH",
                    help="async trainers: rewrite the training-health "
                         "statusz snapshot (worker table, staleness "
                         "percentiles, divergence, goodput, device memory) "
                         "to this JSON file every --statusz-interval "
                         "seconds; inspect live with `run.py statusz "
                         "--file PATH`")
    ap.add_argument("--statusz-interval", type=float, default=10.0,
                    help="seconds between --statusz-out rewrites")
    ap.add_argument("--publish-dir", default=None, metavar="DIR",
                    help="continuous deployment: atomically publish "
                         "stamped weight files + MANIFEST.json into DIR "
                         "on the --publish-every cadence (async trainers "
                         "publish the PS center; step trainers the live "
                         "params). A `run.py deploy` controller watching "
                         "DIR canary-validates and rolls each version "
                         "through the serving fleet")
    ap.add_argument("--publish-every", default="10s", metavar="N|Ns",
                    help="publish cadence: 'Ns' = every N seconds, bare "
                         "N = every N steps (PS commits for the async "
                         "family)")
    ap.add_argument("--publish-keep", type=int, default=5,
                    help="retained published versions (older files are "
                         "pruned; the manifest's current one is always "
                         "kept)")
    ap.add_argument("--publish-min-improvement", type=float, default=None,
                    metavar="DELTA",
                    help="metric gate: only publish when the loss "
                         "improved by at least DELTA over the best "
                         "published loss (a plateaued run stops churning "
                         "the fleet)")
    ap.add_argument("--audit-recompiles", action="store_true",
                    help="count train-step compiles (+ triggering shapes); "
                         "report appears in the summary line")
    ap.add_argument("--shuffle", action="store_true")
    args = ap.parse_args(argv)

    from distkeras_tpu_torch.telemetry.device import profile_trace
    from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
    from distkeras_tpu_torch.telemetry.registry import MetricsRegistry
    from distkeras_tpu_torch.telemetry.spans import enable_tracing
    from distkeras_tpu_torch.tracing import MetricStream
    from distkeras_tpu_torch.utils.config import TrainerConfig

    _resolve_device(args.device)
    tracer = enable_tracing() if args.trace_out else None
    cfg = TrainerConfig.from_json(open(args.config).read())
    cfg.extra.setdefault("device", args.device)
    model = load_model(args.model, json.loads(args.model_args))
    ds = load_data(args.data, cfg.features_col, cfg.label_col)
    trainer = cfg.build(model)
    # One registry behind the whole run: step counters, PS commit/dup
    # counters, and (async trainers) the training-health histograms all
    # land in the same scrapeable surface.
    trainer.registry = MetricsRegistry()
    if args.metrics_out:
        trainer.metric_stream = MetricStream.to_jsonl(
            args.metrics_out, registry=trainer.registry)
    if args.audit_recompiles:
        trainer.auditor = RecompileAuditor(registry=trainer.registry)
    if args.publish_dir:
        from distkeras_tpu_torch.deploy import (
            WeightPublisher, parse_publish_every,
        )

        policy = parse_publish_every(args.publish_every)
        policy.min_improvement = args.publish_min_improvement
        trainer.publisher = WeightPublisher(
            args.publish_dir, policy, keep=args.publish_keep,
            registry=trainer.registry)

    import contextlib
    import threading

    stop_statusz = threading.Event()
    statusz_thread = None
    if args.statusz_out:
        def _statusz_loop():
            while not stop_statusz.wait(args.statusz_interval):
                _write_statusz(trainer, args.statusz_out)

        statusz_thread = threading.Thread(
            target=_statusz_loop, name="statusz-writer", daemon=True)
        statusz_thread.start()

    profiler = (profile_trace(args.profile_out) if args.profile_out
                else contextlib.nullcontext())
    try:
        with profiler:
            trained = trainer.train(ds, shuffle=args.shuffle)
    finally:
        # The JSONL stream owns a file handle; the trace is only useful
        # if it lands on disk even when training dies mid-run.
        if statusz_thread is not None:
            stop_statusz.set()
            statusz_thread.join(timeout=5)
            # Final snapshot: the post-mortem view even for runs shorter
            # than one interval.
            _write_statusz(trainer, args.statusz_out)
        if trainer.metric_stream is not None:
            trainer.metric_stream.close()
        if tracer is not None:
            tracer.export_chrome_trace(args.trace_out)
    summary = {
        "trainer": cfg.trainer,
        "steps": len(trainer.get_history()),
        "training_time_s": round(trainer.get_training_time(), 3),
        "averaged_history": {
            k: round(v, 5) for k, v in trainer.get_averaged_history().items()
        },
    }
    if args.audit_recompiles:
        summary["recompile_audit"] = trainer.auditor.report()
    if args.trace_out:
        summary["trace_out"] = args.trace_out
    if args.profile_out:
        summary["profile_out"] = args.profile_out
    if args.statusz_out and getattr(trainer, "training_health", None):
        summary["statusz"] = args.statusz_out
        health = trainer.training_health
        stale = health.staleness_percentiles()
        if stale:
            summary["staleness_p99"] = round(stale["p99"], 3)
        if health.goodput_ratio is not None:
            summary["goodput_ratio"] = round(health.goodput_ratio, 6)
    if args.publish_dir and trainer.publisher is not None:
        summary["published"] = trainer.publisher.stats()
    if args.out:
        if isinstance(trained, list):  # EnsembleTrainer
            for i, t in enumerate(trained):
                t.save_weights(f"{args.out}.{i}")
            summary["saved"] = [f"{args.out}.{i}" for i in range(len(trained))]
        else:
            trained.save_weights(args.out)
            summary["saved"] = args.out
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
