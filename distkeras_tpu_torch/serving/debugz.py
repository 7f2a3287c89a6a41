"""Render ``debugz`` / ``tracez`` payloads for humans.

Copy of the reference's ``distkeras_tpu/serving/debugz.py``, which
imports no JAX; only its imports differ.

The wire verbs return JSON (scripts and dashboards want that); this
module is the terminal half — ``python -m distkeras_tpu_torch.run debugz``
fetches a page from a server or router and prints it through
:func:`format_debugz` / :func:`format_tracez`. Pure formatting, no I/O:
testable on captured payloads, reusable by anything that already has the
dict.

Output discipline: fixed-width tables for the enumerable parts (slots,
queue, replicas), one indented line per scalar elsewhere, and ages in
seconds with millisecond precision — the operator is diagnosing a live
incident, so the page must scan top-down: fleet -> replica -> slot ->
request.
"""

from __future__ import annotations

import time

__all__ = ["format_debugz", "format_tracez", "format_statusz",
           "format_deployz", "format_queryz"]


def _table(rows: list[dict], columns: list[tuple[str, str]]) -> list[str]:
    """Fixed-width text table: ``columns`` is (header, row-key) pairs;
    missing values render as '-'."""
    cells = [[str(r.get(key, "-")) if r.get(key) is not None else "-"
              for _, key in columns] for r in rows]
    widths = [max(len(h), *(len(c[i]) for c in cells)) if cells else len(h)
              for i, (h, _) in enumerate(columns)]
    out = ["  ".join(h.ljust(w) for (h, _), w in zip(columns, widths))]
    for row in cells:
        out.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    return out


def _engine_section(dz: dict, indent: str = "") -> list[str]:
    """One engine's debugz payload (a standalone server's page, or one
    replica's sub-page in a fleet aggregate)."""
    lines: list[str] = []
    q = dz.get("queue", {})
    lines.append(f"{indent}active_slots={dz.get('active_slots')} "
                 f"queue_depth={q.get('depth')}/{q.get('max_depth')} "
                 f"oldest_queued={q.get('oldest_age_s', 0):.3f}s "
                 f"decode_compiles={dz.get('decode_compile_count')}"
                 + (" STOPPING" if dz.get("stopping") else "")
                 + (" SWAP-PENDING" if dz.get("pending_swap") else ""))
    if dz.get("slo_s") is not None:
        lines.append(f"{indent}slo={dz['slo_s']}s")
    kinds = dz.get("request_kinds")
    if isinstance(kinds, dict) and kinds:
        # Admission census by request kind — the first read when
        # triaging "what is this replica actually serving" (a scoring
        # flood shows here before it shows anywhere else).
        lines.append(f"{indent}request_kinds: " + " ".join(
            f"{k}={kinds[k]}" for k in sorted(kinds)))
    pl = dz.get("pipeline")
    if isinstance(pl, dict):
        gap = pl.get("host_gap_p50_s")
        idle = pl.get("device_idle_ratio")
        lines.append(
            f"{indent}pipeline: depth={pl.get('depth')} "
            f"inflight={pl.get('inflight') or '-'}"
            + (f" host_gap_p50={gap * 1e3:.3f}ms" if gap is not None
               else "")
            + (f" device_idle={idle:.1%}" if idle is not None else ""))
        if pl.get("stages"):
            bf = pl.get("bubble_fraction")
            lines.append(
                f"{indent}stages: {pl['stages']} pp stage(s) x "
                f"{pl.get('micro_batches')} micro-batch(es), "
                f"inflight_ticks={pl.get('inflight_ticks')}"
                + (f" bubble={bf:.1%}" if bf is not None else ""))
    sp = dz.get("speculative")
    if sp:
        rate = sp.get("accept_rate")
        lines.append(
            f"{indent}speculative: draft={sp.get('draft_model')} "
            f"k={sp.get('spec_k')} "
            f"accepted={sp.get('accepted_tokens')}/"
            f"{sp.get('draft_tokens')} drafts"
            + (f" (rate {rate})" if rate is not None else ""))
    wv = dz.get("weight_version")
    if isinstance(wv, dict):
        lines.append(f"{indent}weights: v{wv.get('version')} "
                     f"digest={wv.get('digest') or '-'}")
    mesh = dz.get("mesh")
    if isinstance(mesh, dict):
        axes = ",".join(f"{a}={s}" for a, s in
                        (mesh.get("axes") or {}).items())
        lines.append(f"{indent}mesh: {axes or '-'} over "
                     f"{len(mesh.get('devices') or [])} device(s)")
    slots = dz.get("slots", [])
    if slots:
        lines.append(f"{indent}slots:")
        cols = [("slot", "slot"), ("state", "state"),
                ("trace_id", "trace_id"),
                ("depth", "depth"), ("age_s", "age_s"),
                ("remaining", "remaining")]
        if any(s.get("tenant") not in (None, "default") for s in slots):
            # Multi-tenant traffic: whose request holds each slot — the
            # first column of the hot-tenant triage.
            cols.insert(2, ("tenant", "tenant"))
        if any("blocks" in s for s in slots):
            # Paged engine: per-slot block-table depth (total blocks the
            # slot addresses / how many are shared prefix blocks).
            cols += [("blocks", "blocks"), ("shared", "shared_blocks")]
        if any(s.get("kind") not in (None, "generate") for s in slots):
            # Mixed-kind traffic: which verb holds each slot (fork
            # children show as 'sample', scorelike work as
            # 'score'/'embed').
            cols.insert(2, ("kind", "kind"))
        if any("automaton_state" in s for s in slots):
            # Constrained streams: where each one's host-side automaton
            # sits — a stream wedged mid-grammar shows as a stuck state.
            cols += [("dfa", "automaton_state")]
        if any("accept_rate" in s for s in slots):
            # Speculating engine: this request's committed-draft ratio —
            # the column that answers "which stream is the draft model
            # failing to predict" when the fleet accept rate sags.
            cols += [("accept", "accept_rate")]
        for ln in _table(slots, cols):
            lines.append(f"{indent}  {ln}")
    queued = q.get("queued", [])
    if queued:
        lines.append(f"{indent}queued (service order):")
        for ln in _table(queued, [("trace_id", "trace_id"),
                                  ("prio", "priority"), ("age_s", "age_s"),
                                  ("prompt", "prompt_tokens"),
                                  ("deadline_in", "deadline_in_s")]):
            lines.append(f"{indent}  {ln}")
    tenants = dz.get("tenants")
    if isinstance(tenants, dict) and (
            len(tenants) > 1 or any(t != "default" for t in tenants)):
        lines.append(f"{indent}tenants:")
        rows = []
        for name, st in sorted(tenants.items()):
            quota = st.get("quota") or {}
            rows.append({
                "tenant": name,
                "active": st.get("active_slots", 0),
                "queued": st.get("queued", 0),
                "completed": st.get("completed", 0),
                "quota_tok_s": quota.get("rate_tokens_per_s", "-"),
                "quota_avail": quota.get("available", "-"),
                "shed": st.get("over_quota_rejects", 0),
            })
        for ln in _table(rows, [("tenant", "tenant"),
                                ("active", "active"),
                                ("queued", "queued"),
                                ("done", "completed"),
                                ("quota_tok/s", "quota_tok_s"),
                                ("avail", "quota_avail"),
                                ("shed", "shed")]):
            lines.append(f"{indent}  {ln}")
    pc = dz.get("prefix_cache")
    if pc:
        lines.append(
            f"{indent}prefix_cache: {pc.get('blocks_used')}/"
            f"{pc.get('capacity_blocks')} blocks "
            f"({pc.get('families')} families)")
        fams = pc.get("top_families", [])
        if fams:
            for ln in _table(fams, [("family_head", "family_head"),
                                    ("blocks", "blocks"),
                                    ("tokens", "tokens"),
                                    ("pins", "pinned_refs"),
                                    ("depth", "max_chain_depth")]):
                lines.append(f"{indent}  {ln}")
    kp = dz.get("kv_pool")
    if kp:
        lines.append(
            f"{indent}kv_pool: {kp.get('blocks_used')}/"
            f"{kp.get('capacity_blocks')} blocks used "
            f"({kp.get('blocks_free')} free, "
            f"{kp.get('families')} prefix families, "
            f"{kp.get('preemptions', 0)} preemptions, "
            f"{kp.get('oom_rejections', 0)} oom rejects)")
        if kp.get("kv_migrations") or kp.get("kv_migration_fallbacks") \
                or kp.get("kv_exports"):
            # Disaggregated serving: this replica's block-migration
            # traffic (imports adopted / fallbacks to monolithic
            # prefill / bytes moved / chains exported to peers).
            lines.append(
                f"{indent}kv_migration: "
                f"{kp.get('kv_migrations', 0)} adopted, "
                f"{kp.get('kv_migration_fallbacks', 0)} fallbacks, "
                f"{_mb(kp.get('kv_migration_bytes', 0)) or '0.0'} MB "
                f"moved, {kp.get('kv_exports', 0)} exports")
        fams = kp.get("top_families", [])
        if fams:
            for ln in _table(fams, [("family_head", "family_head"),
                                    ("blocks", "blocks"),
                                    ("tokens", "tokens"),
                                    ("pins", "pinned_refs"),
                                    ("depth", "max_chain_depth")]):
                lines.append(f"{indent}  {ln}")
    kt = dz.get("kv_tier")
    if kt:
        # Tiered KV cache: host/disk residency under the device pool,
        # plus the spill/readmit/push traffic that crossed the tiers.
        lines.append(
            f"{indent}kv_tier: "
            f"{_mb(kt.get('resident_bytes', 0)) or '0.0'} MB device, "
            f"{kt.get('host_entries', 0)} host blocks "
            f"({_mb(kt.get('host_bytes', 0)) or '0.0'}/"
            f"{_mb(kt.get('host_budget_bytes', 0)) or '0.0'} MB)"
            + (f", {kt.get('disk_entries', 0)} disk blocks "
               f"({_mb(kt.get('disk_bytes', 0)) or '0.0'} MB)"
               if kt.get("disk_budget_bytes") else ""))
        lines.append(
            f"{indent}kv_tier_traffic: "
            f"{kt.get('spills', 0)} spills "
            f"({_mb(kt.get('spill_bytes', 0)) or '0.0'} MB), "
            f"{kt.get('readmits', 0)} readmits "
            f"({_mb(kt.get('readmit_bytes', 0)) or '0.0'} MB), "
            f"{kt.get('hits', 0)} hits / {kt.get('misses', 0)} misses, "
            f"{kt.get('evictions', 0)} evictions, "
            f"{kt.get('pushes', 0)} pushes "
            f"({kt.get('push_fallbacks', 0)} fallbacks)")
    fr = dz.get("flight_recorder")
    if fr:
        lines.append(
            f"{indent}flight_recorder: {fr.get('events_recorded')} events, "
            f"{fr.get('timelines_recorded')} timelines, "
            f"{fr.get('slow_exemplars')} slow exemplars"
            + (f" -> {fr['dump_path']}" if fr.get("dump_path") else ""))
    ts = dz.get("trace_store")
    if ts:
        ln = (f"{indent}trace_store: {ts.get('records')}/"
              f"{ts.get('capacity')} records "
              f"({ts.get('evicted')} evicted)")
        if ts.get("keepers") is not None:
            # Tail retention armed: the reservoir of records scored
            # worth keeping past the sliding window, and the pins that
            # can never leave it.
            ln += (f", {ts['keepers']}/{ts.get('keeper_capacity')} keepers"
                   f" ({ts.get('pinned', 0)} pinned)")
        lines.append(ln)
    return lines


def format_debugz(payload: dict) -> str:
    """Pretty-print a debugz payload — either the fleet shape the router
    returns (``router``/``replicas``/``restart_log``) or a single
    engine's shape (``slots``/``queue``/...)."""
    lines: list[str] = []
    if "replicas" in payload and "router" in payload:
        r = payload["router"]
        lines.append(
            f"router: {r.get('replicas_ready')}/{r.get('replicas_total')} "
            f"ready, {r.get('outstanding_total')} outstanding, "
            f"{r.get('pooled_connections', 0)} pooled conns")
        for rid in sorted(payload["replicas"]):
            info = payload["replicas"][rid]
            role = info.get("role")
            lines.append(
                f"replica {rid}: {info.get('status')} "
                + (f"[{role}] " if role and role != "monolithic" else "")
                + f"{info.get('host')}:{info.get('port')} "
                f"outstanding={info.get('outstanding')} "
                f"restarts={info.get('restarts')} "
                f"fails={info.get('consecutive_failures')} "
                f"backoff_exp={info.get('consecutive_restarts')}")
            sub = info.get("debugz")
            if isinstance(sub, dict) and "unreachable" in sub:
                lines.append(f"  UNREACHABLE: {sub['unreachable']}")
            elif isinstance(sub, dict):
                lines.extend(_engine_section(sub, indent="  "))
        log = payload.get("restart_log", [])
        if log:
            lines.append("restart log (most recent last):")
            for e in log:
                when = time.strftime("%H:%M:%S",
                                     time.localtime(e.get("t", 0)))
                if e.get("restarted"):
                    lines.append(f"  {when} {e.get('rid')}: restarted "
                                 f"(#{e.get('restarts')}) on "
                                 f"{e.get('host')}:{e.get('port')}")
                else:
                    ln = f"  {when} {e.get('rid')}: DIED — {e.get('why')}"
                    if e.get("flight_recorder"):
                        ln += f"; last words: {e['flight_recorder']}"
                    lines.append(ln)
                    lw = e.get("last_words")
                    if isinstance(lw, dict):
                        lines.append(
                            f"      dump: {lw.get('events')} events, "
                            f"{lw.get('timelines')} timelines, "
                            f"{lw.get('slow_exemplars')} slow")
                    elif isinstance(lw, str):
                        lines.append(f"      dump: {lw}")
    else:
        lines.extend(_engine_section(payload))
    return "\n".join(lines)


def format_statusz(payload: dict) -> str:
    """Pretty-print a training-health statusz snapshot
    (:meth:`distkeras_tpu_torch.telemetry.training_health.TrainingHealth.
    statusz`): run header, staleness/divergence/goodput rollup, the
    per-worker vitals table, the PS rollup, and the per-device memory
    table (``unavailable`` where the backend publishes no stats — never
    a lying 0). Same scan discipline as debugz: run -> worker -> device,
    in metric-triage order."""
    lines: list[str] = []
    lines.append(
        f"training: protocol={payload.get('protocol') or '?'} "
        f"workers={payload.get('num_workers')} "
        f"uptime={payload.get('uptime_s', 0):.1f}s")
    ps = payload.get("ps")
    if isinstance(ps, dict):
        lines.append(
            f"ps: running={ps.get('running')} "
            f"updates={ps.get('num_updates')} "
            f"commits={ps.get('num_commits')} "
            f"dups={ps.get('num_duplicates')} "
            f"queue_depth={ps.get('queue_depth')} "
            f"snapshot_failures={ps.get('snapshot_failures')}")
    stale = payload.get("staleness")
    if isinstance(stale, dict):
        lines.append(
            f"staleness: p50={stale.get('p50')} p90={stale.get('p90')} "
            f"p99={stale.get('p99')} max={stale.get('max')} "
            f"({stale.get('samples')} samples)")
    if payload.get("divergence") is not None:
        lines.append(f"divergence: ||local-center||={payload['divergence']}")
    gp = payload.get("goodput")
    if isinstance(gp, dict):
        lines.append(
            f"goodput: applied/committed update mass = "
            f"{gp.get('applied_mass')}/{gp.get('update_mass')} "
            f"(ratio {gp.get('ratio')})")
    workers = payload.get("workers", [])
    if workers:
        lines.append("workers:")
        cols = [("worker", "worker"), ("commits", "commits"),
                ("dups", "duplicates"), ("pulls", "pulls"),
                ("rebases", "rebases"), ("windows", "windows"),
                ("last_commit_age_s", "last_commit_age_s"),
                ("stale_last", "last_staleness"),
                ("stale_p50", "staleness_p50"),
                ("stale_p99", "staleness_p99"),
                ("rate/s", "commit_rate_per_s")]
        if any("divergence" in w for w in workers):
            cols.append(("divergence", "divergence"))
        for ln in _table(workers, cols):
            lines.append(f"  {ln}")
    mem = payload.get("memory", [])
    if mem:
        lines.append("device memory:")
        rows = []
        for m in mem:
            if m.get("available"):
                rows.append({
                    "device": m.get("device"),
                    "in_use_mb": _mb(m.get("bytes_in_use")),
                    "limit_mb": _mb(m.get("bytes_limit")),
                    "peak_mb": _mb(m.get("peak_bytes_in_use")),
                    "headroom_mb": _mb(m.get("headroom_bytes")),
                })
            else:
                # The typed sentinel: no data is NOT zero bytes.
                rows.append({"device": m.get("device"),
                             "in_use_mb": "unavailable"})
        for ln in _table(rows, [("device", "device"),
                                ("in_use_mb", "in_use_mb"),
                                ("limit_mb", "limit_mb"),
                                ("peak_mb", "peak_mb"),
                                ("headroom_mb", "headroom_mb")]):
            lines.append(f"  {ln}")
    if payload.get("observe_errors"):
        lines.append(f"observe_errors: {payload['observe_errors']} "
                     f"(health hooks failing — see the training log)")
    return "\n".join(lines)


def _wv(prov) -> str:
    if not isinstance(prov, dict):
        return "-"
    base = f"v{prov.get('version')} digest={prov.get('digest') or '-'}"
    path = prov.get("path")
    return f"{base} ({path})" if path else base


def format_deployz(payload: dict) -> str:
    """Pretty-print a ``deployz`` payload
    (:meth:`distkeras_tpu_torch.deploy.controller.DeployController.deployz`):
    current/last-good/candidate versions, deploy counters, the history
    ring (most recent last), and quarantine records — the page an
    operator reads first when "the fleet is serving the wrong model"."""
    lines: list[str] = []
    lines.append(f"deploy: watching {payload.get('watch_dir')} "
                 f"(poll {payload.get('poll_interval_s')}s, "
                 f"{payload.get('golden_prompts', 0)} golden prompts)")
    lines.append(f"current:   {_wv(payload.get('current'))}")
    lines.append(f"last_good: {_wv(payload.get('last_good'))}")
    if payload.get("candidate"):
        lines.append(f"candidate: {_wv(payload['candidate'])} (in flight)")
    c = payload.get("counters", {})
    lines.append(f"counters: deploys={c.get('deploys')} "
                 f"canary_failures={c.get('canary_failures')} "
                 f"validation_failures={c.get('validation_failures')} "
                 f"rollbacks={c.get('rollbacks')}")
    history = payload.get("history", [])
    if history:
        lines.append("history (most recent last):")
        rows = []
        for e in history:
            rows.append({
                "when": time.strftime("%H:%M:%S",
                                      time.localtime(e.get("t", 0))),
                "version": f"v{e.get('version')}",
                "status": e.get("status"),
                "latency_s": e.get("latency_s"),
                "step": e.get("step"),
                "loss": e.get("loss"),
                "canary": e.get("canary"),
                "reason": (str(e.get("reason"))[:48]
                           if e.get("reason") else None),
            })
        for ln in _table(rows, [("when", "when"), ("version", "version"),
                                ("status", "status"),
                                ("latency_s", "latency_s"),
                                ("step", "step"), ("loss", "loss"),
                                ("canary", "canary"),
                                ("reason", "reason")]):
            lines.append(f"  {ln}")
    quarantined = payload.get("quarantined", [])
    if quarantined:
        lines.append("quarantined:")
        for q in quarantined:
            lines.append(f"  v{q.get('version')}: {q.get('reason')} -> "
                         f"{q.get('quarantined_to', q.get('path'))}")
    return "\n".join(lines)


def _agg_cell(payload) -> str:
    """One aggregate's display value: '-' for no data, 6 significant
    digits otherwise (these are seconds/tokens/counts, not currency)."""
    v = payload.get("value") if isinstance(payload, dict) else payload
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def format_queryz(payload: dict) -> str:
    """Pretty-print a ``queryz`` result (one server's, or the router's
    fleet-merged page): header with match counts, one fixed-width row
    per group with its group-by key and aggregate values, then folded-
    group and per-replica reachability notes."""
    lines: list[str] = []
    head = (f"queryz: matched {payload.get('matched', 0)} of "
            f"{payload.get('scanned', 0)} events")
    if payload.get("merged_from"):
        head += f" (merged from {payload['merged_from']} replica(s))"
    lines.append(head)
    group_by = list(payload.get("group_by") or ())
    aggs = list(payload.get("aggs") or ())
    rows = []
    for g in payload.get("groups", ()):
        row = {c: g.get("key", {}).get(c, "") for c in group_by}
        row["count"] = g.get("count")
        for spec in aggs:
            row[spec] = _agg_cell(g.get("aggs", {}).get(spec))
        rows.append(row)
    cols = ([(c, c) for c in group_by] + [("count", "count")]
            + [(s, s) for s in aggs if s != "count"])
    if rows:
        for ln in _table(rows, cols):
            lines.append(f"  {ln}")
    else:
        lines.append("  (no matching events)")
    if payload.get("folded_groups"):
        lines.append(f"  ... {payload['folded_groups']} group key(s) "
                     f"folded into __other__ (raise --max-groups)")
    reps = payload.get("replicas")
    if isinstance(reps, dict):
        bad = {rid: sub for rid, sub in reps.items()
               if isinstance(sub, dict) and "matched" not in sub}
        for rid in sorted(bad):
            sub = bad[rid]
            why = sub.get("unreachable") or sub.get("error") or "no data"
            lines.append(f"  replica {rid}: NOT MERGED — {why}")
    return "\n".join(lines)


def _mb(n) -> str | None:
    return None if n is None else f"{n / 2**20:.1f}"


def _fmt_event(ts: float, source: str, name: str, attrs) -> str:
    when = time.strftime("%H:%M:%S", time.localtime(ts))
    # Truncate, don't round: rounding renders fraction .9995+ as "1000".
    ms = f"{int((ts % 1) * 1000):03d}"
    line = f"  {when}.{ms} {source:<16} {name}"
    if attrs:
        kv = " ".join(f"{k}={v}" for k, v in attrs.items() if v is not None)
        if kv:
            line += f"  ({kv})"
    return line


def _tick_lane(ticks) -> list[str]:
    """The engine's dispatch→harvest tick timeline as its own lane:
    per tick, kind, live rows, how long the harvest blocked on the
    device (device-bound time the pipeline hid host work behind) and
    the measured host gap (device-idle time it failed to hide)."""
    if not ticks:
        return []
    lines = [f"tick lane ({len(ticks)} most recent):"]
    for tk in ticks:
        td, th = tk.get("t_dispatch"), tk.get("t_harvest")
        span_s = (f" span={th - td:.6f}s"
                  if isinstance(td, float) and isinstance(th, float)
                  else "")
        lines.append(
            f"  {tk.get('kind', '?'):<6} rows={tk.get('rows', '-')}"
            f" harvest_wait={tk.get('harvest_wait_s', '-')}s"
            f" host_gap={tk.get('host_gap_s', '-')}s{span_s}")
    return lines


def format_tracez(payload: dict) -> str:
    """Pretty-print a tracez payload: a merged cross-process trace
    (router + engine hops), a single store's hop list, or a recent-
    records listing."""
    lines: list[str] = []
    if "recent" in payload:
        lines.append(f"{payload.get('records', len(payload['recent']))} "
                     f"recorded; most recent:")
        for rec in payload["recent"]:
            d = rec.get("data", {})
            lines.append(
                f"  {rec.get('trace_id')}  {rec.get('role')}:"
                f"{rec.get('source')}  status={d.get('status', '?')} "
                f"latency={d.get('latency_s', '-')}s "
                f"tokens={d.get('tokens_out', '-')}")
        lines.extend(_tick_lane(payload.get("ticks")))
        return "\n".join(lines)
    tid = payload.get("trace_id")
    lines.append(f"trace {tid}")
    router = payload.get("router")
    if router:
        d = router.get("data", {})
        lines.append(f"router: status={d.get('status')} "
                     f"retries={d.get('retries', 0)} "
                     f"hops={d.get('hops', [])}")
    hops = payload.get("engine_hops") or payload.get("hops") or []
    for hop in hops:
        if not isinstance(hop, dict):
            continue
        d = hop.get("data", {})
        lines.append(
            f"engine hop {hop.get('source')}: status={d.get('status')} "
            f"queue_wait={d.get('queue_wait_s', '-')}s "
            f"prefill={d.get('prefill_device_s', '-')}s"
            f"/{d.get('prefill_chunks', '-')}ch "
            f"cache_hit={d.get('cache_hit_tokens', '-')}tok "
            f"ttft={d.get('ttft_s', '-')}s "
            f"latency={d.get('latency_s', '-')}s "
            f"tokens={d.get('tokens_out', '-')}")
    events = payload.get("events")
    if events:
        lines.append("events:")
        for ts, source, name, attrs in events:
            lines.append(_fmt_event(ts, source, name, attrs))
    return "\n".join(lines)
