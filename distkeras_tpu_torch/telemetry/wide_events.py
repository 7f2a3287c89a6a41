"""Wide-event per-request analytics: a columnar ring + query engine.

Copy of the reference's ``distkeras_tpu/telemetry/wide_events.py``, which imports no JAX;
only its imports differ.

One canonical FLAT record per finished request, emitted at done-time
(zero per-token cost), answers the question the fleet histogram plane
cannot: "WHICH tenant/kind/replica is slow, and why". Instead of a
dict per row — 40 boxed values and a heap allocation per request —
the store keeps ~40 parallel typed arrays (``array.array``) overwritten
ring-style, so 4096 requests of 40 columns cost ~1.3 MB flat and an
append is 40 array writes with no allocation in steady state.

The query engine evaluates ``filter / group_by (≤2 columns, cardinality
capped) / aggs`` (count · sum · mean · pX) in one scan. Percentile
aggregates are NOT computed from raw values alone: every group carries
a histogram ``state()`` dict on the ONE fixed
:data:`WIDE_HIST_BUCKETS` layout, so a router can fold per-replica
query results bucket-exactly with
:func:`~distkeras_tpu_torch.telemetry.registry.merge_hist_states` — the same
merge the fleet telemetry plane already trusts — and a fleet p99 is
reproducible from raw events to within one bucket width.

Everything here is dependency-free and jax-free: the Echo replicas use
a real store for router fan-out tests, and the supervisor's crash
tooling can read a dump without an accelerator runtime.
"""

from __future__ import annotations

import math
import threading
import time
from array import array

from distkeras_tpu_torch.telemetry.registry import (
    Histogram,
    hist_state_percentile,
    log_buckets,
    merge_hist_states,
)

__all__ = [
    "COLUMNS",
    "WIDE_HIST_BUCKETS",
    "WideEventStore",
    "parse_where",
    "parse_aggs",
    "merge_query_results",
]

# Column kinds: "i" int64, "f" float64, "s" interned low-cardinality
# string (stored as an int id column + per-column intern table), "o"
# arbitrary object (unique-per-row strings like trace ids — interning
# them would grow the table without bound, so they live in a plain
# list ring instead).
COLUMNS: tuple[tuple[str, str], ...] = (
    ("trace_id", "o"),
    ("t_done", "f"),            # wall-clock completion time (unix s)
    ("tenant", "s"),
    ("kind", "s"),              # sample | score | embed
    ("priority", "i"),
    ("replica", "s"),           # trace source, e.g. "r0"
    ("role", "s"),              # serving role (prefill/decode/mixed)
    ("mesh", "s"),              # mesh axis shape, e.g. "dp=1,tp=2"
    ("pp_stage", "i"),
    ("pp_depth", "i"),
    ("weight_version", "i"),
    ("weight_digest", "s"),
    ("prompt_tokens", "i"),
    ("output_tokens", "i"),
    ("max_new_tokens", "i"),
    ("prefix_hit_tokens", "i"),
    ("kv_blocks", "i"),
    ("forks", "i"),             # CoW fork completions delivered
    ("n", "i"),                 # requested fork count
    ("preemptions", "i"),
    ("migration", "s"),         # "" | imported | exported | failed
    ("queue_wait_s", "f"),
    ("prefill_device_s", "f"),
    ("prefill_chunks", "i"),
    ("ttft_s", "f"),
    ("latency_s", "f"),
    ("decode_iterations", "i"),
    ("spec_drafted", "i"),
    ("spec_accepted", "i"),
    ("spec_accept_rate", "f"),
    ("mask_uploads", "i"),      # constrained-decode mask uploads
    ("constrained", "i"),       # 0/1: had a decode constraint
    ("cache_overtaken", "i"),   # 0/1: prefix re-matched post-admit
    ("speculate", "i"),         # requested speculation depth
    ("temperature", "f"),
    ("status", "s"),            # ok | error | cancelled | timeout
    ("error_kind", "s"),        # typed error class name, "" when ok
    ("slo_verdict", "s"),       # ok | slow
    ("timeout_s", "f"),
    ("stream", "i"),            # 0/1: streamed delivery
)

_KINDS = dict(COLUMNS)

# Null sentinels. -1 for ints (no wide-event counter is legitimately
# negative), NaN for floats, intern id 0 (the empty string, pre-seeded)
# for interned strings, None for object columns.
_INT_NULL = -1
_FLOAT_NULL = math.nan

# The ONE bucket layout every pX aggregate uses — 1 µs to 1 M, six
# bounds per decade (~73 bounds). Fixed so that independently built
# stores (every replica, the router, offline recompute in tests) merge
# bucket-exactly; covers latencies AND token/block counts.
WIDE_HIST_BUCKETS = log_buckets(1e-6, 1e6, per_decade=6)

_AGG_FUNCS = ("count", "sum", "mean")


def parse_where(terms) -> list[tuple[str, str, object]]:
    """Parse filter terms like ``"kind=sample"`` / ``"ttft_s>0.25"``
    into ``(column, op, value)`` triples. Ops: ``= != >= <= > <``
    (ordering ops only on numeric columns). Raises ``ValueError`` on an
    unknown column, a malformed term, or an op/column-type mismatch —
    the server maps that to a typed ``bad_request`` so a CLI typo comes
    back as a message, not a silent empty result."""
    out = []
    for term in terms or ():
        term = str(term)
        for op in ("!=", ">=", "<=", "=", ">", "<"):
            if op in term:
                col, _, raw = term.partition(op)
                break
        else:
            raise ValueError(
                f"malformed where term {term!r} (want column<op>value)")
        col, raw = col.strip(), raw.strip()
        kind = _KINDS.get(col)
        if kind is None:
            raise ValueError(f"unknown column {col!r}")
        if kind in ("i", "f"):
            try:
                val: object = float(raw)
            except ValueError:
                raise ValueError(
                    f"column {col!r} is numeric; cannot compare to {raw!r}")
        else:
            if op not in ("=", "!="):
                raise ValueError(
                    f"op {op!r} needs a numeric column, {col!r} is a string")
            val = raw
        out.append((col, op, val))
    return out


def parse_aggs(specs) -> list[tuple[str, float | None, str | None]]:
    """Parse aggregate specs — ``"count"``, ``"sum:latency_s"``,
    ``"mean:ttft_s"``, ``"p99:ttft_s"`` / ``"p99.9:latency_s"`` — into
    ``(func, q, column)`` triples (``func="p"`` carries q; others
    ``q=None``). pX and sum/mean require a numeric column."""
    out = []
    for spec in specs or ("count",):
        spec = str(spec)
        func, _, col = spec.partition(":")
        func = func.strip()
        col = col.strip() or None
        if func == "count":
            if col is not None:
                raise ValueError("count takes no column")
            out.append(("count", None, None))
            continue
        if col is None:
            raise ValueError(f"agg {spec!r} needs a column (func:column)")
        kind = _KINDS.get(col)
        if kind is None:
            raise ValueError(f"unknown column {col!r}")
        if kind not in ("i", "f"):
            raise ValueError(
                f"agg {func!r} needs a numeric column, {col!r} is a string")
        if func in ("sum", "mean"):
            out.append((func, None, col))
        elif func.startswith("p"):
            try:
                q = float(func[1:])
            except ValueError:
                raise ValueError(f"unknown aggregate {func!r}")
            if not 0.0 <= q <= 100.0:
                raise ValueError(f"percentile out of range: {func!r}")
            out.append(("p", q, col))
        else:
            raise ValueError(f"unknown aggregate {func!r}")
    return out


def _agg_key(func: str, q: float | None, col: str | None) -> str:
    if func == "count":
        return "count"
    if func == "p":
        qs = f"{q:g}"
        return f"p{qs}:{col}"
    return f"{func}:{col}"


class _GroupAcc:
    """Per-group accumulator for one query: exact count/sum plus a
    fixed-layout histogram per pX aggregate (exemplared with trace ids
    so a slow group's p99 links straight to a retrievable trace)."""

    __slots__ = ("count", "sums", "hists")

    def __init__(self, aggs):
        self.count = 0
        self.sums: dict[str, list] = {}    # col -> [sum, n]
        self.hists: dict[str, Histogram] = {}
        for func, _q, col in aggs:
            if func in ("sum", "mean") and col not in self.sums:
                self.sums[col] = [0.0, 0]
            elif func == "p" and col not in self.hists:
                self.hists[col] = Histogram(
                    "wide_event_agg", buckets=WIDE_HIST_BUCKETS)


class WideEventStore:
    """Bounded columnar overwrite ring of wide events.

    ``append`` writes one slot across every parallel column under a
    lock (called once per FINISHED request — never per token) and
    self-times with one ``perf_counter`` pair so the bench probe can
    report real ns/event without wrapping the store. ``query`` scans
    the live rows oldest-first under the same lock; at the default
    4096-row capacity a full scan is sub-millisecond, which is the
    entire design argument for columnar-in-process over a log pipeline.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._count = 0            # total ever appended (monotonic)
        self._append_ns = 0        # total time inside append()
        self._cols: dict[str, object] = {}
        self._interns: dict[str, dict[str, int]] = {}
        self._rev_interns: dict[str, list[str]] = {}
        for name, kind in COLUMNS:
            if kind == "i":
                self._cols[name] = array("q", [_INT_NULL]) * self.capacity
            elif kind == "f":
                self._cols[name] = array("d", [_FLOAT_NULL]) * self.capacity
            elif kind == "s":
                self._cols[name] = array("q", [0]) * self.capacity
                self._interns[name] = {"": 0}
                self._rev_interns[name] = [""]
            else:
                self._cols[name] = [None] * self.capacity

    # -- write side ---------------------------------------------------------

    def append(self, record: dict) -> None:
        """Write one wide event. Unknown keys raise (a misspelled
        column would otherwise silently vanish); missing columns get
        the null sentinel. O(columns), no allocation beyond first-seen
        string interning."""
        t0 = time.perf_counter_ns()
        unknown = set(record) - _KINDS.keys()
        if unknown:
            raise ValueError(f"unknown wide-event columns: {sorted(unknown)}")
        with self._lock:
            slot = self._count % self.capacity
            for name, kind in COLUMNS:
                v = record.get(name)
                col = self._cols[name]
                if kind == "i":
                    col[slot] = _INT_NULL if v is None else int(v)
                elif kind == "f":
                    col[slot] = _FLOAT_NULL if v is None else float(v)
                elif kind == "s":
                    s = "" if v is None else str(v)
                    table = self._interns[name]
                    sid = table.get(s)
                    if sid is None:
                        sid = len(table)
                        table[s] = sid
                        self._rev_interns[name].append(s)
                    col[slot] = sid
                else:
                    col[slot] = v
            self._count += 1
            self._append_ns += time.perf_counter_ns() - t0

    # -- read side ----------------------------------------------------------

    def __len__(self) -> int:
        return min(self._count, self.capacity)

    def stats(self) -> dict:
        """Counters for healthz/debugz: total appends, live rows,
        overwritten rows, and measured mean append cost in ns."""
        with self._lock:
            n = self._count
            ns = self._append_ns
        return {
            "capacity": self.capacity,
            "appended": n,
            "rows": min(n, self.capacity),
            "overwritten": max(0, n - self.capacity),
            "append_ns_total": ns,
            "append_ns_mean": (ns / n if n else 0.0),
        }

    def _row_order(self) -> range:
        """Live slot indices oldest → newest (call under the lock)."""
        n = self._count
        if n <= self.capacity:
            return range(n)
        start = n % self.capacity
        # Oldest live row sits at the next overwrite slot.
        return range(start, start + self.capacity)

    def _cell(self, name: str, kind: str, slot: int):
        v = self._cols[name][slot % self.capacity]
        if kind == "i":
            return None if v == _INT_NULL else int(v)
        if kind == "f":
            return None if math.isnan(v) else float(v)
        if kind == "s":
            return self._rev_interns[name][v]
        return v

    def tail(self, n: int = 50) -> list[dict]:
        """The most recent ``n`` events as row dicts (newest LAST) —
        the export format flight-recorder dumps and crash last-words
        embed. Null cells are omitted, not emitted as None."""
        with self._lock:
            order = list(self._row_order())[-max(0, int(n)):]
            out = []
            for slot in order:
                row = {}
                for name, kind in COLUMNS:
                    v = self._cell(name, kind, slot)
                    if v is not None and v != "":
                        row[name] = v
                out.append(row)
        return out

    def query(self, where=None, group_by=None, aggs=None,
              max_groups: int = 64) -> dict:
        """One-scan filter / group / aggregate over the live ring.

        ``where``: term strings (see :func:`parse_where`) or pre-parsed
        triples. ``group_by``: ≤2 column names. ``aggs``: spec strings
        (see :func:`parse_aggs`) or pre-parsed triples. Distinct group
        keys beyond ``max_groups`` fold into one ``__other__`` bucket
        (first-seen keys win — scan order is oldest-first, so the fold
        is deterministic for a deterministic event order) and the
        result says how many keys were folded.

        Returns ``{"matched", "scanned", "group_by", "aggs",
        "groups": [{"key", "count", "aggs": {spec: payload}}]}`` where
        each pX payload carries its histogram ``state()`` on the shared
        :data:`WIDE_HIST_BUCKETS` layout — the mergeable part — plus
        the locally computed ``"value"``.
        """
        filt = (parse_where(where)
                if where and isinstance(where[0], str) else list(where or ()))
        group_by = list(group_by or ())
        if len(group_by) > 2:
            raise ValueError(
                f"group_by is capped at 2 columns, got {len(group_by)}")
        for col in group_by:
            if col not in _KINDS:
                raise ValueError(f"unknown column {col!r}")
            if _KINDS[col] == "f":
                raise ValueError(
                    f"cannot group by float column {col!r}")
        parsed_aggs = (parse_aggs(aggs)
                       if not aggs or isinstance(aggs[0], str)
                       else list(aggs))
        if max_groups < 1:
            raise ValueError(f"max_groups must be >= 1, got {max_groups}")

        groups: dict[tuple, _GroupAcc] = {}
        other: _GroupAcc | None = None
        folded_keys: set[tuple] = set()
        matched = scanned = 0
        with self._lock:
            for slot in self._row_order():
                scanned += 1
                ok = True
                for col, op, val in filt:
                    v = self._cell(col, _KINDS[col], slot)
                    if v is None:
                        ok = False
                        break
                    if op == "=":
                        ok = (v == val)
                    elif op == "!=":
                        ok = (v != val)
                    elif op == ">":
                        ok = v > val
                    elif op == "<":
                        ok = v < val
                    elif op == ">=":
                        ok = v >= val
                    else:
                        ok = v <= val
                    if not ok:
                        break
                if not ok:
                    continue
                matched += 1
                key = tuple(self._cell(c, _KINDS[c], slot)
                            for c in group_by)
                acc = groups.get(key)
                if acc is None:
                    if len(groups) < max_groups:
                        acc = groups[key] = _GroupAcc(parsed_aggs)
                    else:
                        folded_keys.add(key)
                        if other is None:
                            other = _GroupAcc(parsed_aggs)
                        acc = other
                acc.count += 1
                trace_id = self._cols["trace_id"][slot % self.capacity]
                for col, pair in acc.sums.items():
                    v = self._cell(col, _KINDS[col], slot)
                    if v is not None:
                        pair[0] += float(v)
                        pair[1] += 1
                for col, hist in acc.hists.items():
                    v = self._cell(col, _KINDS[col], slot)
                    if v is not None:
                        hist.observe(float(v), exemplar=trace_id)

        agg_keys = [_agg_key(*a) for a in parsed_aggs]
        out_groups = []
        items = list(groups.items())
        if other is not None:
            items.append((("__other__",) * max(1, len(group_by)), other))
        for key, acc in items:
            entry = {"key": dict(zip(group_by, key)) if group_by else {},
                     "count": acc.count, "aggs": {}}
            for (func, q, col), spec in zip(parsed_aggs, agg_keys):
                entry["aggs"][spec] = _finish_agg(func, q, col, acc)
            out_groups.append(entry)
        out_groups.sort(key=lambda g: (-g["count"], sorted(
            (str(k), str(v)) for k, v in g["key"].items())))
        return {
            "matched": matched,
            "scanned": scanned,
            "group_by": group_by,
            "aggs": agg_keys,
            "folded_groups": len(folded_keys),
            "groups": out_groups,
        }


def _finish_agg(func: str, q: float | None, col: str | None,
                acc: _GroupAcc) -> dict:
    """One agg payload: the computed value plus whatever mergeable
    state re-deriving it after a fleet merge needs."""
    if func == "count":
        return {"value": acc.count}
    if func in ("sum", "mean"):
        sm, n = acc.sums[col]
        value = (sm if func == "sum" else (sm / n if n else None))
        return {"value": value, "sum": sm, "n": n}
    state = acc.hists[col].state()
    value = (hist_state_percentile(state, q) if state["count"] else None)
    return {"value": value, "q": q, "state": state}


def merge_query_results(results) -> dict:
    """Fold per-replica ``query()`` results into one fleet result —
    THE code path the router's ``queryz`` fan-out uses, factored here
    so tests can assert router == this on the same inputs. Counts and
    sums add; pX aggregates merge their histogram states bucket-exactly
    via :func:`merge_hist_states` and recompute the percentile from the
    merged state, so the fleet value is exactly what one store holding
    every replica's events would have reported. Results must share
    group_by/aggs shape (they do, the router sends one spec to all)."""
    results = [r for r in results if r]
    if not results:
        raise ValueError("merge of zero query results")
    base = results[0]
    for r in results[1:]:
        if r.get("group_by") != base.get("group_by") or \
                r.get("aggs") != base.get("aggs"):
            raise ValueError("cannot merge query results of different shape")
    merged: dict[tuple, dict] = {}
    matched = scanned = folded = 0
    for r in results:
        matched += int(r.get("matched", 0))
        scanned += int(r.get("scanned", 0))
        folded += int(r.get("folded_groups", 0))
        for g in r.get("groups", ()):
            key = tuple(sorted(g["key"].items()))
            cur = merged.get(key)
            if cur is None:
                # Deep-ish copy so merging never mutates a caller's
                # payload (the router merges results it may also log).
                merged[key] = {
                    "key": dict(g["key"]),
                    "count": int(g["count"]),
                    "aggs": {spec: dict(p)
                             for spec, p in g["aggs"].items()},
                }
                continue
            cur["count"] += int(g["count"])
            for spec, payload in g["aggs"].items():
                tgt = cur["aggs"].get(spec)
                if tgt is None:
                    cur["aggs"][spec] = dict(payload)
                    continue
                if "state" in payload or "state" in tgt:
                    states = [s for s in (tgt.get("state"),
                                          payload.get("state")) if s]
                    tgt["state"] = merge_hist_states(*states)
                    tgt["q"] = payload.get("q", tgt.get("q"))
                elif "sum" in payload:
                    tgt["sum"] = float(tgt.get("sum", 0.0)) + \
                        float(payload["sum"])
                    tgt["n"] = int(tgt.get("n", 0)) + int(payload["n"])
                else:  # count
                    tgt["value"] = int(tgt.get("value", 0)) + \
                        int(payload["value"])
    for g in merged.values():
        for spec, payload in g["aggs"].items():
            if "state" in payload:
                st = payload["state"]
                payload["value"] = (
                    hist_state_percentile(st, float(payload["q"]))
                    if st and st["count"] else None)
            elif "sum" in payload:
                n = int(payload.get("n", 0))
                if spec.startswith("mean:"):
                    payload["value"] = (payload["sum"] / n if n else None)
                else:
                    payload["value"] = payload["sum"]
    groups = sorted(merged.values(),
                    key=lambda g: (-g["count"], sorted(
                        (str(k), str(v)) for k, v in g["key"].items())))
    return {
        "matched": matched,
        "scanned": scanned,
        "group_by": list(base.get("group_by") or ()),
        "aggs": list(base.get("aggs") or ()),
        "folded_groups": folded,
        "merged_from": len(results),
        "groups": groups,
    }
