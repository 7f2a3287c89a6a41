"""The benchmark's manifest, ``BENCHMARK.json``, and the files it names.

A cell names a configuration (``configs[].file``), a traffic mix
(``perfbench/traffic/<traffic>.json``) and its limits
(``perfbench/limits/<cell>.json``); a per-layer metric is read by
``perfbench/metrics/<metric>.py``. Each is found by its name, so a later
cell, mix or metric comes as new files and new manifest entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell's run needs: its manifest entry, configuration,
    traffic mix, limits, and the metrics it reports."""
    manifest = load(root)
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        known = ", ".join(w["name"] for w in manifest["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    entry = entries[0]
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return {
        "name": name,
        "chips": entry["chips"],
        "config": _json(root / config["file"]),
        "traffic": _json(HERE / "traffic" / f"{entry['traffic']}.json"),
        "limits": _json(HERE / "limits" / f"{name}.json"),
        "end_to_end": [m for m in manifest["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in manifest["per_layer"] if _applies(m, name)],
    }


def reader(metric: str):
    """The ``read(trace) -> float | None`` of ``perfbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
