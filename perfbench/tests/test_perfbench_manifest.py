"""The manifest keeps the benchmark's contract, and every file it names
loads by its name."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import manifest

M = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]
E2E = {m["name"]: m for m in M["end_to_end"]}


def _reports(metric: dict) -> list[str]:
    return metric.get("workloads", CELLS)


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and 1 <= len(M["command"]) <= 32
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_command_stays_inside_paths():
    for word in M["command"][1:]:
        if "/" in word:
            assert not word.startswith("/") and ".." not in word
            assert any(word.startswith(p + "/") for p in M["paths"])
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (manifest.ROOT / p).is_dir()


def test_names_and_units():
    names = ([c["name"] for c in M["configs"]] + CELLS + [m["name"] for m in M["end_to_end"]]
             + [m["name"] for m in M["per_layer"]])
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in M["workloads"]] + \
            [k for c in M["configs"] for k in c["reduced"]]:
        assert NAME.fullmatch(name), name
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_entries_have_only_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_bounds():
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_each_per_layer_metric_moves_one_metric_its_cells_report():
    for m in M["per_layer"]:
        moves = E2E[m["moves"]]
        for cell in _reports(m):
            assert cell in CELLS
            assert cell in _reports(moves), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in M["end_to_end"] if cell in _reports(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in _reports(m) for m in M["per_layer"])


def test_four_chip_cells_and_the_check_fit():
    fours = sum(w["chips"] == 4 for w in M["workloads"])
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    assert fours <= max(1, len(CELLS) // 4)
    # A full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    spec = manifest.cell(cell)
    entry = next(w for w in M["workloads"] if w["name"] == cell)
    assert spec["traffic"]["ranks"] == entry["chips"]
    assert set(spec["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    for value in spec["limits"].values():
        assert value is None or value > 0
    for m in spec["per_layer"]:
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_file_states_what_is_run(config):
    path = manifest.ROOT / config["file"]
    assert any(path.is_relative_to(manifest.ROOT / p) for p in M["paths"])
    cfg = json.loads(path.read_text())
    assert cfg["name"] == config["name"] and cfg["reduced"] == config["reduced"]
    widths = re.compile(r"(size|_dim|_rank|heads|inner|embd|intermediate)")
    for key in config["reduced"]:
        assert key in cfg and not widths.search(key), key
    # Every width and depth is the published one, under its published name.
    for key, published in PUBLISHED_NAMES.get(config["name"], {}).items():
        assert cfg[key] == cfg["published"][published], key
    assert cfg["hidden_size"] * 4 == cfg["intermediate_size"]


PUBLISHED_NAMES = {
    "bert_base": {k: k for k in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                                 "intermediate_size", "vocab_size", "max_position_embeddings",
                                 "hidden_dropout_prob", "initializer_range")},
    "gpt2_small": {"hidden_size": "n_embd", "num_hidden_layers": "n_layer",
                   "num_attention_heads": "n_head", "vocab_size": "vocab_size",
                   "max_position_embeddings": "n_positions", "hidden_dropout_prob": "resid_pdrop",
                   "initializer_range": "initializer_range"},
}
