"""``BENCHMARK.json`` and the files it names: the contract's keys, names
and units, every cell's files found by name, and what each cell reports."""

from __future__ import annotations

import json
import math
import re

import pytest

from benchmark.lib import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.manifest()
CELLS = [w["name"] for w in M["workloads"]]


def one_line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_check_of_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in M["configs"]] + CELLS + [
        m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]:
        assert NAME.match(n), n
    for c in M["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_entry_keys_and_lines():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


def test_four_chip_cells_are_few():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(len(M["workloads"]) * 0.25))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = manifest.cell(cell)
    config = manifest.config(c["config"])
    assert config["name"] == c["config"]
    entry = next(x for x in M["configs"] if x["name"] == c["config"])
    assert entry["file"] == f"benchmark/configs/{c['config']}.json"
    assert all(k in config for k in entry["reduced"]) and config["reduced"] == entry["reduced"]
    traffic = manifest.traffic(c["traffic"])
    assert hasattr(manifest.driver(traffic["driver"]), "run")
    for name, value in c.get("limits", {}).items():
        assert value is None or value > 0, name


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    e2e = [m["name"] for m in manifest.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    traffic = manifest.traffic(manifest.cell(cell)["traffic"])
    assert traffic["rate_metric"] in e2e
    layer = manifest.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(manifest.reader(m["name"]))


def test_layers_named_alike():
    by_metric = {}
    for m in M["per_layer"]:
        by_metric.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for w in m.get("workloads", []):
            assert w in CELLS
    assert all(len(v) == 1 for v in by_metric.values()), by_metric


def test_paths_hold_only_the_benchmark():
    files = [p for p in (manifest.BENCH_DIR).rglob("*") if p.is_file()
             and "__pycache__" not in p.parts]
    for p in files:
        rel = p.relative_to(manifest.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
    json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
