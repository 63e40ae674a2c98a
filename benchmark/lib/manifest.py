"""Finds a cell's files by the names in ``BENCHMARK.json``.

- ``BENCHMARK.json`` at the checkout's root: the manifest;
- ``benchmark/workloads/<cell>.json``: the cell's configuration, traffic,
  chips and ``why`` (as in the manifest) and the limits of its comparison;
- ``benchmark/configs/<config>.json``: the model's sizes;
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters and the
  driver that runs it;
- ``benchmark/drivers/<driver>.py``: runs a cell;
- ``benchmark/metrics/<metric>.py``: reads one per-layer metric.

A new cell, configuration, traffic, driver or metric is a new file and a new
manifest entry; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The manifest's entry of cell ``name`` merged with its file, which
    must agree with the entry on every key they share."""
    entries = {w["name"]: w for w in manifest()["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry, own = entries[name], _json(BENCH_DIR / "workloads" / f"{name}.json")
    for key in set(entry) & set(own):
        if entry[key] != own[key]:
            raise SystemExit(f"workloads/{name}.json says {key}={own[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return {**own, **entry}


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return _load(BENCH_DIR / "drivers" / f"{name}.py", f"benchmark.drivers.{name}")


def per_layer(cell_name: str) -> list[dict]:
    """The manifest's per-layer metrics that cell ``cell_name`` reports."""
    return [m for m in manifest()["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]


def end_to_end(cell_name: str) -> list[dict]:
    return [m for m in manifest()["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """``benchmark/metrics/<metric>.py``'s ``read``."""
    safe = metric.replace(".", "_").replace("-", "_")
    return _load(BENCH_DIR / "metrics" / f"{metric}.py", f"benchmark.metrics.{safe}").read
