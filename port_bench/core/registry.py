"""Find a cell's files by name: its workload, its configuration, its
driver and the readers of its per-layer metrics.

- ``BENCHMARK.json`` (the checkout's root): the cell's end-to-end and
  per-layer metrics, and each configuration's file;
- ``port_bench/workloads/<cell>.json``: the driver's name, the traffic's
  parameters and the limits of the numbers that decide `correct`;
- ``port_bench/drivers/<driver>.py``: ``run(ctx) -> Outcome``;
- ``port_bench/metrics/<metric>.py``: ``read(ctx, data) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import yaml

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"port_bench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(name: str) -> Dict:
    return json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())


def cell_entry(bench: Dict, name: str) -> Dict:
    """The cell's entry in BENCHMARK.json: its configuration, traffic and chips."""
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return yaml.safe_load((root / entry["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def driver(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "drivers" / f"{name}.py")


def reader(metric: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py")


def _applies(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    names = [m["name"] for m in end_to_end(bench, cell)]
    return [m for m in bench["per_layer"] if _applies(m, cell, names)]
