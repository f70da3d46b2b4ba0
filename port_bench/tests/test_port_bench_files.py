"""Every cell, configuration, driver and metric of BENCHMARK.json is found
by name, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from core import registry
from reference.model import Spec, variable_shapes

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    entry = registry.cell_entry(BENCH, cell)
    wl = registry.workload(cell)
    assert NAME.match(cell) and NAME.match(entry["traffic"]) and entry["chips"] == 1
    assert len(entry["why"]) <= 200
    assert hasattr(registry.driver(wl["driver"]), "run")
    assert all(v is not None for v in wl["limits"].values()), "every compared number has its limit"
    cfg = registry.config(BENCH, entry["config"])
    assert variable_shapes(Spec(cfg))
    names = [m["name"] for m in registry.end_to_end(BENCH, cell)]
    assert "setup_s" in names and len(names) >= 2
    assert registry.per_layer(BENCH, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(registry.reader(metric).read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert NAME.match(metric) and UNIT.match(m["unit"])
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_metrics_and_configs_keep_to_the_contract():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("port_bench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
