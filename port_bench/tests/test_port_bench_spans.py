"""The per-layer metrics read from the program's spans: their arithmetic on
made-up spans, None from a program without spans, and in a traced run of
each cell at a small size on the CPU, a reading in the cells their
`workloads` name and none elsewhere (the stream times read None on the CPU,
which has no CUDA events)."""

import sys

import pytest

import tiny
from core import harness, registry, spans

BENCH = registry.benchmark()
CONFIG = {w["name"]: w["config"] for w in BENCH["workloads"]}
SPAN_METRICS = {"stage_ms.serve", "queue_wait_ms.serve", "inputs_ms.eval", "h2d_mb.eval", "inputs_ms.train",
                "forward_ms.train", "backward_ms.train", "optimizer_ms.train"}
PROFILING = "bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling"


def _span(name, ms, device_ms=None, **attrs):
    return {"name": name, "thread": "t", "parent": None, "attrs": attrs, "start_ns": 10**9,
            "end_ns": 10**9 + round(ms * 1e6), "device_ms": device_ms}


def test_span_arithmetic(monkeypatch):
    import importlib

    made = [_span("serve.stage", 30.0, requests=8, queue_wait_s=0.8, h2d_bytes=5_000_000),
            _span("serve.stage", 40.0, requests=2, queue_wait_s=0.1, h2d_bytes=5_000_000),
            _span("train.forward", 1.0, device_ms=20.0), _span("train.forward", 1.0, device_ms=24.0)]
    monkeypatch.setattr(importlib.import_module(PROFILING), "recorded_spans", lambda: made)
    assert spans.mean_ms("serve.stage") == pytest.approx(35.0)
    assert spans.attr_ratio("serve.stage", "queue_wait_s", "requests", 1e3) == pytest.approx(90.0)
    assert spans.mean_attr("serve.stage", "h2d_bytes", 1e-6) == pytest.approx(5.0)
    assert spans.mean_device_ms("train.forward") == pytest.approx(22.0)
    assert spans.mean_ms("eval.inputs") is None and spans.mean_device_ms("serve.stage") is None
    want = {"stage_ms.serve": 35.0, "queue_wait_ms.serve": 90.0, "forward_ms.train": 22.0}
    for name in SPAN_METRICS:
        value = registry.reader(name).read(None, {})
        assert value == (pytest.approx(want[name]) if name in want else None), name


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, PROFILING, None)  # the import fails, as the parent's would
    assert all(registry.reader(name).read(None, {}) is None for name in SPAN_METRICS)


@pytest.mark.parametrize("cell", sorted(CONFIG))
def test_traced_cell_reads_its_span_metrics(cell):
    r = harness.run_cell(cell, 2**31 + 81, 6.0, True, "cpu", config=tiny.config(CONFIG[cell]), traffic=tiny.TRAFFIC)
    mine = {m["name"] for m in BENCH["per_layer"] if m["name"] in SPAN_METRICS and cell in m["workloads"]}
    host = {m["name"] for m in BENCH["per_layer"] if m["name"] in mine and m["source"] == "host_clock"}
    read = SPAN_METRICS & set(r["metrics"])
    assert mine and host <= read <= mine, (cell, read)
    assert all(r["metrics"][name]["value"] > 0 for name in read)
