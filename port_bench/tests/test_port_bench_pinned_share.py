"""`pinned_share.serve`: the share of `serve.stage` spans whose batch was
staged in page-locked memory. Its arithmetic on made-up spans, none from a
program without spans or without the attribute, and 0 in a traced run of
the serve cell on the CPU, where the server pins nothing."""

import importlib
import sys

import pytest

import tiny
from core import harness, registry

PROFILING = "bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling"
METRIC = "pinned_share.serve"


def _stage(**attrs):
    return {"name": "serve.stage", "thread": "t", "parent": None, "attrs": dict(requests=8, **attrs),
            "start_ns": 10**9, "end_ns": 2 * 10**9, "device_ms": None}


@pytest.mark.parametrize("made,want", [
    ([_stage(pinned=1), _stage(pinned=1), _stage(pinned=0), _stage(pinned=1)], 75.0),
    ([_stage(), _stage()], None),  # a program whose spans carry no `pinned`
    ([], None),
], ids=["three_of_four", "no_attribute", "no_spans"])
def test_pinned_share_arithmetic(monkeypatch, made, want):
    monkeypatch.setattr(importlib.import_module(PROFILING), "recorded_spans", lambda: made)
    got = registry.reader(METRIC).read(None, {})
    assert got == (pytest.approx(want) if want is not None else None)


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, PROFILING, None)  # the import fails, as a program without spans
    assert registry.reader(METRIC).read(None, {}) is None


def test_reads_zero_on_the_cpu():
    r = harness.run_cell("serve_base_closed32", 2**31 + 83, 3.0, True, "cpu", config=tiny.config("bevfusion_base"),
                         traffic=tiny.TRAFFIC)
    assert r["metrics"][METRIC] == {"value": 0.0, "unit": "%"}
