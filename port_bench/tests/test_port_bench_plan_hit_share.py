"""`plan_hit_share.eval`: the share of the plan arrays the eval step read
from its device cache. Its arithmetic on made-up spans, none from a program
without spans or without the attribute, and 100 in a traced run of the
geometric eval cell on the CPU, whose batches share one calibration's
plans and whose warm-up fills the cache."""

import importlib
import sys

import pytest

import tiny
from core import harness, registry

PROFILING = "bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling"
METRIC = "plan_hit_share.eval"


def _inputs(**attrs):
    return {"name": "eval.inputs", "thread": "t", "parent": None, "attrs": dict(h2d_bytes=1000, **attrs),
            "start_ns": 10**9, "end_ns": 2 * 10**9, "device_ms": None}


@pytest.mark.parametrize("made,want", [
    ([_inputs(plan_hits=1.0), _inputs(plan_hits=1.0), _inputs(plan_hits=0.0), _inputs(plan_hits=0.5)], 62.5),
    ([_inputs(), _inputs()], None),  # a program whose spans carry no `plan_hits`
    ([], None),
], ids=["mixed", "no_attribute", "no_spans"])
def test_plan_hit_share_arithmetic(monkeypatch, made, want):
    monkeypatch.setattr(importlib.import_module(PROFILING), "recorded_spans", lambda: made)
    got = registry.reader(METRIC).read(None, {})
    assert got == (pytest.approx(want) if want is not None else None)


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, PROFILING, None)  # the import fails, as a program without spans
    assert registry.reader(METRIC).read(None, {}) is None


def test_reads_full_in_the_geometric_eval_cell_on_the_cpu():
    r = harness.run_cell("eval_geometric_b4", 2**31 + 87, 6.0, True, "cpu",
                         config=tiny.config("bevfusion_geometric"), traffic=tiny.TRAFFIC)
    assert r["metrics"][METRIC] == {"value": 100.0, "unit": "%"}
