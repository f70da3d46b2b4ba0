"""A run with the timed path broken underneath, or with the control in the
program's place, comes out not correct; a sound run at the same small size
comes out correct. The harness's look for a chip is skipped: the cells run
on the CPU at a small size, each number held to the cell's own limit. The
control runs on three seeds; the train cell's cameras are 224x400, where
its bf16 control reads its first loss several times over the limit (at
64x128 it does on four seeds of six)."""

import pytest

import tiny
from core import harness, registry

BENCH = registry.benchmark()
CONFIG = {w["name"]: w["config"] for w in BENCH["workloads"]}

SEEDS = (2**31 + 77, 2**31 + 78, 2**31 + 79)
CASES = [
    ("serve_base_closed32", ()),
    ("serve_base_closed32", ("answer_altered",)), ("serve_base_closed32", ("half_batch",)),
    ("eval_geometric_b4", ()), ("eval_geometric_b4", ("answer_altered",)), ("eval_geometric_b4", ("half_batch",)),
    ("train_base_b4", ()), ("train_base_b4", ("unchanged",)),
    ("train_base_b4", ("half_batch",)), ("train_base_b4", ("answer_altered",)),
]


CASES += [(cell, ("control",), seed) for cell in ("serve_base_closed32", "eval_geometric_b4", "train_base_b4")
          for seed in SEEDS]
CASES = [c if len(c) == 3 else c + (SEEDS[0],) for c in CASES]


@pytest.mark.parametrize("faults", [(), ("half_batch",)], ids=["sound", "half_batch"])
def test_poisson_arrivals(faults):
    """The serve driver's open loop, which no cell runs yet (see PERF.md)."""
    r = harness.run_cell("serve_base_closed32", SEEDS[0], 1.5, False, "cpu", config=tiny.config("bevfusion_base"),
                         traffic=dict(tiny.TRAFFIC, arrivals="poisson"), faults=faults)
    assert r["correct"] is (not faults), r["checks"]
    assert r["attempted"] == round(tiny.TRAFFIC["rate"] * 1.5) and "serve_samples_per_s" in r["metrics"]


@pytest.mark.parametrize("cell,faults,seed", CASES, ids=[f"{c}-{'+'.join(f) or 'sound'}-{s}" for c, f, s in CASES])
def test_correct_only_when_sound(cell, faults, seed):
    image_hw = (224, 400) if cell.startswith("train") else (64, 128)
    r = harness.run_cell(cell, seed, 1.5, False, "cpu", config=tiny.config(CONFIG[cell], image_hw),
                         traffic=tiny.TRAFFIC, faults=faults)
    assert r["correct"] is (not faults), r["checks"]
