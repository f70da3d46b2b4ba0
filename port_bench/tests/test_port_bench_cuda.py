"""One cell for 10 s on the GPU, through the command the driver runs."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_serve_cell_runs_correct_on_the_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "serve_base_closed32", "--seed",
                          "2147483659", "--seconds", "10", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert set(result["metrics"]) == {"serve_samples_per_s", "setup_s"}
