"""The port's profiling hooks and kernel build cache against the JAX
package's (utils/profiling.py, utils/cache.py).

- `StepTimer.summary` equals the JAX one exactly on the same stepped clock
  (the same numpy arithmetic on the same values);
- `profile_trace` writes a Chrome/TensorBoard trace that `trace_summary`
  reads; `trace_summary`'s idle share is exact on a hand-made trace of
  overlapping kernels;
- `debug.profile: true` through the port's `train_detect.main` on a tiny
  tree leaves one trace under ``<log_dir>/profile``;
- `enable_compilation_cache(cache_dir)` moves the kernel build directory and
  builds nothing on a host without CUDA; `device_memory_stats()` is the JAX
  one's empty dict there.
"""

import json
import time

import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.utils import profiling as jax_profiling
from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import _build
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import cache as port_cache
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import profiling as port_profiling
from torch_trainer_helpers import tree_config, write_test_tree


@pytest.mark.parametrize("warmup,steps", [(2, 7), (0, 3), (3, 3)])
def test_step_timer_matches_jax(monkeypatch, warmup, steps):
    durations = np.random.RandomState(warmup + steps).uniform(0.001, 0.05, steps)

    def run(module):
        ticks = iter(np.cumsum(np.stack([np.full(steps, 1.0), durations], 1).ravel()).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer(warmup=warmup)
        for _ in range(steps):
            with timer:
                pass
        return timer.summary(batch_size=4)

    got, want = run(port_profiling), run(jax_profiling)
    assert got == want
    assert got == {} if steps <= warmup else got["steps"] == steps - warmup


def test_profile_trace_writes_a_trace(tmp_path):
    with port_profiling.profile_trace(str(tmp_path / "prof")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = port_profiling.trace_files(tmp_path / "prof")
    assert len(files) == 1
    summary = port_profiling.trace_summary(files[0])
    assert summary["window_ms"] > 0 and summary["kernels"] == 0 and summary["idle_share"] == 1.0


def test_trace_summary_idle_share(tmp_path):
    """Kernels at [10, 30), [20, 40) and [60, 70) us in a [0, 100) us
    window: busy 40 us, idle share 0.6."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "relu", "ts": 60, "dur": 10},
              {"ph": "i", "name": "marker", "ts": 500}]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = port_profiling.trace_summary(path)
    assert s["window_ms"] == 0.1 and s["busy_ms"] == 0.04 and s["kernels"] == 3
    assert s["idle_share"] == pytest.approx(0.6, abs=1e-12)
    assert s["top"] == [("gemm", 0.04, 2), ("relu", 0.01, 1)]


def test_debug_profile_traces_the_first_epoch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data = write_test_tree(tmp_path / "data", samples_per_split=2, n_points=200)
    cfg = tree_config(tmp_path, data, modality="camera+radar")
    cfg.setdefault("debug", {})["profile"] = True
    train_detect.main(config=cfg, device="cpu")
    files = port_profiling.trace_files(tmp_path / "logs" / "profile")
    assert len(files) == 1
    assert port_profiling.trace_summary(files[0])["window_ms"] > 0


def test_compilation_cache_moves_the_build_without_building(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored after the test

    def no_build(*names):
        raise AssertionError("built on a host without CUDA")

    monkeypatch.setattr(_build, "build", no_build)
    assert port_cache.enable_compilation_cache() == _build.BUILD_DIR
    target = tmp_path / "kernels"
    assert port_cache.enable_compilation_cache(str(target)) == target
    assert _build.BUILD_DIR == target and _build.library_path("bev_pool") == target / "libbev_pool.so"
    assert not target.exists()
    assert port_profiling.device_memory_stats() == jax_profiling.device_memory_stats() == {}
