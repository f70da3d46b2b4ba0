"""Tracing and timing hooks.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/utils/profiling.py``:

- `profile_trace(logdir)`: a context manager around `torch.profiler` (CPU
  activity, and CUDA activity where a card is present) that writes a
  ``*.pt.trace.json`` under `logdir`, which TensorBoard's profiler plugin
  and Chrome's trace viewer load;
- `trace_summary(path)`: from such a trace, the traced window, the union of
  the device kernels' intervals, the device idle share
  1 - union / window, and the device operations with the most time;
- `StepTimer`: wall-clock step timing with warm-up steps left out and a
  percentile summary (the same rule and keys as the JAX one);
- `device_memory_stats()`: per CUDA device, the bytes in use, their peak
  and the device's memory; an empty dict without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: str = "./logs/profile"):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


def trace_files(logdir) -> List[Path]:
    """The trace files `profile_trace` wrote under `logdir`, oldest first."""
    return sorted(Path(logdir).glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def trace_summary(path, top: int = 5) -> Dict:
    """Device idle share and busiest device operations of one trace file:
    `window_ms` spans every event of the trace, `busy_ms` is the union of
    the "kernel" events' intervals (the device's kernels), `idle_share` is
    1 - busy / window, and `top` lists (name, total ms, count) of the
    kernels with the most time."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no timed events")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    by_name: Dict[str, List[float]] = {}
    for e in kernels:
        by_name.setdefault(e["name"], []).append(e["dur"])
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    window = t1 - t0
    return {
        "window_ms": window / 1e3,
        "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window if window > 0 else 1.0,
        "kernels": len(kernels),
        "top": [(name, sum(d) / 1e3, len(d)) for name, d in ranked],
    }


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self, batch_size: int = 1) -> Dict[str, float]:
        import numpy as np

        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "mean_latency_ms": float(t.mean() * 1e3),
            "p50_latency_ms": float(np.percentile(t, 50) * 1e3),
            "p95_latency_ms": float(np.percentile(t, 95) * 1e3),
            "fps": float(batch_size / t.mean()),
            "steps": len(self.times),
        }


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:i": {bytes_in_use, peak_bytes_in_use, bytes_limit}} from the
    caching allocator's counts and the device's total memory; {} without a
    CUDA device (the JAX version's answer where a backend has no stats)."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
    return stats
