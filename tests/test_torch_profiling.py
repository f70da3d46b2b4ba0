"""The port's profiling hooks and kernel build cache against the JAX
package's (utils/profiling.py, utils/cache.py), and the port's spans.

- `span` with no profiler active reads no clock and calls neither
  `record_function` nor CUDA events; under a profiler it records its name,
  parent, thread and attributes, one profiled stretch at a time, and its
  `time_ns` edges line up with its `user_annotation` in the exported trace;
  a span on a thread started before the profiler is recorded, and under
  `profile_trace` (every thread) also written to the trace;
- `profile_trace` writes a Chrome/TensorBoard trace that `trace_summary`
  reads; `trace_summary`'s idle share is exact on a hand-made trace of
  overlapping kernels;
- `debug.profile: true` through the port's `train_detect.main` on a tiny
  tree leaves one trace under ``<log_dir>/profile``, which shows the train
  step's spans and the wait on the loader;
- `enable_compilation_cache(cache_dir)` moves the kernel build directory and
  builds nothing on a host without CUDA; `device_memory_stats()` is the JAX
  one's empty dict there.
"""

import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bevfusion_multimodal_3d_object_detection_tpu.utils import profiling as jax_profiling
from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import _build
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import cache as port_cache
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import profiling as port_profiling
from torch_trainer_helpers import tree_config, write_test_tree


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _trace_events(path, name):
    """(start_ns, end_ns) of the trace's `name` user annotations, on the
    trace's clock: ts (us) + the file's baseTimeNanoseconds."""
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    return sorted((base + round(e["ts"] * 1e3), base + round((e["ts"] + e["dur"]) * 1e3))
                  for e in trace["traceEvents"] if e.get("name") == name and e.get("cat") == "user_annotation")


def test_span_off_reads_no_clock_nor_profiler(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled

    def forbidden(*args, **kwargs):
        raise AssertionError("called with no profiler active")

    with monkeypatch.context() as m:
        for owner, name in ((time, "time_ns"), (time, "perf_counter"), (time, "perf_counter_ns"),
                            (time, "monotonic"), (torch.profiler, "record_function"),
                            (torch.autograd.profiler, "record_function"), (torch.cuda, "Event")):
            m.setattr(owner, name, forbidden)
        s = port_profiling.span("train.forward", device=True, batch=1)
        with s as inner:
            inner.set(h2d_bytes=10)
        assert port_profiling.span("other") is s  # one shared null span


def test_span_records_name_parent_attributes_and_stretch():
    with port_profiling.span("before"):  # off: the next recording span starts a stretch
        pass
    with _profiled():
        with port_profiling.span("outer", batch=3) as outer:
            with port_profiling.span("inner", device=False):
                pass
            outer.set(h2d_bytes=12)
        with port_profiling.span("after"):
            pass
    got = port_profiling.recorded_spans()
    assert [(s["name"], s["parent"]) for s in got] == [("outer", None), ("inner", "outer"), ("after", None)]
    assert got[0]["attrs"] == {"batch": 3, "h2d_bytes": 12} and got[1]["attrs"] == {}
    assert all(s["thread"] == threading.current_thread().name and s["device_ms"] is None for s in got)
    assert got[0]["start_ns"] <= got[1]["start_ns"] <= got[1]["end_ns"] <= got[0]["end_ns"] <= got[2]["start_ns"]
    assert port_profiling.recorded_spans() == got  # read again after the profiler stopped
    port_profiling.span("between")  # found off
    with _profiled():
        with port_profiling.span("second"):
            pass
    assert [s["name"] for s in port_profiling.recorded_spans()] == ["second"]


def test_span_edges_line_up_with_the_trace(tmp_path):
    with _profiled() as prof:
        for i in range(5):
            with port_profiling.span("edge.check", i=i):
                torch.ones(64).add_(1)
                time.sleep(0.002)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    ours = [(s["start_ns"], s["end_ns"]) for s in port_profiling.recorded_spans() if s["name"] == "edge.check"]
    theirs = _trace_events(path, "edge.check")
    assert len(ours) == len(theirs) == 5
    for (a0, a1), (b0, b1) in zip(ours, theirs):
        assert abs(a0 - b0) < 1e6 and abs(a1 - b1) < 1e6, (a0 - b0, a1 - b1)


class _Worker:
    """A thread started before any profiler that, while one is active, runs
    `loader.fetch` spans (as the loader's and the server's threads do)."""

    def __init__(self):
        self.stop, self.spans = threading.Event(), 0
        self.thread = threading.Thread(target=self._run, name="loader-like", daemon=True)
        self.thread.start()

    def _run(self):
        x = torch.zeros(8)
        while not self.stop.is_set():
            with port_profiling.span("loader.fetch") as s:
                x.add_(1)
                if s is not port_profiling._OFF:
                    self.spans += 1
            time.sleep(0.001)

    def until_recorded(self, n=3):
        deadline = time.monotonic() + 30
        while self.spans < n and time.monotonic() < deadline:
            time.sleep(0.005)
        assert self.spans >= n

    def close(self):
        self.stop.set()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def test_span_on_an_earlier_thread_is_recorded():
    worker = _Worker()
    try:
        with _profiled():  # sees only this thread's host events
            worker.until_recorded()
    finally:
        worker.close()
    got = [s for s in port_profiling.recorded_spans() if s["name"] == "loader.fetch"]
    assert got and {s["thread"] for s in got} == {"loader-like"}


def test_profile_trace_writes_every_threads_spans(tmp_path):
    worker = _Worker()
    try:
        with port_profiling.profile_trace(str(tmp_path / "prof")):
            worker.until_recorded()
            with port_profiling.span("main.step"):
                pass
    finally:
        worker.close()
    (path,) = port_profiling.trace_files(tmp_path / "prof")
    assert _trace_events(path, "loader.fetch") and _trace_events(path, "main.step")


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
    for name in ("train.next_batch", "train.inputs", "train.forward", "train.backward", "train.optimizer"):
        assert _trace_events(files[0], name), name


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
