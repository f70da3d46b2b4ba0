"""Tracing and timing hooks.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/utils/profiling.py``:

- `profile_trace(logdir)`: a context manager around `torch.profiler` (CPU
  activity of every thread, and CUDA activity where a card is present) that
  writes a ``*.pt.trace.json`` under `logdir`, which TensorBoard's profiler
  plugin and Chrome's trace viewer load;
- `trace_summary(path)`: from such a trace, the traced window, the union of
  the device kernels' intervals, the device idle share
  1 - union / window, and the device operations with the most time;
- `device_memory_stats()`: per CUDA device, the bytes in use, their peak
  and the device's memory; an empty dict without a CUDA device.

And the port's own spans, at the layer boundaries of the server, the eval
step and the train step:

- `span(name, device=False, **attrs)`: a context manager that records only
  while a `torch.profiler` profile is active in the process. Then it stamps
  its edges with `time.time_ns()` (the clock of an exported Chrome trace:
  an event's ``ts`` plus the file's ``baseTimeNanoseconds``), keeps its
  name, thread, parent span on that thread and attributes in a bounded
  buffer, and opens `torch.profiler.record_function(name)`, so that a trace
  that sees the thread shows it as a ``user_annotation``. With `device` it
  also records a CUDA event on the current stream at each edge. With no
  profile active it costs one flag check and reads no clock;
- `model_span(name, like, **attrs)`: `span` inside the model (the camera
  encoder's ``camera.encode`` and the lift's ``camera.lift``), a device span
  on a CUDA tensor, skipped while `torch.compile` or `torch.export` traces;
- `recorded_spans()`: the spans of the latest profiled stretch (a stretch
  begins with the first span that records after one found the profiler
  off), with each device span's stream time, read once it is complete.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Deque, Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_BUFFER = 65536  # the most spans kept


class _Off:
    """What `span` gives while nothing profiles: it does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()
_spans: Deque["_Span"] = collections.deque(maxlen=SPAN_BUFFER)
_episode = 0  # the profiled stretch the buffer holds
_stretch_ended = True  # a span found the profiler off since the last recording one
_episode_lock = threading.Lock()
_threads = threading.local()  # .stack: this thread's open spans


class _Span:
    __slots__ = ("name", "attrs", "episode", "thread", "parent", "start_ns", "end_ns", "_events", "_record")

    def __init__(self, name: str, device: bool, attrs: Dict):
        global _episode, _stretch_ended
        if _stretch_ended:
            with _episode_lock:
                if _stretch_ended:
                    _spans.clear()
                    _episode += 1
                    _stretch_ended = False
        self.name, self.attrs, self.episode = name, attrs, _episode
        self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) if device else None

    def __enter__(self) -> "_Span":
        stack = _threads.__dict__.setdefault("stack", [])
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.thread = threading.current_thread().name
        # the clock is read outside record_function, whose first call in a
        # process spends ~1 ms after its own start stamp
        self.start_ns = time.time_ns()
        self._record = _autograd_profiler.record_function(self.name)
        self._record.__enter__()
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
        self._record.__exit__(*exc)
        self.end_ns = time.time_ns()
        _threads.stack.pop()
        _spans.append(self)
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, device: bool = False, **attrs):
    """A span named `name` with `attrs` (see the module docstring); `device`
    adds the CUDA stream time between its edges. Use as
    ``with span("serve.stage", batch=n) as s: ...; s.set(h2d_bytes=b)``."""
    global _stretch_ended
    if not _autograd_profiler._is_profiler_enabled:
        _stretch_ended = True
        return _OFF
    return _Span(name, device, attrs)


def model_span(name: str, like: torch.Tensor, **attrs):
    """A span inside the model: `span` with the CUDA stream time where
    `like` lies on a CUDA device; nothing at all while `torch.compile` or
    `torch.export` traces the model, so an exported program holds none."""
    if torch.compiler.is_compiling():
        return contextlib.nullcontext(_OFF)
    return span(name, device=like.is_cuda, **attrs)


def recorded_spans() -> List[Dict]:
    """The spans of the latest profiled stretch that have ended, by start:
    ``name``, ``thread``, ``parent`` (the enclosing span's name on that
    thread, or None), ``attrs``, ``start_ns`` and ``end_ns``
    (`time.time_ns`), and ``device_ms``, a device span's stream time (None
    for a host span), which waits for its end event."""
    out = []
    for s in tuple(_spans):
        if s.episode != _episode:
            continue
        device_ms = None
        if s._events is not None:
            s._events[1].synchronize()
            device_ms = s._events[0].elapsed_time(s._events[1])
        out.append({"name": s.name, "thread": s.thread, "parent": s.parent, "attrs": dict(s.attrs),
                    "start_ns": s.start_ns, "end_ns": s.end_ns, "device_ms": device_ms})
    return sorted(out, key=lambda d: d["start_ns"])


@contextlib.contextmanager
def profile_trace(logdir: str = "./logs/profile"):
    """Profile the block into a trace file under `logdir`, every thread's
    host events included (the loader's threads, the server's dispatch
    thread); torch.profiler records only the calling thread's by default."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir)),
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)):
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
