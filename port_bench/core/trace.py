"""A profiled sub-window and the arithmetic on its trace.

`Profiler` records CPU and CUDA activity with `torch.profiler` between
`start()` and `stop()` and exports a Chrome trace; `summarize` reduces it:

- ``window_s``: from the first to the last event of the trace;
- ``busy_s``: the union of the device kernels' intervals (the copy of
  ``utils/profiling.py:trace_summary``'s rule: 1 - busy / window is the
  device's idle share);
- ``kernels``: for each group of kernel names in `KERNELS`, the summed
  device seconds of all its kernels and the durations of its main kernels
  (one a launch);
- ``device_ops``: the ten kernel names with the most device time;
- ``idle_gaps``: the ten longest gaps between kernels, each named by the
  innermost host event (operator or CUDA runtime call) that spans the
  gap's middle.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

# kernel groups by the names the program gives its hand-written kernels
# (a launch's main kernel first, then the kernels that finish it)
KERNELS = {
    "b1": ("pointnet_tile_kernel", "pointnet_f32_kernel", "reduce_tiles_kernel"),
    "b2": ("slice_kernel", "sorted_kernel", "combine_kernel"),
}
MAIN = {"b1": ("pointnet_tile_kernel", "pointnet_f32_kernel"), "b2": ("slice_kernel", "sorted_kernel")}
DEVICE_CATS = ("kernel",)
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "cuda_driver")


class Profiler:
    """`start()` and `stop()` the collection; `export()` writes the trace."""

    def __init__(self, out_dir: Path):
        self.out_dir = Path(out_dir)
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def export(self) -> Path:
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"trace_{os.getpid()}.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        return path


def union(intervals: Sequence[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def _group(name: str):
    for group, names in KERNELS.items():
        if any(n in name for n in names):
            return group
    return None


def summarize(events: List[Dict], top: int = 10) -> Dict:
    """The sub-window's numbers from a Chrome trace's event list (times in
    microseconds, as torch.profiler writes them)."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not timed:
        raise ValueError("the trace holds no timed events")
    kernels = [e for e in timed if e.get("cat") in DEVICE_CATS]
    t0 = min(e["ts"] for e in timed)
    t1 = max(e["ts"] + e["dur"] for e in timed)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy = union(spans)
    by_name: Dict[str, float] = {}
    groups: Dict[str, List] = {g: [] for g in KERNELS}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        g = _group(e["name"])
        if g is not None:
            groups[g].append((e["dur"] / 1e6, any(n in e["name"] for n in MAIN[g])))
    # gaps between merged kernel intervals
    gaps, end = [], None
    for start, stop in spans:
        if end is not None and start > end:
            gaps.append((start - end, end, start))
        end = stop if end is None else max(end, stop)
    gaps.sort(reverse=True)
    host = [e for e in timed if e.get("cat") in HOST_CATS]
    named_gaps = []
    for length, a, b in gaps[:top]:
        mid = (a + b) / 2
        spanning = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = min(spanning, key=lambda e: e["dur"])["name"] if spanning else "host, outside torch"
        named_gaps.append([name, length / 1e6])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": {g: {"seconds": sum(d for d, _ in ev), "main": [d for d, main in ev if main]}
                    for g, ev in groups.items()},
        "device_ops": [[name, dur / 1e6] for name, dur in ranked],
        "idle_gaps": named_gaps,
        "n_kernels": len(kernels),
    }


def summarize_file(path: Path, top: int = 10) -> Dict:
    events = json.loads(Path(path).read_text())["traceEvents"]
    return summarize(events, top)
