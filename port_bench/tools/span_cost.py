"""What one of the program's spans (`utils/profiling.py:span`) costs, with
no profiler active and under one, in one process.

    python3 port_bench/tools/span_cost.py [--n 20000] [--device cuda|cpu]

Prints one JSON line: the µs a ``with span(...)`` block adds over an empty
block, taken as the median of 5 timed loops of `--n` blocks (a tenth of
that under the profiler), for a host span with two attributes, a span that
sets an attribute inside, and on CUDA a device span (two CUDA events on the
current stream); `record_function` alone with no profiler active, for
comparison; and the device's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def _loop_us(body, n: int, reps: int = 5) -> float:
    """Median over `reps` of the µs a call of `body` takes in a loop of `n`."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        times.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(times)


def measure(n: int, device: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling import recorded_spans, span

    def empty():
        pass

    def host():
        with span("cost.host", batch=1, requests=8):
            pass

    def host_set():
        with span("cost.set") as s:
            s.set(h2d_bytes=1)

    def device_span():
        with span("cost.device", device=True):
            pass

    def record_function():
        with torch.profiler.record_function("cost.rf"):
            pass

    cuda = device == "cuda"
    bodies = {"host": host, "host_set": host_set}
    if cuda:
        bodies["device"] = device_span
    out = {"n": n, "device": device}
    base = _loop_us(empty, n)
    out["off_us"] = {name: _loop_us(body, n) - base for name, body in bodies.items()}
    out["record_function_off_us"] = _loop_us(record_function, n // 10) - base
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out["on_us"] = {}
    for name, body in bodies.items():
        span("cost.between")  # found off: each profile is a stretch of its own
        with profile(activities=activities):
            out["on_us"][name] = _loop_us(body, n // 10) - base
        if cuda:
            torch.cuda.synchronize()
        out.setdefault("recorded", {})[name] = len(recorded_spans())
    if cuda:
        out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True).stdout.strip()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.n, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
