"""One run of one cell: the context a driver gets, and the result line.

A driver builds the system under test from the seed, warms it up, calls
`Context.window_opens()` as its first timed request or step goes out, runs
for `seconds`, reads the device memory peak, frees the program's state and
returns an `Outcome`. Its ``check`` is called after that: it runs the
reference and returns the numbers that decide `correct`, which are held to
the limits in the cell's workload file.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from core import registry
from core.compare import verdict
from reference.model import Spec

BUILD = registry.ROOT / "build" / "port_bench"


IMPORTED = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started, from /proc; where /proc cannot
    say, since this module was imported."""
    try:
        start_ticks = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - IMPORTED


@dataclasses.dataclass
class Context:
    cell: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    faults: tuple = ()
    window_start: Optional[float] = None
    setup: Optional[float] = None

    @property
    def spec(self) -> Spec:
        return Spec(self.config)

    @property
    def traffic(self) -> Dict:
        return self.workload["traffic"]

    def window_opens(self) -> float:
        """Marks the set-up's end (process start to the first timed request
        or step) and returns the window's start on the host clock."""
        self.setup = process_age_s()
        self.window_start = time.perf_counter()
        return self.window_start

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    layer_data: Dict
    check: Callable[[], Dict[str, float]]
    trace: Optional[Dict] = None


def jax_tree(variables: Dict[str, torch.Tensor]) -> Dict:
    """Flat ``"<collection>/<path>"`` tensors -> the nested numpy tree the
    program loads (``{"params": ..., "batch_stats": ...}``)."""
    tree: Dict = {}
    for name, t in variables.items():
        node = tree
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda", config: Optional[Dict] = None,
             faults: tuple = (), bench: Optional[Dict] = None, traffic: Optional[Dict] = None,
             limits: Optional[Dict] = None) -> Dict:
    """Run `cell` once and return its result dict (the keys of the result
    line, ``checks`` last). `config`, `traffic` and `limits` replace or
    update the cell's own (the harness's tests at a small size); `faults`
    breaks the timed path or puts the control in its place."""
    bench = bench or registry.benchmark()
    wl, entry = registry.workload(cell), registry.cell_entry(bench, cell)
    wl["traffic"].update(traffic or {})
    wl["limits"].update(limits or {})
    cfg = config if config is not None else registry.config(bench, entry["config"])
    ctx = Context(cell, wl, cfg, int(seed), float(seconds), bool(trace), torch.device(device), tuple(faults))
    outcome = registry.driver(wl["driver"]).run(ctx)
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in registry.end_to_end(bench, cell):
            value = ctx.setup if m["name"] == "setup_s" else outcome.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        data = dict(outcome.layer_data, trace=outcome.trace)
        for m in registry.per_layer(bench, cell):
            value = registry.reader(m["name"]).read(ctx, data)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    numbers = outcome.check()
    limits = wl.get("limits", {})
    device_info = {
        "platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
        "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
        "count": int(entry["chips"]),
        "memory_peak_bytes": outcome.memory_peak_bytes,
    }
    result = {
        "correct": verdict(numbers, limits) and outcome.failed == 0,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device_info,
    }
    if trace and outcome.trace is not None:
        device_info["busy_s"] = outcome.trace["busy_s"]
        device_info["window_s"] = outcome.trace["window_s"]
        result["breakdown"] = {"device_ops": outcome.trace["device_ops"],
                               "idle_gaps": outcome.trace["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limits.get(name)} for name, value in numbers.items()}
    return result


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "bevfusion_multimodal_3d_object_detection_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    names = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))

