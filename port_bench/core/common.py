"""What the drivers share: the seeded weights, the reference's maps of a
set of samples, the decode's voxel, and the profiled sub-window."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from core import harness, inputs
from core.trace import Profiler, summarize_file
from reference import model as ref
from reference.decode import cell_table, peak_scores

TRACE_DIR = harness.BUILD / "traces"


def sample_tensors(samples: Sequence[Dict[str, np.ndarray]], device) -> tuple:
    """(cams uint8, lidar, radar) device tensors of a list of samples."""
    return tuple(torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
                 for k in ("camera_imgs", "lidar_points", "radar_points"))


def make_weights(ctx, calibration_samples, cells: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The run's variables: seeded draws on the device, then every running
    statistic set from one f32 reference pass over `calibration_samples`
    (the peak memory is reset after, so that the program's run sets it)."""
    spec, dev = ctx.spec, ctx.device
    variables = ref.make_variables(spec, inputs.generator(ctx.seed, 0, dev), dev)
    cams, lidar, radar = sample_tensors(calibration_samples, dev)
    ref.calibrate_statistics(spec, variables, ref.normalize_uint8(cams), lidar, radar, cells)
    del cams, lidar, radar
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return variables


def reference_maps(spec, variables, samples: Sequence[Dict[str, np.ndarray]], device, precision: str = "f32",
                   cells: Optional[torch.Tensor] = None, block: int = 4) -> List[Dict[str, torch.Tensor]]:
    """The reference's maps of each sample, in blocks of `block` samples."""
    out = []
    with torch.no_grad(), ref.exact_float32():
        for i in range(0, len(samples), block):
            cams, lidar, radar = sample_tensors(samples[i:i + block], device)
            maps = ref.Forward(spec, variables, precision=precision)(ref.normalize_uint8(cams), lidar, radar, cells)
            out.extend({k: v[j].float() for k, v in maps.items()} for j in range(cams.shape[0]))
    return out


def decoded(maps: Dict[str, torch.Tensor], k: int, voxel: float, pc_range, threshold: float) -> Dict[str, np.ndarray]:
    """The detections the decode gives from one sample's maps: the top K
    peaks above `threshold`, as a served result."""
    table = cell_table(maps, voxel, pc_range)
    c = table["score"].shape[1]
    top = torch.topk(peak_scores(maps["heatmap"].float()), k)
    keep = top.values > threshold
    cell = (top.indices // c)[keep]
    boxes = torch.cat([table["pos"][cell], table["size"][cell], table["yaw"][cell, None], table["vel"][cell]], -1)
    return {"boxes": boxes.cpu().numpy(), "scores": top.values[keep].cpu().numpy(),
            "labels": np.zeros(int(keep.sum()), np.int64)}


def decode_voxel(config: Dict) -> float:
    """The serving and evaluation decode's voxel: 0.512 under quirk Q3."""
    if (config.get("compat") or {}).get("eval_decode_voxel_0512", True):
        return 0.512
    raise ValueError("the benchmark's decode comparison takes the Q3 voxel only")


class SubWindow:
    """A profiled stretch of the window: `begin()` and `end()` on the host
    clock with the profiler on between them (when tracing), and the trace's
    summary after the window, by `summary()`."""

    def __init__(self, tracing: bool):
        self.profiler = Profiler(TRACE_DIR) if tracing else None
        self.t0 = self.t1 = None

    def begin(self) -> None:
        if self.profiler is not None:
            self.profiler.start()
        self.t0 = time.perf_counter()

    def end(self) -> None:
        self.t1 = time.perf_counter()
        if self.profiler is not None:
            self.profiler.stop()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def summary(self) -> Optional[Dict]:
        if self.profiler is None or self.t1 is None:
            return None
        path = self.profiler.export()
        try:
            return summarize_file(path)
        finally:
            path.unlink(missing_ok=True)
