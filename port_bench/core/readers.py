"""The arithmetic of the per-layer metrics, which the files under
``port_bench/metrics/`` apply to one cell's data. Each returns None where
it finds nothing to read; shares are in percent."""

from __future__ import annotations

from typing import Dict, Optional

from core.counts import PEAK_BYTES_PER_S, PEAK_FLOPS


def mfu(data: Dict, peak: str) -> Optional[float]:
    """The model's operations in the profiled sub-window over the
    sub-window's host-clock length times the peak."""
    flops, seconds = data.get("model_flops"), data.get("sub_window_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * PEAK_FLOPS[peak])


def device_idle(data: Dict) -> Optional[float]:
    """1 - the union of the kernels' intervals over the traced window."""
    tr = data.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def b1_roofline(data: Dict) -> Optional[float]:
    """B1's operations at the peak of its working type over its device
    time. Each launch's operations follow its chain: a batch launches the
    LiDAR chain (most of the time) and the radar chain (under a tenth of
    the LiDAR launch's time), told apart by duration."""
    tr, per = data.get("trace"), data.get("b1_launch_flops")
    if not tr or not per:
        return None
    b1 = tr["kernels"]["b1"]
    main = b1["main"]
    if not main or b1["seconds"] <= 0:
        return None
    cut = 0.1 * max(main)
    flops = sum(per["lidar"] if d >= cut else per["radar"] for d in main)
    return 100.0 * flops / PEAK_FLOPS[data["b1_dtype"]] / b1["seconds"]


def b2_roofline(data: Dict) -> Optional[float]:
    """B2's bytes (each input read once, the output written once) at the
    memory bandwidth over its device time, for the batches in the traced
    window."""
    tr, nbytes = data.get("trace"), data.get("b2_bytes")
    if not tr or not nbytes:
        return None
    seconds = tr["kernels"]["b2"]["seconds"]
    if seconds <= 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds

