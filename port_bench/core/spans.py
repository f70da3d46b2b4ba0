"""The arithmetic of the per-layer metrics read from the program's own spans
(`utils/profiling.py`: `span`, `recorded_spans()`). The program records
spans only while a profiler runs, so those it holds once the cell's run
returns are the profiled sub-window's; the readers call these before the
check runs. Each returns None where the program recorded no such span, as
a program without spans records none."""

from __future__ import annotations

from typing import Dict, List, Optional


def recorded(name: str) -> List[Dict]:
    """The sub-window's spans named `name`."""
    try:
        from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return []
    return [s for s in recorded_spans() if s["name"] == name]


def mean_ms(name: str) -> Optional[float]:
    """The spans' mean length on the host clock, in ms."""
    spans = recorded(name)
    if not spans:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / len(spans) / 1e6


def mean_device_ms(name: str) -> Optional[float]:
    """The spans' mean CUDA stream time between their edges, in ms."""
    times = [s["device_ms"] for s in recorded(name) if s["device_ms"] is not None]
    return sum(times) / len(times) if times else None


def mean_attr(name: str, attr: str, scale: float = 1.0) -> Optional[float]:
    """The mean of the spans' attribute `attr`, times `scale`."""
    values = [s["attrs"][attr] for s in recorded(name) if attr in s["attrs"]]
    return scale * sum(values) / len(values) if values else None


def attr_ratio(name: str, num: str, den: str, scale: float = 1.0) -> Optional[float]:
    """The spans' summed attribute `num` over their summed `den`, times `scale`."""
    spans = [s["attrs"] for s in recorded(name) if num in s["attrs"] and den in s["attrs"]]
    total = sum(a[den] for a in spans)
    return scale * sum(a[num] for a in spans) / total if total else None
