"""The numbers that decide `correct`.

Detections (serving and evaluation). For each compared request, the
reference's f32 maps of its sample give the box each BEV cell would decode
to (`reference.decode.cell_table`). ``det_gap`` is the largest, over the
compared requests, of three parts:

- for every served detection, the distance to the nearest reference
  candidate (cell, class), taken as the largest over the box's parts, each
  in units of that part's spread over the reference's cells: position
  (x, y, z) in voxel x rms(offset), size in rms(size), yaw as |rot| x the
  angle between them in rms(rot) (well conditioned where |rot| is small),
  velocity in rms(vel) and the score in the std of the heatmap;
- how far the lowest served score lies under the reference's K-th best
  peak score (or the threshold, where fewer pass it), in the heatmap's std:
  the served detections have to be the best peaks, not any;
- infinite where the served count differs from the reference's by more
  than the reference peaks within `COUNT_MARGIN` of the threshold, or a
  label is not the decode's rule (every label 0, quirk Q1).

Training, per parameter, measured against the larger of the reference's
norm for that parameter and the median parameter's:

- ``loss_gap``: the largest |loss - reference| / |reference| of the
  checked steps; ``loss1_gap``: the same of the first step alone (steady
  from seed to seed: later steps compound the rounding of earlier ones);
- ``grad_gap``: the largest |norm(first gradient) - reference's|. The
  program's first gradient is the first moment after one AdamW step over
  (1 - beta1);
- ``change_gap``: the largest |norm(change over the steps) - reference's|.

Parameters whose reference gradient is under 1e-3 of the median
parameter's are left out (biases before a train-mode BatchNorm: their
gradient is rounding, and AdamW moves them by round-off alone).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from reference.decode import cell_table, top_scores


def _rms(x: torch.Tensor) -> float:
    return max(float(x.float().pow(2).mean().sqrt()), 1e-12)


def served_boxes(det: Dict[str, np.ndarray]) -> np.ndarray:
    """(K, 9) [x y z w l h yaw vx vy] of a served or evaluated result."""
    boxes = np.asarray(det["boxes"], np.float32)
    if boxes.shape[-1] == 7:
        boxes = np.concatenate([boxes, np.asarray(det["velocities"], np.float32)], -1)
    return boxes


COUNT_MARGIN = 0.05


def detection_gaps(dets: Sequence[Dict[str, np.ndarray]], maps: Sequence[Dict[str, torch.Tensor]],
                   voxel: float, pc_range, k: int, threshold: float) -> Dict[str, float]:
    det_gap = 0.0
    for det, m in zip(dets, maps):
        table = cell_table(m, voxel, pc_range)
        dev = table["pos"].device
        box = torch.as_tensor(served_boxes(det), device=dev)
        scores = torch.as_tensor(np.asarray(det["scores"], np.float32), device=dev)
        ref = top_scores(m, k)
        passing = ref[ref > threshold]
        near = int(((ref - threshold).abs() <= COUNT_MARGIN).sum())
        labels = np.asarray(det["labels"])
        if abs(len(scores) - len(passing)) > near or (labels.size and np.any(labels != 0)):
            return {"det_gap": math.inf}
        if not box.shape[0]:
            continue
        s_score = max(float(table["score"].std()), 1e-12)
        s_pos = voxel * _rms(m["offset"])
        parts = [
            (box[:, None, :3] - table["pos"][None]).abs().amax(-1) / s_pos,
            (box[:, None, 3:6] - table["size"][None]).abs().amax(-1) / _rms(table["size"]),
            torch.remainder(box[:, None, 6] - table["yaw"][None] + math.pi, 2 * math.pi).sub(math.pi).abs()
            * table["rot"].norm(dim=-1)[None] / _rms(table["rot"]),
            (box[:, None, 7:9] - table["vel"][None]).abs().amax(-1) / _rms(table["vel"]),
        ]
        d_box = torch.stack(parts).amax(0)  # (K, cells)
        d_score = (scores[:, None, None] - table["score"][None]).abs() / s_score
        nearest = torch.maximum(d_box[..., None], d_score).flatten(1).amin(1)
        floor = float(passing[len(scores) - 1]) if len(passing) >= len(scores) else threshold
        shortfall = max(0.0, floor - float(scores.min())) / s_score
        det_gap = max(det_gap, float(nearest.max()), shortfall)
    return {"det_gap": det_gap}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], names: Iterable[str]) -> Dict[str, float]:
    floor = float(np.median(list(want.values())))
    return {n: abs(got[n] - want[n]) / max(want[n], floor) for n in names}


def train_gaps(got: Dict, want: Dict, beta1: float) -> Dict[str, float]:
    """`got`: the program's ``losses``, ``first_moment`` norms and
    ``change`` norms by parameter; `want`: the reference's ``losses``,
    ``first_grad`` and ``change`` norms."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    grad = {n: v / (1 - beta1) for n, v in got["first_moment"].items()}
    g_ref = want["first_grad"]
    if set(grad) != set(g_ref) or set(got["change"]) != set(want["change"]):
        raise ValueError("the program's parameters are not the reference's")
    median = float(np.median(list(g_ref.values())))
    moved = [n for n in g_ref if g_ref[n] >= 1e-3 * median]
    grad_gaps = _leaf_gaps(grad, g_ref, moved)
    change_gaps = _leaf_gaps(got["change"], want["change"], moved)
    for what, gaps in (("gradient", grad_gaps), ("change", change_gaps)):
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        print(f"train check: worst {what} leaves " + ", ".join(f"{n} {v:.4g}" for n, v in worst), file=sys.stderr)
    return {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": max(grad_gaps.values()),
        "change_gap": max(change_gaps.values()),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is at or under its limit (a missing limit or
    a number that is not finite is not correct)."""
    return all(name in limits and limits[name] is not None and math.isfinite(v) and v <= limits[name]
               for name, v in numbers.items())


def sample_indices(n: int, k: int, rng: np.random.Generator) -> List[int]:
    return sorted(rng.choice(n, size=min(n, k), replace=False).tolist())
