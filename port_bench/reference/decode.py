"""Plain CenterNet decode of the reference maps, and the per-cell table
that a served detection is compared with.

The detector's decode: the heatmap's local maxima (3x3 max-pool NMS), the
top K over every (class, cell), and at each chosen cell the box
x = (col + offset_x) * voxel + x_min, y likewise, z = -1 (the fixed ground
plane), (w, l, h) = size, yaw = atan2(rot_0, rot_1), velocity = vel. Every
label is 0 (quirk Q1) and the voxel is 0.512 on the serving and evaluation
paths (quirk Q3).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

GROUND_Z = -1.0


def peak_scores(heatmap: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H*W*C,) scores with every non-peak set to 0."""
    hm = heatmap.permute(2, 0, 1)[None]
    keep = F.max_pool2d(hm, 3, 1, 1) == hm
    return torch.where(keep, hm, torch.zeros_like(hm))[0].permute(1, 2, 0).reshape(-1)


def top_scores(maps: Dict[str, torch.Tensor], k: int) -> torch.Tensor:
    """One sample's (H, W, C) maps -> its K best peak scores, descending."""
    return torch.topk(peak_scores(maps["heatmap"].float()), k).values


def cell_table(maps: Dict[str, torch.Tensor], voxel: float, pc_range: Tuple[float, ...]) -> Dict[str, torch.Tensor]:
    """One sample's maps -> the box every cell would give, (H*W, ...):
    ``pos`` (x, y, z), ``size`` (3), ``rot`` (2, the raw vector), ``yaw``,
    ``vel`` (2), and ``score`` (H*W, C)."""
    hm = maps["heatmap"].float()
    h, w, c = hm.shape
    rows = torch.arange(h, device=hm.device, dtype=torch.float32)[:, None].expand(h, w)
    cols = torch.arange(w, device=hm.device, dtype=torch.float32)[None, :].expand(h, w)
    off = maps["offset"].float()
    x = (cols + off[..., 0]) * voxel + pc_range[0]
    y = (rows + off[..., 1]) * voxel + pc_range[1]
    pos = torch.stack([x, y, torch.full_like(x, GROUND_Z)], -1).reshape(h * w, 3)
    rot = maps["rot"].float().reshape(h * w, 2)
    return {
        "pos": pos,
        "size": maps["size"].float().reshape(h * w, 3),
        "rot": rot,
        "yaw": torch.atan2(rot[:, 0], rot[:, 1]),
        "vel": maps["vel"].float().reshape(h * w, 2),
        "score": hm.reshape(h * w, c),
    }
