"""The BEV cell of every frustum point, from a camera's calibration.

For each pixel centre of the stride-16 feature grid, scaled to image
coordinates, and each of the D metric depths (evenly spaced from depth_min
to depth_max), the point K^-1 [u v 1]^T * depth, moved into the LiDAR frame
by the camera's rotation and translation, falls into the BEV cell
floor((x - x_min) / voxel_x), floor((y - y_min) / voxel_y), or none (-1)
outside the grid.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def frustum_cells(spec, calibration: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]) -> np.ndarray:
    """(N_cam, D, H/16, W/16) int64 flat cell ids, -1 out of the grid."""
    ih, iw = spec.image_hw
    fh, fw = ih // 16, iw // 16
    depths = np.linspace(spec.depth_min, spec.depth_max, spec.depth_bins)
    u = (np.arange(fw) + 0.5) * (iw / fw)
    v = (np.arange(fh) + 0.5) * (ih / fh)
    uu, vv = np.meshgrid(u, v)
    x0, y0, _, x1, y1, _ = spec.pc_range
    vx, vy = (x1 - x0) / spec.bev_w, (y1 - y0) / spec.bev_h
    out = []
    for intr, rot, trans in calibration:
        rays = np.stack([uu, vv, np.ones_like(uu)], -1) @ np.linalg.inv(intr).T
        pts = rays[None] * depths[:, None, None, None]
        pts = pts @ np.asarray(rot).T + np.asarray(trans)
        ix = np.floor((pts[..., 0] - x0) / vx).astype(np.int64)
        iy = np.floor((pts[..., 1] - y0) / vy).astype(np.int64)
        inside = (ix >= 0) & (ix < spec.bev_w) & (iy >= 0) & (iy < spec.bev_h)
        out.append(np.where(inside, iy * spec.bev_w + ix, -1))
    return np.stack(out)
