"""Camera-to-BEV lift-splat: frustum geometry and the two splat formulations
of the geometric eval path.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/bev_splat.py``:

- `precompute_frustum_cells` (``:59-102``, host numpy, the port's own copy):
  the flat BEV cell of every (depth, v, u) frustum point of one camera, -1
  out of range. It depends on calibration only.
- `lift_splat_pallas_rows` (``:193-232``): depth softmax in the working
  dtype, weights in the plan's p = d * HW + pixel order, then kernel B2
  (`ops.bev_pool.bev_pool_weighted_rows`). Inference only.
- `lift_splat_matmul_rows` (``:494-507`` with `_splat_weights` ``:167-186``):
  plain PyTorch, a scalar scatter of the depth probabilities into per-pixel
  cell weights (X, HW, cells) followed by one batched matmul.

Features and depth logits come NCHW, (X, C, H', W') and (X, D, H', W'), and
both splats return (X, num_cells, C) as in the JAX package. The `scatter`
and `culled` formulations are not ported yet (ROADMAP, still to port).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bev_pool import DEFAULT_WINDOW, bev_pool_weighted_rows


def precompute_frustum_cells(
    intrinsics: np.ndarray,
    sensor2lidar_rot: np.ndarray,
    sensor2lidar_trans: np.ndarray,
    feat_hw: Tuple[int, int],
    image_hw: Tuple[int, int],
    depth_bins: np.ndarray,
    bev_hw: Tuple[int, int],
    pc_range: Tuple[float, ...],
) -> np.ndarray:
    """(3, 3) intrinsics at image resolution, camera->LiDAR rotation and
    translation, (D,) metric depths -> (D, H', W') int32 flat BEV cell ids
    (-1 = out of range)."""
    fh, fw = feat_hw
    ih, iw = image_hw
    # pixel centres of the feature grid, scaled to image coordinates
    us = (np.arange(fw) + 0.5) * (iw / fw)
    vs = (np.arange(fh) + 0.5) * (ih / fh)
    uu, vv = np.meshgrid(us, vs)  # (H', W')

    k_inv = np.linalg.inv(intrinsics)
    rays = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ k_inv.T  # (H', W', 3)
    pts = rays[None, :, :, :] * depth_bins[:, None, None, None]  # (D, H', W', 3)
    pts = pts @ sensor2lidar_rot.T + sensor2lidar_trans  # camera -> LiDAR

    x_min, y_min, _, x_max, y_max, _ = pc_range
    bh, bw = bev_hw
    vx = (x_max - x_min) / bw
    vy = (y_max - y_min) / bh
    ix = np.floor((pts[..., 0] - x_min) / vx).astype(np.int32)
    iy = np.floor((pts[..., 1] - y_min) / vy).astype(np.int32)
    valid = (ix >= 0) & (ix < bw) & (iy >= 0) & (iy < bh)
    cells = np.where(valid, iy * bw + ix, -1)
    return cells.astype(np.int32)


def _rows(features: torch.Tensor) -> torch.Tensor:
    """(X, C, H', W') -> contiguous (X, HW, C)."""
    x, c = features.shape[:2]
    return features.permute(0, 2, 3, 1).reshape(x, -1, c).contiguous()


def lift_splat_pallas_rows(
    features: torch.Tensor,
    depth_logits: torch.Tensor,
    point_idx: torch.Tensor,
    local_ids: torch.Tensor,
    block_idx: torch.Tensor,
    num_cells: int,
    num_cells_pad: int,
    window: int = DEFAULT_WINDOW,
) -> torch.Tensor:
    """Fused lift-splat through kernel B2: features (X, C, H', W'), depth
    logits (X, D, H', W') and per-row chunk plans -> (X, num_cells, C) f32."""
    x = depth_logits.shape[0]
    probs = torch.softmax(depth_logits, dim=1)  # in the working dtype
    return bev_pool_weighted_rows(
        _rows(features), probs.reshape(x, -1), point_idx, local_ids, block_idx,
        num_cells=num_cells, num_cells_pad=num_cells_pad, window=window,
    )


def _splat_weights(depth_probs: torch.Tensor, cell_ids: torch.Tensor, num_cells: int) -> torch.Tensor:
    """(X, D, H', W') probs + (X, D*H'*W') cells -> (X, HW, num_cells)
    per-pixel cell weights in the probs' dtype (-1 ids dropped)."""
    x, d = depth_probs.shape[:2]
    hw = depth_probs[0, 0].numel()
    ids = cell_ids.reshape(x, d, hw).long()
    ids = torch.where(ids < 0, torch.full_like(ids, num_cells), ids)  # trash column
    pix = torch.arange(hw, device=ids.device)
    flat = pix * (num_cells + 1) + ids  # (X, D, HW) into a (HW, num_cells + 1) matrix
    w = torch.zeros(x, hw * (num_cells + 1), dtype=depth_probs.dtype, device=depth_probs.device)
    w.scatter_add_(1, flat.reshape(x, -1), depth_probs.reshape(x, -1))
    return w.reshape(x, hw, num_cells + 1)[:, :, :num_cells]


def lift_splat_matmul_rows(
    features: torch.Tensor,
    depth_logits: torch.Tensor,
    cell_ids: torch.Tensor,
    num_cells: int,
) -> torch.Tensor:
    """Lift-splat as scatter + matmul: features (X, C, H', W'), depth logits
    (X, D, H', W'), cell ids (X, D*H'*W') -> (X, num_cells, C) in the
    features' dtype."""
    x, c = features.shape[:2]
    w = _splat_weights(torch.softmax(depth_logits, dim=1), cell_ids, num_cells)
    return torch.bmm(w.transpose(1, 2), features.reshape(x, c, -1).transpose(1, 2))
