"""CenterNet target assignment on the device.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/targets.py:35-260``:
for all (B, M) boxes at once, the BEV pixel of each centre, the CornerNet
gaussian radius (``gaussian_radius``, compat and corrected forms, Q19), the
class heatmap as a max over every object's truncated gaussian, and the sparse
regression targets at the centres. The JAX package picks one of three
formulations of the heatmap max by grid size; they are bitwise identical, so
the port keeps one (a scatter-max of each object's plane into its class).
`prepare_centernet_targets_host` (``:263-301``) takes the reference-style
batch dict of host arrays and pads or cuts M to `max_objects` first.

Layouts are the JAX package's, NHWC: heatmap (B, H, W, C); `ind` indexes the
flattened H*W axis as y * W + x.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PC_RANGE


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.7, corrected: bool = False) -> torch.Tensor:
    """CornerNet 3-case gaussian radius, elementwise. The reference divides
    every root by 2 (the upstream CornerNet bug, kept by default);
    `corrected=True` divides the second and third roots by 2a."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * a1 * c1, min=0.0))) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 4 * a2 * c2, min=0.0))) / (2 * a2 if corrected else 2)

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) / (2 * a3 if corrected else 2)

    return torch.minimum(torch.minimum(r1, r2), r3)


def prepare_centernet_targets(
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    pc_range: Optional[Tuple[float, ...]] = None,
    bev_size: Tuple[int, int] = (50, 50),
    num_classes: int = 10,
    gaussian_overlap: float = 0.7,
    min_radius: int = 2,
    corrected_gaussian_radius: bool = False,
) -> Dict[str, torch.Tensor]:
    """Dense and sparse CenterNet targets on the boxes' device.

    gt_boxes (B, M, 7 or 9) [x, y, z, w, l, h, yaw(, vx, vy)], zero-padded;
    gt_labels (B, M) int, -1 for padding. Returns heatmap (B, H, W, C);
    offset (B, H, W, 2); size (B, H, W, 3); rot (B, H, W, 2); vel (B, H, W, 2)
    f32; ind (B, M) int32; mask and reg_mask (B, M) uint8; target_offset
    (B, M, 2), target_size (B, M, 3), target_rot (B, M, 2), target_vel
    (B, M, 2) f32."""
    if pc_range is None:
        pc_range = DEFAULT_PC_RANGE
    h, w = bev_size
    b, m = gt_labels.shape
    device = gt_boxes.device
    x_min, y_min, _, x_max, y_max, _ = pc_range
    voxel_x = (x_max - x_min) / w
    voxel_y = (y_max - y_min) / h

    boxes = gt_boxes.float()
    labels = gt_labels.to(torch.int32)
    x, y = boxes[..., 0], boxes[..., 1]
    bw, bl, bh = boxes[..., 3], boxes[..., 4], boxes[..., 5]
    yaw = boxes[..., 6]

    # products with the f32 reciprocals of the voxel sizes: XLA compiles the
    # JAX package's divisions by these constants so, and a centre on the
    # grid's edge (x = 51.2) rounds to just inside it (49.999996, kept)
    inv_x = 1.0 / torch.tensor(voxel_x, device=device)
    inv_y = 1.0 / torch.tensor(voxel_y, device=device)
    px = (x - x_min) * inv_x  # (B, M)
    py = (y - y_min) * inv_y
    # The reference computes these in float64 on the host, where a centre on
    # a grid line (world 0.0 -> pixel 25.0) lands on the integer; in f32 it
    # can land just below. Snap near-integers before the floor, but never up
    # onto the outer border (px == w would drop an object that is inside).
    px_r, py_r = torch.round(px), torch.round(py)
    px = torch.where(((px - px_r).abs() < 1e-4) & (px_r < w), px_r, px)
    py = torch.where(((py - py_r).abs() < 1e-4) & (py_r < h), py_r, py)
    cx = torch.floor(px).to(torch.int32)
    cy = torch.floor(py).to(torch.int32)

    valid = (labels >= 0) & (labels < num_classes) & (px >= 0) & (px < w) & (py >= 0) & (py < h)

    # radius in heatmap pixels (box length along y, width along x), int()
    # truncation as the reference
    radius_f = gaussian_radius(bl * inv_y, bw * inv_x, min_overlap=gaussian_overlap,
                               corrected=corrected_gaussian_radius)
    radius = torch.clamp(torch.nan_to_num(radius_f, nan=0.0).to(torch.int32), min=min_radius)

    # ---- dense heatmap ----
    sigma = (2 * radius + 1).float() / 6.0  # (B, M)
    xs = torch.arange(w, device=device, dtype=torch.int32).view(1, 1, 1, w)
    ys = torch.arange(h, device=device, dtype=torch.int32).view(1, 1, h, 1)
    dx = xs - cx[:, :, None, None]  # (B, M, 1, W)
    dy = ys - cy[:, :, None, None]  # (B, M, H, 1)
    r = radius[:, :, None, None]
    within = (dx.abs() <= r) & (dy.abs() <= r)  # (B, M, H, W)
    dist2 = (dx * dx + dy * dy).float()
    gauss = torch.exp(-dist2 / (2.0 * sigma * sigma)[:, :, None, None])
    gauss = torch.where(within & valid[:, :, None, None], gauss, torch.zeros((), device=device))
    # max-scatter each object's plane into its class; invalid rows have
    # gauss == 0 everywhere and never beat the zeros
    cls = torch.where(valid, labels, torch.zeros_like(labels)).long()
    heatmap = torch.zeros(b, num_classes, h * w, device=device).scatter_reduce_(
        1, cls[:, :, None].expand(b, m, h * w), gauss.reshape(b, m, h * w), "amax"
    ).reshape(b, num_classes, h, w).permute(0, 2, 3, 1).contiguous()

    # ---- sparse regression targets ----
    cx_c = cx.clamp(0, w - 1)
    cy_c = cy.clamp(0, h - 1)
    ind = torch.where(valid, cy_c * w + cx_c, torch.zeros_like(cx_c))
    reg_mask = valid.to(torch.uint8)
    vmask = valid[..., None].float()

    target_offset = torch.stack([px - cx.float(), py - cy.float()], -1) * vmask
    target_size = torch.stack([bw, bl, bh], -1) * vmask
    target_rot = torch.stack([torch.sin(yaw), torch.cos(yaw)], -1) * vmask
    if gt_boxes.shape[-1] > 7:
        target_vel = boxes[..., 7:9] * vmask
    else:
        # 7-column boxes: velocity targets stay zero (quirk Q12)
        target_vel = torch.zeros((b, m, 2), device=device)

    # ---- dense centre maps: each valid object's values at its cell ----
    # Invalid and padded rows write nothing: a zero-padded box lies in the
    # cell of the world origin and would overwrite a real object's values
    # there. Where valid objects share a cell, the last row wins (a
    # sequential scatter's order; the JAX package's CPU scatter gives it).
    cell = torch.arange(b, device=device)[:, None] * (h * w) + (cy_c * w + cx_c).long()
    row = torch.where(valid, torch.arange(b * m, device=device).reshape(b, m), -1)
    winner = torch.full((b * h * w,), -1, dtype=torch.long, device=device).scatter_reduce_(
        0, cell.reshape(-1), row.reshape(-1), "amax")
    taken = (winner >= 0)[:, None]

    def scatter_dense(values: torch.Tensor) -> torch.Tensor:
        c = values.shape[-1]
        picked = values.reshape(b * m, c)[winner.clamp(min=0)]
        return torch.where(taken, picked, torch.zeros((), device=device)).reshape(b, h, w, c)

    return {
        "heatmap": heatmap,
        "offset": scatter_dense(target_offset),
        "size": scatter_dense(target_size),
        "rot": scatter_dense(target_rot),
        "vel": scatter_dense(target_vel),
        "ind": ind,
        "mask": reg_mask,
        "reg_mask": reg_mask,
        "target_offset": target_offset,
        "target_size": target_size,
        "target_rot": target_rot,
        "target_vel": target_vel,
    }


def prepare_centernet_targets_host(
    batch: Dict,
    pc_range: Optional[Sequence[float]] = None,
    bev_size: Tuple[int, int] = (50, 50),
    num_classes: int = 10,
    max_objects: int = 500,
    gaussian_overlap: float = 0.7,
    min_radius: int = 2,
    corrected_gaussian_radius: bool = False,
    device=None,
) -> Dict[str, torch.Tensor]:
    """`prepare_centernet_targets` on a reference-style batch dict
    ({'gt_boxes': (B, M, 7), 'gt_labels': (B, M)} array-likes), with M
    zero-padded (labels -1) or cut to `max_objects`, as the JAX wrapper
    does for its static signature (ref interface: centernet_target.py:170-186).
    The targets are made on `device` (the CPU by default)."""
    gt_boxes = np.asarray(batch["gt_boxes"], dtype=np.float32)
    gt_labels = np.asarray(batch["gt_labels"], dtype=np.int64)
    m = gt_labels.shape[1]
    if m < max_objects:
        gt_boxes = np.pad(gt_boxes, ((0, 0), (0, max_objects - m), (0, 0)))
        gt_labels = np.pad(gt_labels, ((0, 0), (0, max_objects - m)), constant_values=-1)
    else:
        gt_boxes, gt_labels = gt_boxes[:, :max_objects], gt_labels[:, :max_objects]
    return prepare_centernet_targets(
        torch.as_tensor(gt_boxes, device=device),
        torch.as_tensor(gt_labels, device=device),
        pc_range=tuple(pc_range) if pc_range is not None else None,
        bev_size=bev_size,
        num_classes=num_classes,
        gaussian_overlap=gaussian_overlap,
        min_radius=min_radius,
        corrected_gaussian_radius=corrected_gaussian_radius,
    )
