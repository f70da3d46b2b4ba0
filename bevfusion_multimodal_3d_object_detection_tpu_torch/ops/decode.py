"""CenterNet decode on the device: maxpool-NMS + two-stage top-K + gather.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/decode.py:42-241``.
`heatmap_nms` and `decode_centernet_predictions` run in torch on the
predictions' device; `centernet_decoder` binds the latter to a model's grid
and flags once. `bev_iou_matrix`, `nms_bev`, `filter_detections` (one
sample's threshold, NMS and cap) and `decode_to_host` are the port's own
numpy copies of the host-side post-processing.

Compat flags, as in the JAX package: `class_always_zero` (quirk Q1: every
label is 0), `voxel_size` scalar (Q3: 0.512 on the eval/inference paths) or
per-axis (voxel_x, voxel_y); the ground plane is fixed at z = -1 (Q15).
`torch.topk` and `lax.top_k` break ties differently: equal scores may come
back in another order.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT_PC_RANGE

if TYPE_CHECKING:
    from ..config import CompatFlags, DetectorSpec


def heatmap_nms(heatmap: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima of an NCHW map; non-peaks become 0."""
    hmax = F.max_pool2d(heatmap, kernel, 1, kernel // 2)
    return torch.where(hmax == heatmap, heatmap, torch.zeros_like(heatmap))


def decode_centernet_predictions(
    predictions: Dict[str, torch.Tensor],
    max_detections: int = 100,
    voxel_size: Union[float, Sequence[float]] = 2.048,
    pc_range: Tuple[float, ...] = DEFAULT_PC_RANGE,
    class_always_zero: bool = True,
) -> Dict[str, torch.Tensor]:
    """NHWC maps {'heatmap' (B,H,W,C), 'offset' (B,H,W,2), 'size' (B,H,W,3),
    'rot' (B,H,W,2), 'vel' (B,H,W,2)} -> {'boxes' (B,K,7), 'scores' (B,K),
    'labels' (B,K) int32, 'velocities' (B,K,2)}, sorted by score."""
    heatmap = predictions["heatmap"].float()
    b, h, w, c = heatmap.shape
    k = max_detections

    # stage 1: per-class top-K over the spatial axis, on (B, C, H*W)
    heat = heatmap_nms(heatmap.permute(0, 3, 1, 2)).reshape(b, c, h * w)
    cls_scores, cls_idx = torch.topk(heat, k, dim=2)
    if class_always_zero:
        classes = torch.zeros_like(cls_idx)
    else:
        classes = torch.arange(c, device=cls_idx.device)[None, :, None].expand_as(cls_idx)
    # stage 2: combined top-K across classes
    scores, comb_idx = torch.topk(cls_scores.reshape(b, c * k), k, dim=1)
    classes = torch.gather(classes.reshape(b, c * k), 1, comb_idx)
    pos = torch.gather(cls_idx.reshape(b, c * k), 1, comb_idx)  # y * w + x
    ys, xs = pos // w, pos % w

    def gather_map(name: str) -> torch.Tensor:
        m = predictions[name].float()
        m = m.reshape(b, h * w, m.shape[-1])
        return torch.gather(m, 1, pos[..., None].expand(-1, -1, m.shape[-1]))

    offset, sizes, rot, vel = (gather_map(n) for n in ("offset", "size", "rot", "vel"))
    if isinstance(voxel_size, (tuple, list)):
        voxel_x, voxel_y = voxel_size
    else:
        voxel_x = voxel_y = voxel_size
    world_x = (xs.float() + offset[..., 0]) * voxel_x + pc_range[0]
    world_y = (ys.float() + offset[..., 1]) * voxel_y + pc_range[1]
    world_z = torch.full_like(world_x, -1.0)
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    boxes = torch.stack(
        [world_x, world_y, world_z, sizes[..., 0], sizes[..., 1], sizes[..., 2], yaw],
        dim=-1,
    )
    return {
        "boxes": boxes,
        "scores": scores,
        "labels": classes.to(torch.int32),
        "velocities": vel,
    }


def centernet_decoder(spec: "DetectorSpec", compat: "CompatFlags", eval_path: bool,
                      max_detections: Optional[int] = None) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """`decode_centernet_predictions` bound to the model of `spec`: its
    ``pc_range``, `max_detections` (the head's ``max_detections`` when None),
    Q1's ``compat.decode_class_always_zero``, and the voxel: 0.512 on the
    standalone eval and inference path (`eval_path`) under
    ``compat.eval_decode_voxel_0512`` (quirk Q3), else the grid's own, per
    axis."""
    if eval_path and compat.eval_decode_voxel_0512:
        voxel_size = 0.512
    else:
        x_min, y_min, _, x_max, y_max, _ = spec.bev.pc_range
        voxel_size = ((x_max - x_min) / spec.bev.bev_w, (y_max - y_min) / spec.bev.bev_h)
    return functools.partial(
        decode_centernet_predictions,
        max_detections=spec.centernet.max_detections if max_detections is None else max_detections,
        voxel_size=voxel_size,
        pc_range=spec.bev.pc_range,
        class_always_zero=compat.decode_class_always_zero,
    )


def bev_iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Axis-aligned BEV IoU between (N, 7+) and (M, 7+) boxes
    ((x, y, z, w, l, h, yaw); yaw ignored)."""
    ax1 = boxes_a[:, 0] - boxes_a[:, 3] / 2
    ay1 = boxes_a[:, 1] - boxes_a[:, 4] / 2
    ax2 = boxes_a[:, 0] + boxes_a[:, 3] / 2
    ay2 = boxes_a[:, 1] + boxes_a[:, 4] / 2
    bx1 = boxes_b[:, 0] - boxes_b[:, 3] / 2
    by1 = boxes_b[:, 1] - boxes_b[:, 4] / 2
    bx2 = boxes_b[:, 0] + boxes_b[:, 3] / 2
    by2 = boxes_b[:, 1] + boxes_b[:, 4] / 2
    ix = np.maximum(0.0, np.minimum(ax2[:, None], bx2[None, :]) - np.maximum(ax1[:, None], bx1[None, :]))
    iy = np.maximum(0.0, np.minimum(ay2[:, None], by2[None, :]) - np.maximum(ay1[:, None], by1[None, :]))
    inter = ix * iy
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def nms_bev(det: Dict[str, np.ndarray], iou_thresh: float) -> Dict[str, np.ndarray]:
    """Greedy axis-aligned BEV NMS on one sample dict; the result is
    score-descending."""
    boxes, scores = det["boxes"], det["scores"]
    n = len(scores)
    if n <= 1:
        return det
    order = np.argsort(-scores, kind="stable")
    iou = bev_iou_matrix(boxes[order], boxes[order])
    keep_sorted = np.ones(n, bool)
    for i in range(n):
        if keep_sorted[i]:
            keep_sorted[i + 1:] &= iou[i, i + 1:] < iou_thresh
    keep = order[keep_sorted]
    return {k: v[keep] for k, v in det.items()}


def filter_detections(
    det: Dict[str, np.ndarray],
    score_thresh: float,
    nms_thresh: Optional[float] = None,
    max_detections: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """One sample's fixed-size host arrays (``boxes``, ``scores`` and any
    other per-detection keys) -> those above `score_thresh`, optionally
    BEV-NMS'd and capped."""
    keep = det["scores"] > score_thresh
    det = {k: v[keep] for k, v in det.items()}
    if nms_thresh is not None:
        det = nms_bev(det, nms_thresh)
    if max_detections is not None and len(det["scores"]) > max_detections:
        det = {k: v[:max_detections] for k, v in det.items()}
    return det


def decode_to_host(
    decoded: Dict[str, torch.Tensor],
    score_thresh: float = 0.3,
    nms_thresh: Optional[float] = None,
    max_detections: Optional[int] = None,
) -> List[Dict[str, np.ndarray]]:
    """Fixed-size decode output -> per-sample list of dicts above
    `score_thresh`, optionally BEV-NMS'd and capped (`filter_detections`)."""
    host = {k: v.detach().cpu().numpy() for k, v in decoded.items()}
    labels = host["labels"].astype(np.int64)
    return [
        filter_detections({"boxes": host["boxes"][bi], "scores": host["scores"][bi], "labels": labels[bi],
                           "velocities": host["velocities"][bi]}, score_thresh, nms_thresh, max_detections)
        for bi in range(host["boxes"].shape[0])
    ]
