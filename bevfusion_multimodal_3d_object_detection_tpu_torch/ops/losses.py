"""Training losses.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/losses.py``:

- the CenterNet loss (``:27-133``): focal heatmap loss and L1 regression at
  object centres (NHWC maps; `ind` indexes the flattened H*W axis). The
  default weights (heatmap, offset, size, rot, vel) = (1, 1, 1, 1, 0.1) are
  the reference's constructor defaults (quirk Q7, `config.TrainSpec`);
- the MLP head's targets and loss (``:136-221``): `prepare_mlp_targets`
  (the first valid object of each sample) and `detection_loss` (its ``cls``
  branch: cross-entropy + L1 box loss; and the simplified dense ``heatmap``
  branch).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def focal_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 2.0,
               beta: float = 4.0, double_sigmoid: bool = True) -> torch.Tensor:
    """CenterNet focal loss. `double_sigmoid=True` is quirk Q2: the model's
    heatmap is already sigmoided and the reference loss applies the sigmoid
    again. Predictions are clipped to [1e-4, 1 - 1e-4]."""
    if double_sigmoid:
        pred = torch.sigmoid(pred)
    pred = pred.clamp(1e-4, 1 - 1e-4)
    pos = (target == 1.0).float()
    neg = (target < 1.0).float()
    neg_weights = torch.pow(1.0 - target, beta)
    pos_loss = (torch.log(pred) * torch.pow(1.0 - pred, alpha) * pos).sum()
    neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, alpha) * neg_weights * neg).sum()
    num_pos = pos.sum()
    return torch.where(num_pos == 0, -neg_loss, -(pos_loss + neg_loss) / num_pos.clamp(min=1.0))


def gather_regression(pred_map: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) at flat indices (B, M) -> (B, M, C)."""
    b, h, w, c = pred_map.shape
    idx = ind.long()[..., None].expand(-1, -1, c)
    return torch.gather(pred_map.reshape(b, h * w, c), 1, idx)


def regression_loss(pred_map: torch.Tensor, target: torch.Tensor, ind: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked L1 at object centres, normalized by the mask sum expanded over
    the channels (num_valid * C) + 1e-4, as the reference."""
    pred = gather_regression(pred_map, ind)
    m = mask[..., None].float().expand_as(target)
    return ((pred - target).abs() * m).sum() / (m.sum() + 1e-4)


def centernet_loss(predictions: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                   weights: Tuple[float, float, float, float, float] = (1.0, 1.0, 1.0, 1.0, 0.1),
                   double_sigmoid: bool = True) -> Dict[str, torch.Tensor]:
    """The loss dict: total_loss and the five weighted terms' losses, in f32
    whatever the predictions' dtype."""
    hm_w, off_w, size_w, rot_w, vel_w = weights
    ind, mask = targets["ind"], targets["reg_mask"]
    losses = {
        "heatmap_loss": focal_loss(predictions["heatmap"].float(), targets["heatmap"],
                                   double_sigmoid=double_sigmoid),
    }
    for name in ("offset", "size", "rot", "vel"):
        losses[f"{name}_loss"] = regression_loss(
            predictions[name].float(), targets[f"target_{name}"], ind, mask)
    total = (hm_w * losses["heatmap_loss"] + off_w * losses["offset_loss"]
             + size_w * losses["size_loss"] + rot_w * losses["rot_loss"]
             + vel_w * losses["vel_loss"])
    return {"total_loss": total, **losses}


def prepare_mlp_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                        num_classes: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The label (int32) and first 7 box columns of each sample's first
    object with a label >= 0 (and < `num_classes` when given: out-of-range
    labels count as invalid, as in the JAX package), else (0, zeros)."""
    valid = gt_labels >= 0
    if num_classes is not None:
        valid = valid & (gt_labels < num_classes)
    has_valid = valid.any(dim=1)
    first = valid.to(torch.uint8).argmax(dim=1)  # the first True (0 if none)
    rows = torch.arange(gt_labels.shape[0], device=gt_labels.device)
    labels = torch.where(has_valid, gt_labels[rows, first], torch.zeros_like(gt_labels[:, 0]))
    boxes = gt_boxes[rows, first, :7]
    boxes = torch.where(has_valid[:, None], boxes, torch.zeros_like(boxes))
    return {"labels": labels.to(torch.int32), "boxes": boxes}


def detection_loss(predictions: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's alternative DetectionLoss, in f32. With ``cls`` in
    `predictions` (the MLP head): cross-entropy over the classes plus the
    mean L1 box error. Otherwise the dense heatmap branch: a focal loss
    against ``targets['heatmap']`` (NHWC; positives where it is 1) plus the
    mean L1 of ``offset``, ``size`` and ``rot`` at the positive pixels."""
    if "cls" in predictions:
        logp = torch.log_softmax(predictions["cls"].float(), dim=-1)
        cls_loss = -logp.gather(1, targets["labels"].long()[:, None]).mean()
        box_loss = (predictions["box"].float() - targets["boxes"]).abs().mean()
        return {"cls_loss": cls_loss, "box_loss": box_loss, "total_loss": cls_loss + box_loss}

    pred_hm = predictions["heatmap"].float()
    target_hm = targets["heatmap"]
    pos = (target_hm == 1.0).float()
    neg = (target_hm < 1.0).float()
    pos_loss = torch.log(pred_hm + 1e-12) * torch.pow(1 - pred_hm, 2) * pos
    neg_loss = torch.log(1 - pred_hm + 1e-12) * torch.pow(pred_hm, 2) * torch.pow(1.0 - target_hm, 4) * neg
    num_pos = pos.sum()
    hm_loss = torch.where(num_pos == 0, -neg_loss.sum(),
                          -(pos_loss.sum() + neg_loss.sum()) / num_pos.clamp(min=1.0))
    losses = {"heatmap_loss": hm_loss}
    total = hm_loss
    center = pos.amax(dim=-1, keepdim=True)  # any class peaks at this pixel
    for key in ("offset", "size", "rot"):
        if key in predictions:
            loss = (predictions[key].float() * center - targets[key] * center).abs().mean()
            losses[f"{key}_loss"] = loss
            total = total + loss
    losses["total_loss"] = total
    return losses
