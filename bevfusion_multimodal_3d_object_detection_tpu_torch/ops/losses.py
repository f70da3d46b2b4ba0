"""CenterNet loss: focal heatmap loss and L1 regression at object centres.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/losses.py:27-133``
(NHWC maps; `ind` indexes the flattened H*W axis). The default weights
(heatmap, offset, size, rot, vel) = (1, 1, 1, 1, 0.1) are the reference's
constructor defaults (quirk Q7, `config.TrainSpec`). The MLP head's
`prepare_mlp_targets` and `detection_loss` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

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
