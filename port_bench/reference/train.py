"""Plain training arithmetic of the detector: CenterNet targets, the loss,
the global-norm clip and AdamW, over the flat variables of
`reference.model`.

- Targets (the CenterNet recipe of the reference repository): each valid
  box (label in [0, classes), centre inside the grid) puts a truncated
  gaussian of the CornerNet radius (every root halved, as the reference
  computes it; at least 2 cells) on its class's heatmap, max over boxes; the
  regression targets at the centre cell are the sub-cell offset, (w, l, h),
  (sin, cos) of the yaw and the velocity (zero for 7-column boxes).
- Loss: the focal loss (alpha 2, beta 4) of the twice-sigmoided heatmap
  (quirk Q2), clipped to [1e-4, 1 - 1e-4], over the number of positives;
  the L1 regressions at the centres over (valid boxes x channels) + 1e-4;
  weights (1, 1, 1, 1, 0.1) (quirk Q7).
- Update: the gradient scaled by max_norm / norm where its global norm is
  at least max_norm, then AdamW with decoupled weight decay on every
  parameter and a constant rate (quirk Q6).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .model import Forward, Spec, exact_float32, normalize_uint8

LOSS_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 0.1)


def _radius(height: torch.Tensor, width: torch.Tensor, overlap: float = 0.7) -> torch.Tensor:
    b1 = height + width
    c1 = width * height * (1 - overlap) / (1 + overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * overlap
    b3 = -2 * overlap * (height + width)
    c3 = (overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def targets(spec: Spec, boxes: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """boxes (B, M, 7) [x y z w l h yaw], labels (B, M) (-1 padding) ->
    heatmap (B, H, W, C) and, per box, ``cell`` (flat index), ``valid``,
    ``offset``, ``size``, ``rot``, ``vel``. In float64 on the boxes' device."""
    h, w, nc = spec.bev_h, spec.bev_w, spec.num_classes
    x0, y0, _, x1, y1, _ = spec.pc_range
    vx, vy = (x1 - x0) / w, (y1 - y0) / h
    bx = boxes.double()
    px, py = (bx[..., 0] - x0) / vx, (bx[..., 1] - y0) / vy
    cx, cy = torch.floor(px).long(), torch.floor(py).long()
    valid = (labels >= 0) & (labels < nc) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    radius = _radius(bx[..., 4] / vy, bx[..., 3] / vx).nan_to_num(0.0).long().clamp(min=2)
    sigma = (2 * radius + 1).double() / 6.0
    xs = torch.arange(w, device=boxes.device)[None, None, None, :]
    ys = torch.arange(h, device=boxes.device)[None, None, :, None]
    dx, dy = xs - cx[..., None, None], ys - cy[..., None, None]
    r = radius[..., None, None]
    g = torch.exp(-(dx * dx + dy * dy).double() / (2 * sigma * sigma)[..., None, None])
    g = torch.where((dx.abs() <= r) & (dy.abs() <= r) & valid[..., None, None], g, torch.zeros((), dtype=g.dtype,
                                                                                                device=g.device))
    b, m = labels.shape
    heat = torch.zeros(b, nc, h, w, dtype=torch.float64, device=boxes.device)
    for cls in range(nc):
        sel = (labels == cls)[..., None, None]
        heat[:, cls] = torch.where(sel, g, torch.zeros_like(g)).amax(dim=1)
    yaw = bx[..., 6]
    vel = bx[..., 7:9] if boxes.shape[-1] > 7 else torch.zeros(b, m, 2, dtype=torch.float64, device=boxes.device)
    return {
        "heatmap": heat.permute(0, 2, 3, 1),
        "cell": (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)),
        "valid": valid,
        "offset": torch.stack([px - cx, py - cy], -1),
        "size": bx[..., 3:6],
        "rot": torch.stack([torch.sin(yaw), torch.cos(yaw)], -1),
        "vel": vel,
    }


def loss(preds: Dict[str, torch.Tensor], t: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The total CenterNet loss (f32 predictions, float64 targets)."""
    p = torch.sigmoid(preds["heatmap"].float()).clamp(1e-4, 1 - 1e-4)  # Q2: sigmoid twice
    gt = t["heatmap"].float()
    pos = (gt == 1.0).float()
    neg_w = torch.pow(1.0 - gt, 4) * (gt < 1.0).float()
    pos_loss = (torch.log(p) * (1 - p) ** 2 * pos).sum()
    neg_loss = (torch.log(1 - p) * p ** 2 * neg_w).sum()
    n_pos = pos.sum()
    focal = -neg_loss if float(n_pos) == 0 else -(pos_loss + neg_loss) / n_pos
    total = LOSS_WEIGHTS[0] * focal
    valid = t["valid"].float()
    b = valid.shape[0]
    for weight, name in zip(LOSS_WEIGHTS[1:], ("offset", "size", "rot", "vel")):
        m = preds[name].float()
        c = m.shape[-1]
        got = torch.gather(m.reshape(b, -1, c), 1, t["cell"][..., None].expand(-1, -1, c))
        err = ((got - t[name].float()).abs() * valid[..., None]).sum()
        total = total + weight * err / (valid.sum() * c + 1e-4)
    return total


class AdamW:
    """AdamW with bias correction and decoupled weight decay."""

    def __init__(self, lr: float, betas: Tuple[float, float], eps: float, weight_decay: float):
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, weight_decay
        self.t, self.m, self.v = 0, {}, {}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                m = self.m[k] = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
                v = self.v[k] = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
                p = params[k]
                p.mul_(1 - self.lr * self.wd)
                p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def clip(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values()))
    if float(norm) < max_norm:
        return grads
    return {k: g * (max_norm / float(norm)) for k, g in grads.items()}


def train_steps(spec: Spec, variables: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
                lr: float, betas, eps: float, weight_decay: float, max_norm: float) -> Dict:
    """Steps over `batches` (each: cams uint8, lidar, radar, boxes, labels on
    the device) from a copy of `variables`. Returns each step's loss, the
    first step's clipped gradient (by name) and each parameter's change
    over all the steps."""
    params = {k: v.detach().clone() for k, v in variables.items() if k.startswith("params/")}
    stats = {k: v for k, v in variables.items() if not k.startswith("params/")}
    start = {k: v.clone() for k, v in params.items()}
    opt = AdamW(lr, betas, eps, weight_decay)
    losses, first = [], None
    with exact_float32():
        for batch in batches:
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            fwd = Forward(spec, {**leaves, **stats}, train=True)
            preds = fwd(normalize_uint8(batch["cams"]), batch["lidar"], batch["radar"], batch.get("cells"))
            total = loss(preds, targets(spec, batch["boxes"], batch["labels"]))
            grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g.detach().float() for k, g in grads.items()}
            for p in params.values():
                p.requires_grad_(False)
            grads = clip(grads, max_norm)
            if first is None:
                first = grads
            opt.step(params, grads)
            losses.append(float(total.detach()))
    return {"losses": losses, "first_grad": first,
            "change": {k: params[k] - start[k] for k in params}}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: math.sqrt(float(t.double().pow(2).sum())) for k, t in tensors.items()}
