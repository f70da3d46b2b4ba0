"""CenterNet detection head (PyTorch, NCHW).

Port of ``bevfusion_multimodal_3d_object_detection_tpu/models/heads.py:26-93``:
five independent conv3x3 -> ReLU -> conv1x1 branches over the BEV map.
Weights N(0, 0.001), zero biases, heatmap output bias -log((1-p)/p) with
p = 0.01; the heatmap is sigmoided inside the forward (as the reference).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CenterNetHeadSpec

HEAD_STD = 0.001
HEATMAP_BIAS = -math.log((1 - 0.01) / 0.01)


class _Branch(nn.Module):
    def __init__(self, in_channels: int, head_conv: int, out_channels: int,
                 final_bias: float = 0.0):
        super().__init__()
        self.final_bias = final_bias
        self.conv1 = nn.Conv2d(in_channels, head_conv, 3, 1, 1)
        self.conv2 = nn.Conv2d(head_conv, out_channels, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for conv, bias in ((self.conv1, 0.0), (self.conv2, self.final_bias)):
                conv.weight.normal_(0.0, HEAD_STD, generator=generator)
                conv.bias.fill_(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class CenterNetHead(nn.Module):
    """(B, C_in, H, W) -> dict of NCHW maps: heatmap (num_classes,
    sigmoided), offset (2), size (3), rot (2), vel (2)."""

    def __init__(self, spec: CenterNetHeadSpec = CenterNetHeadSpec()):
        super().__init__()
        self.spec = spec
        c, hc = spec.in_channels, spec.head_conv
        self.heatmap_head = _Branch(c, hc, spec.num_classes, HEATMAP_BIAS)
        self.offset_head = _Branch(c, hc, 2)
        self.size_head = _Branch(c, hc, 3)
        self.rot_head = _Branch(c, hc, 2)
        self.vel_head = _Branch(c, hc, 2)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for branch in self.children():
            branch.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {
            "heatmap": torch.sigmoid(self.heatmap_head(x)),
            "offset": self.offset_head(x),
            "size": self.size_head(x),
            "rot": self.rot_head(x),
            "vel": self.vel_head(x),
        }
