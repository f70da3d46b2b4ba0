"""Device-side image normalization for the uint8 wire.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/preprocess.py:35-50``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.fusion import bilinear_resize

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images(images: torch.Tensor, size: Tuple[int, int] = (448, 800)) -> torch.Tensor:
    """(..., h0, w0, 3) uint8 or float -> (..., H, W, 3) float32:
    /255, bilinear resize to `size` when it differs, ImageNet normalize."""
    x = images.float() / 255.0
    h, w = size
    if x.shape[-3] != h or x.shape[-2] != w:
        lead = x.shape[:-3]
        nchw = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
        x = bilinear_resize(nchw, h, w).permute(0, 2, 3, 1).reshape(lead + (h, w, 3))
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std
