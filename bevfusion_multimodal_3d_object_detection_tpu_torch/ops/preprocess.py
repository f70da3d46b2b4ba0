"""Batched input preprocessing on the device.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/preprocess.py``:

- `normalize_images` (``:35-50``): the uint8 wire's resize and ImageNet
  normalization;
- `filter_pad_points` (``:53-96``): the strict range filter, valid points
  packed to the front in their original order, zero padding or truncation
  to `max_points`; a random subset of the valid points with a generator;
- `preprocess_radar_noise` (``:99-107``): the reference's Gaussian stand-in
  radar points (quirk Q4).

Where JAX takes a PRNG key, the port takes a `torch.Generator` on the
tensors' device; the two draw different numbers from the same seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..data.dataset import IMAGENET_MEAN, IMAGENET_STD
from ..models.fusion import bilinear_resize


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


def filter_pad_points(
    points: torch.Tensor,
    max_points: int = 35000,
    out_channels: int = 4,
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(B, N, C) raw points -> (B, max_points, out_channels) float32: the
    points strictly inside `pc_range` (the reference's > / < tests) packed
    to the front, then zeros. Without a generator the first `max_points`
    valid points are kept in their original order; with one, a random
    subset of the valid points, in random order."""
    x0, y0, z0, x1, y1, z1 = pc_range
    b, n, _ = points.shape
    pts = points[..., :out_channels].float()
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    valid = (x > x0) & (x < x1) & (y > y0) & (y < y1) & (z > z0) & (z < z1)  # (B, N)
    if generator is None:
        # a stable sort of the invalid flags keeps the valid points in order
        order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    else:
        priority = torch.rand((b, n), generator=generator, device=points.device)
        order = torch.argsort(torch.where(valid, priority, 2.0), dim=1)
    packed = torch.take_along_dim(pts, order[..., None], dim=1)
    packed_valid = torch.take_along_dim(valid, order, dim=1)
    packed = torch.where(packed_valid[..., None], packed, 0.0)
    if n >= max_points:
        return packed[:, :max_points]
    return torch.nn.functional.pad(packed, (0, 0, 0, max_points - n))


def preprocess_radar_noise(
    generator: torch.Generator, batch: int, num_radars: int = 5, max_points: int = 125,
    channels: int = 7,
) -> torch.Tensor:
    """(batch, num_radars, max_points, channels) float32 standard normal on
    the generator's device: the reference's dummy radar points (quirk Q4,
    ref: train_detect.py:173-177)."""
    return torch.randn(
        (batch, num_radars, max_points, channels), generator=generator, device=generator.device,
    )
