"""Training augmentations, on the device inside the train step.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/ops/augment.py``
(``:30-221``), the corrected path of quirk Q14 (the reference declares
augmentation in its config and never applies it): photometric jitter of the
normalized camera images, one y-flip and global scale per sample applied to
the whole scene (LiDAR points, radar returns with their velocities, GT boxes
with yaw and velocities), and gaussian noise on the valid radar returns.
Zero-padded point rows stay exactly zero: the encoders' validity mask keys
off them.

``jax.random`` cannot be replayed by a torch generator, so each transform is
split into a draw from an explicit `torch.Generator` (`draw_color_jitter`,
`draw_flip_scale`, `draw_radar_noise`, all three in `draw_augmentation`) and
an apply from given draws (`color_jitter`, `flip_scale_scene`,
`lidar_flip_scale`, `radar_noise`, `augment_modalities`): the tests feed
JAX's draws to the applies. The train step draws from `step_generator(seed,
step)`, a function of the seed and the step alone, so a resumed run draws
what the uninterrupted run drew.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step) alone (the JAX step's
    ``fold_in(rng, step)``)."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _uniform(generator: torch.Generator, shape, low: float, high: float) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=generator)


def draw_color_jitter(generator: torch.Generator, batch: int, brightness: float = 0.2,
                      contrast: float = 0.2, saturation: float = 0.2) -> torch.Tensor:
    """(3, batch) f32 factors, uniform in [1 - x, 1 + x] for brightness,
    contrast and saturation (torchvision ColorJitter's ranges)."""
    return torch.stack([_uniform(generator, (batch,), 1 - x, 1 + x)
                        for x in (brightness, contrast, saturation)])


def draw_flip_scale(generator: torch.Generator, batch: int, scale_min: float = 0.95,
                    scale_max: float = 1.05) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch,) bool y-flips (p = 0.5) and (batch,) f32 scales, uniform in
    [scale_min, scale_max]."""
    flip = torch.rand((batch,), generator=generator) < 0.5
    return flip, _uniform(generator, (batch,), scale_min, scale_max)


def draw_radar_noise(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal f32 draws of the radar tensor's shape."""
    return torch.randn(tuple(shape), generator=generator)


class AugmentDraws(NamedTuple):
    jitter: torch.Tensor  # (3, B) brightness, contrast, saturation factors
    flip: torch.Tensor  # (B,) bool
    scale: torch.Tensor  # (B,)
    radar_noise: Optional[torch.Tensor]  # standard normal, the radar's shape

    def rows(self, block: slice) -> "AugmentDraws":
        """The draws of the samples in `block`: a data-parallel rank draws
        for the global batch, as the JAX step does, and takes its rows."""
        noise = None if self.radar_noise is None else self.radar_noise[block]
        return AugmentDraws(self.jitter[:, block], self.flip[block], self.scale[block], noise)


def draw_augmentation(generator: torch.Generator, aug, batch: int,
                      radar_shape: Optional[Sequence[int]] = None) -> AugmentDraws:
    """Every draw of one step, in a fixed order whatever is enabled."""
    jitter = draw_color_jitter(generator, batch, aug.brightness, aug.contrast, aug.saturation)
    flip, scale = draw_flip_scale(generator, batch, aug.scale_min, aug.scale_max)
    noise = None if radar_shape is None else draw_radar_noise(generator, radar_shape)
    return AugmentDraws(jitter, flip, scale, noise)


def _per_sample(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) in `like`'s dtype and device."""
    return v.to(like.device, like.dtype).reshape((-1,) + (1,) * (like.ndim - 1))


def color_jitter(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast and saturation of NORMALIZED images (B, ..., H,
    W, 3) by the per-sample factors (3, B): contrast about each image's
    mean, saturation about each pixel's gray."""
    f_b, f_c, f_s = (_per_sample(f, images) for f in factors)
    x = images * f_b
    mean = x.mean(dim=(-3, -2, -1), keepdim=True)
    x = (x - mean) * f_c + mean
    gray = x.mean(dim=-1, keepdim=True)
    return (x - gray) * f_s + gray


def _flip_scale(t: torch.Tensor, sign: torch.Tensor, scale: torch.Tensor,
                flipped: Sequence[int], scaled: Sequence[int]) -> torch.Tensor:
    """`t` with the channels `flipped` times `sign` and then those `scaled`
    times `scale` (both (B,) broadcast over the rest), out of place."""
    sign, scale = _per_sample(sign, t[..., 0]), _per_sample(scale, t[..., 0])
    cols = list(t.unbind(-1))
    for i in flipped:
        cols[i] = cols[i] * sign
    for i in scaled:
        cols[i] = cols[i] * scale
    return torch.stack(cols, dim=-1)


def flip_scale_scene(points: torch.Tensor, gt_boxes: torch.Tensor, radar_points: Optional[torch.Tensor],
                     flip: torch.Tensor, scale: torch.Tensor):
    """One y-flip and global scale per sample applied to LiDAR points
    (B, N, C >= 3), boxes (B, M, 7 or 9) [x, y, z, w, l, h, yaw(, vx, vy)]
    and radar returns (B, R, N, C >= 5) [x, y, z, vx, vy, ...]: y, yaw and
    vy flip; positions, sizes and velocities scale. Multiplicative, so
    zero rows stay zero. Returns (points, boxes, radar)."""
    sign = torch.where(flip, -1.0, 1.0)
    pts = _flip_scale(points, sign, scale, (1,), (0, 1, 2))
    box_scaled = (0, 1, 2, 3, 4, 5) + ((7, 8) if gt_boxes.shape[-1] > 7 else ())
    box_flipped = (1, 6) + ((8,) if gt_boxes.shape[-1] > 7 else ())
    boxes = _flip_scale(gt_boxes, sign, scale, box_flipped, box_scaled)
    radar = radar_points
    if radar is not None:
        wide = radar.shape[-1] > 4
        radar = _flip_scale(radar, sign, scale, (1, 4) if wide else (1,), (0, 1, 2, 3, 4) if wide else (0, 1, 2))
    return pts, boxes, radar


def lidar_flip_scale(points: torch.Tensor, gt_boxes: torch.Tensor, flip: torch.Tensor,
                     scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flip_scale_scene` of the LiDAR points and boxes alone."""
    pts, boxes, _ = flip_scale_scene(points, gt_boxes, None, flip, scale)
    return pts, boxes


def radar_noise(radar_points: torch.Tensor, normal: torch.Tensor, noise_std: float = 0.01) -> torch.Tensor:
    """`noise_std` times the standard normal draws added to the valid (any
    channel nonzero) radar rows only: noise on a padding row would make it
    a phantom return near the origin under the masked max."""
    valid = (radar_points != 0).any(dim=-1, keepdim=True)
    noise = noise_std * normal.to(radar_points.device, radar_points.dtype)
    return radar_points + torch.where(valid, noise, torch.zeros_like(noise))


def augment_modalities(draws: AugmentDraws, cams: Optional[torch.Tensor], lidar: Optional[torch.Tensor],
                       radar: Optional[torch.Tensor], gt_boxes: torch.Tensor, aug,
                       geometry_frozen: bool = False):
    """Which transform touches which modality, in one place: camera jitter,
    the scene's flip and scale when LiDAR is on (skipped under
    `geometry_frozen`: the geometric camera-to-BEV's frustum plans are
    calibration constants the flip cannot move with), radar noise. `aug`
    is an `AugmentSpec`-like object. Returns (cams, lidar, radar, gt_boxes)."""
    if cams is not None and aug.camera_enable:
        cams = color_jitter(cams, draws.jitter)
    if lidar is not None and aug.lidar_enable and not geometry_frozen:
        lidar, gt_boxes, radar = flip_scale_scene(lidar, gt_boxes, radar, draws.flip, draws.scale)
    if radar is not None and aug.radar_enable:
        radar = radar_noise(radar, draws.radar_noise, aug.noise_std)
    return cams, lidar, radar, gt_boxes


class _AugParams:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def augment_batch(
    generator: torch.Generator,
    batch: Dict[str, torch.Tensor],
    camera_enable: bool = True,
    lidar_enable: bool = True,
    radar_enable: bool = True,
    brightness: float = 0.2,
    contrast: float = 0.2,
    saturation: float = 0.2,
    scale_min: float = 0.95,
    scale_max: float = 1.05,
    noise_std: float = 0.01,
) -> Dict[str, torch.Tensor]:
    """`augment_modalities` over a dict batch of tensors, drawing from
    `generator`; the LiDAR points move only when the batch has boxes."""
    aug = _AugParams(
        camera_enable=camera_enable, lidar_enable=lidar_enable, radar_enable=radar_enable,
        brightness=brightness, contrast=contrast, saturation=saturation,
        scale_min=scale_min, scale_max=scale_max, noise_std=noise_std,
    )
    out = dict(batch)
    first = next(v for k, v in out.items() if k in ("camera_imgs", "lidar_points", "radar_points"))
    radar = out.get("radar_points")
    draws = draw_augmentation(generator, aug, first.shape[0], None if radar is None else radar.shape)
    cams, lidar, radar, boxes = augment_modalities(
        draws, out.get("camera_imgs"), out.get("lidar_points") if "gt_boxes" in out else None, radar,
        out.get("gt_boxes", torch.zeros((1, 1, 7))), aug,
    )
    if cams is not None:
        out["camera_imgs"] = cams
    if lidar is not None:
        out["lidar_points"] = lidar
        out["gt_boxes"] = boxes
    if radar is not None:
        out["radar_points"] = radar
    return out
