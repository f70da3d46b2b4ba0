"""Seeded inputs: samples, ground truth and the six-camera ring
calibration, made on the device in a few large draws.

The shapes and value ranges follow the repository's own synthetic traffic
(``chip_smoke.py``: `lidar_points`, `radar_points`, `gt_rows`,
`ring_camera_cells`): uint8 cameras, LiDAR points (x, y, z, intensity)
inside the point-cloud range padded with zero rows to a fixed count, radar
points N(0, 1) in 7 channels padded likewise, and boxes inside 0.95 of the
grid. What varies with the seed is the content and the number of real
points and boxes, never a shape.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named use of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def samples(spec, n: int, seed: int, device, lidar_real: Sequence[int], radar_real: Sequence[int],
            stream: int = 1) -> List[Dict[str, np.ndarray]]:
    """`n` samples as host numpy dicts: ``camera_imgs`` (6, H, W, 3) uint8,
    ``lidar_points`` (N_l, 4) f32 with U[lidar_real] real rows, then zeros,
    ``radar_points`` (R, N_r, 7) f32 with U[radar_real] real rows per radar."""
    g, rng = generator(seed, stream, device), host_rng(seed, stream)
    h, w = spec.image_hw
    cams = torch.randint(0, 256, (n, spec.num_cameras, h, w, 3), generator=g, device=device, dtype=torch.uint8)
    x0, y0, z0, x1, y1, z1 = spec.pc_range
    lo = torch.tensor([x0, y0, z0, 0.0], device=device)
    hi = torch.tensor([x1, y1, z1, 1.0], device=device)
    lidar = lo + (hi - lo) * torch.rand((n, spec.lidar_points, spec.lidar_in), generator=g, device=device)
    n_l = rng.integers(lidar_real[0], lidar_real[1] + 1, n)
    rows = torch.arange(spec.lidar_points, device=device)
    lidar = torch.where(rows[None, :, None] < torch.as_tensor(n_l, device=device)[:, None, None], lidar, 0.0)
    radar = torch.randn((n, spec.num_radars, spec.radar_points, spec.radar_in), generator=g, device=device)
    n_r = rng.integers(radar_real[0], radar_real[1] + 1, (n, spec.num_radars))
    rrows = torch.arange(spec.radar_points, device=device)
    radar = torch.where(rrows[None, None, :, None] < torch.as_tensor(n_r, device=device)[:, :, None, None],
                        radar, 0.0)
    cams, lidar, radar = cams.cpu().numpy(), lidar.cpu().numpy(), radar.cpu().numpy()
    return [{"camera_imgs": cams[i], "lidar_points": lidar[i], "radar_points": radar[i]} for i in range(n)]


def gt_boxes(spec, b: int, m: int, real: Sequence[int], seed: int, stream: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """(b, m, 7) boxes [x y z w l h yaw] and (b, m) labels: U[real] boxes a
    sample inside 0.95 of the grid, the other rows zero with label -1."""
    rng = host_rng(seed, stream)
    boxes = np.zeros((b, m, 7), np.float32)
    labels = np.full((b, m), -1, np.int64)
    x0, y0, _, x1, y1, _ = spec.pc_range
    for i in range(b):
        k = int(rng.integers(real[0], real[1] + 1))
        boxes[i, :k, 0] = rng.uniform(0.95 * x0, 0.95 * x1, k)
        boxes[i, :k, 1] = rng.uniform(0.95 * y0, 0.95 * y1, k)
        boxes[i, :k, 2] = rng.uniform(-2.0, 1.0, k)
        boxes[i, :k, 3:6] = rng.uniform(0.5, 5.0, (k, 3))
        boxes[i, :k, 6] = rng.uniform(-np.pi, np.pi, k)
        labels[i, :k] = rng.integers(0, 10, k)
    return boxes, labels


def ring_calibration(spec) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(intrinsics, camera->LiDAR rotation, translation) of six cameras on a
    ring: yaw k * 60 degrees, f = 1200 and c = (800, 450) applied to the
    input image as it is, z-forward camera axes turned to x-forward."""
    intr = np.array([[1200.0, 0, 800], [0, 1200.0, 450], [0, 0, 1]])
    base = np.array([[0, 0, 1.0], [-1.0, 0, 0], [0, -1.0, 0]])
    out = []
    for k in range(spec.num_cameras):
        yaw = k * np.pi / 3
        rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        out.append((intr, rz @ base, np.zeros(3)))
    return out
