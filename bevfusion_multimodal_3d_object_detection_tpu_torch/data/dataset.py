"""Calibration to splat plans, and batch collation, for the geometric path.

Port of the calibration-to-plan part of
``bevfusion_multimodal_3d_object_detection_tpu/data/dataset.py`` (numpy,
the port's own copies):

- `quat_rotation_matrix` (``data/converter.py:56-88``);
- `frustum_cells` (``NuScenesDataset._frustum_cells``, ``:535-570``): a
  sample's (N_cam, D, H', W') frustum cell ids from its nuScenes info dict;
- `chunk_plans` (``NuScenesDataset._chunk_plans``, ``:466-489``): per-camera
  chunk plans, cached by the cells' bytes in a dict the caller keeps
  (calibrations repeat across a scene);
- `collate_fn` (``:627-652``): stacks the model inputs, the frustum cells
  and the chunk plans of a list of samples into one batch.

The loader, image decoding and the culled pair plans are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import CAMERA_ORDER
from ..ops.bev_pool import precompute_bev_chunks
from ..ops.bev_splat import precompute_frustum_cells

CHUNK_KEYS = ("point_idx", "local_ids", "block_idx")
_BATCH_KEYS = (
    "camera_imgs", "lidar_points", "radar_points", "camera_cells",
    *(f"camera_{k}" for k in CHUNK_KEYS),
)


def quat_rotation_matrix(q: Sequence[float]) -> np.ndarray:
    """[w, x, y, z] quaternion (normalized here) -> (3, 3) rotation."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def frustum_cells(
    info: Dict,
    image_size: Tuple[int, int],
    bev_hw: Tuple[int, int],
    depth_bins: int,
    depth_min: float,
    depth_max: float,
    pc_range: Tuple[float, ...],
) -> np.ndarray:
    """(N_cam, D, H', W') int32 BEV cell of every frustum point of the six
    cameras of one sample info (-1 out of range). Intrinsics are scaled from
    the native 1600x900 nuScenes images to `image_size`; the feature grid is
    the camera trunk's stride 16."""
    h, w = image_size
    fh, fw = h // 16, w // 16
    depths = np.linspace(depth_min, depth_max, depth_bins)
    lc = info["lidar_calibrated_sensor"]
    lidar_rot = quat_rotation_matrix(lc["rotation"])  # lidar -> ego
    lidar_trans = np.asarray(lc["translation"], np.float64)
    out = []
    for cam in CAMERA_ORDER:
        cs = info["cams"][cam]["calibrated_sensor"]
        intr = np.asarray(cs["camera_intrinsic"], np.float64)
        cam_rot = quat_rotation_matrix(cs["rotation"])  # camera -> ego
        cam_trans = np.asarray(cs["translation"], np.float64)
        # camera -> lidar = inv(lidar -> ego) . (camera -> ego)
        rot = lidar_rot.T @ cam_rot
        trans = lidar_rot.T @ (cam_trans - lidar_trans)
        scale = np.diag([w / 1600.0, h / 900.0, 1.0])
        out.append(
            precompute_frustum_cells(
                scale @ intr, rot, trans, feat_hw=(fh, fw), image_hw=(h, w),
                depth_bins=depths, bev_hw=bev_hw, pc_range=pc_range,
            )
        )
    return np.stack(out)


def chunk_plans(camera_cells: np.ndarray, num_cells: int,
                cache: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """(N_cam, D, H', W') cells -> {point_idx, local_ids: (N_cam, n_chunks,
    T), block_idx: (N_cam, n_chunks)} int32, one plan per camera.

    `cache`, a dict the caller keeps (one per dataset, say), holds the plans
    by the cells' bytes, since calibrations repeat across a scene; it is
    emptied past 256 plans to bound host memory."""
    per_cam = []
    for cam_cells in camera_cells:
        key = (num_cells, cam_cells.tobytes())
        plan = None if cache is None else cache.get(key)
        if plan is None:
            plan = precompute_bev_chunks(cam_cells.reshape(-1), num_cells)
            if cache is not None:
                if len(cache) > 256:
                    cache.clear()
                cache[key] = plan
        per_cam.append(plan)
    return {k: np.stack([p[k] for p in per_cam]) for k in CHUNK_KEYS}


def collate_fn(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack the model inputs and, where the samples carry them, the frustum
    cells and the chunk plans (``camera_point_idx``, ``camera_local_ids``,
    ``camera_block_idx``) along a new batch axis."""
    return {k: np.stack([s[k] for s in samples]) for k in _BATCH_KEYS if k in samples[0]}
