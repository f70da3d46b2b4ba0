"""Synthetic nuScenes info files and the quaternion helpers.

The port's own copies from
``bevfusion_multimodal_3d_object_detection_tpu/data/converter.py``:

- `quat_normalize`, `quat_inverse`, `quat_multiply`, `quat_rotation_matrix`
  and `quat_yaw` (``:56-93``), quaternions [w, x, y, z] as nuScenes stores
  them;
- `sensor_to_global` (``:523-532``);
- `write_synthetic_infos` (``:436-515``): ``nuscenes_infos_{split}.pkl``
  files of the converter's schema with seeded GT boxes and no sensor files;
  the same seed and directory give infos equal, value for value, to the JAX
  package's.

The nuScenes devkit conversion itself is not ported (ROADMAP A4).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import CAMERA_ORDER, DEFAULT_CLASSES, RADAR_ORDER


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def quat_inverse(q: np.ndarray) -> np.ndarray:
    """Inverse of a unit quaternion [w, x, y, z] = conjugate."""
    q = quat_normalize(np.asarray(q, np.float64))
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_rotation_matrix(q: Sequence[float]) -> np.ndarray:
    """[w, x, y, z] quaternion (normalized here) -> (3, 3) rotation."""
    w, x, y, z = quat_normalize(np.asarray(q, np.float64))
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_yaw(q: np.ndarray) -> float:
    """Yaw of [w, x, y, z] (pyquaternion yaw_pitch_roll convention)."""
    w, x, y, z = quat_normalize(np.asarray(q, np.float64))
    return float(np.arctan2(2 * (w * z - x * y), 1 - 2 * (y * y + z * z)))


def sensor_to_global(pose: Dict, calib: Dict):
    """Compose sensor->ego->global into (R, t) from {'rotation': quat,
    'translation': xyz} dicts (nuScenes convention)."""
    r_ego = quat_rotation_matrix(pose["rotation"])
    t_ego = np.asarray(pose["translation"], np.float64)
    r_sens = quat_rotation_matrix(calib["rotation"])
    t_sens = np.asarray(calib["translation"], np.float64)
    # x_global = r_ego @ (r_sens @ x + t_sens) + t_ego
    return r_ego @ r_sens, r_ego @ t_sens + t_ego


def write_synthetic_infos(
    out_dir: str,
    splits: Optional[Sequence[str]] = None,
    samples_per_split: int = 8,
    classes: Optional[Sequence[str]] = None,
    seed: int = 0,
) -> None:
    """Write schema-identical pickles with synthetic GT (no image or point
    files: the camera, LiDAR and radar paths name files that are not there)."""
    classes = list(classes or DEFAULT_CLASSES)
    rng = np.random.RandomState(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for split in splits or ("train", "val", "test"):
        infos = []
        for i in range(samples_per_split):
            n = rng.randint(1, 10)
            boxes = np.zeros((n, 7))
            boxes[:, 0:2] = rng.uniform(-45, 45, (n, 2))
            boxes[:, 2] = rng.uniform(-2, 1, n)
            boxes[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
            infos.append({
                "token": f"{split}_{i}",
                "timestamp": 0,
                "scene_token": f"scene_{i % 2}",
                "lidar_path": str(out / f"{split}_{i}_lidar.bin"),
                "lidar_pose": {"translation": [0, 0, 0], "rotation": [1, 0, 0, 0]},
                "lidar_calibrated_sensor": {"translation": [0, 0, 0], "rotation": [1, 0, 0, 0]},
                "cams": {
                    c: {"filename": f"{split}_{i}_{c}.jpg",
                        "calibrated_sensor": {
                            "translation": [0, 0, 0],
                            "rotation": [1, 0, 0, 0],
                            "camera_intrinsic": np.eye(3).tolist(),
                        }}
                    for c in CAMERA_ORDER
                },
                "radars": {
                    r: {"filename": f"{split}_{i}_{r}.pcd",
                        "calibrated_sensor": {"translation": [0, 0, 0], "rotation": [1, 0, 0, 0]}}
                    for r in RADAR_ORDER
                },
                "gt_boxes": boxes,
                "gt_names": np.array([classes[rng.randint(len(classes))] for _ in range(n)]),
                "gt_velocity": np.zeros((n, 2)),
                "num_lidar_pts": np.ones(n, int),
                "num_radar_pts": np.ones(n, int),
                "valid_flag": np.ones(n, bool),
            })
        with open(out / f"nuscenes_infos_{split}.pkl", "wb") as f:
            pickle.dump({
                "infos": infos,
                "metadata": {
                    "version": "v1.0-mini",
                    "classes": classes,
                    "num_classes": len(classes),
                    "point_cloud_range": [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0],
                    "cameras": list(CAMERA_ORDER),
                    "radars": list(RADAR_ORDER),
                    "max_points": {"lidar": 35000, "radar_per_sensor": 125},
                },
            }, f)
