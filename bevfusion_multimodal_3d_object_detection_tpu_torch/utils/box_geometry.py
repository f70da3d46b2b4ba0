"""LiDAR-to-camera transforms from the stored nuScenes calibrations.

The port's own copy of ``cam_to_lidar_transform`` and
``lidar_to_cam_transform`` from
``bevfusion_multimodal_3d_object_detection_tpu/utils/box_geometry.py:70-91``,
which `data.dataset.NuScenesDataset` needs for ``cam_front_projection``.
Box corners and projection come with the inference engine (ROADMAP A6).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data.converter import quat_rotation_matrix


def cam_to_lidar_transform(cam_calib: dict, lidar_calib: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t) mapping CAMERA-frame points into the LiDAR frame (both
    calibrations sensor -> ego)."""
    r_cam = quat_rotation_matrix(cam_calib["rotation"])
    t_cam = np.asarray(cam_calib["translation"], np.float64)
    r_lid = quat_rotation_matrix(lidar_calib["rotation"])
    t_lid = np.asarray(lidar_calib["translation"], np.float64)
    # x_lidar = R_lid^T (R_cam x + t_cam - t_lid)
    return r_lid.T @ r_cam, r_lid.T @ (t_cam - t_lid)


def lidar_to_cam_transform(cam_calib: dict, lidar_calib: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t) mapping LiDAR-frame points into the camera frame."""
    rot, trans = cam_to_lidar_transform(cam_calib, lidar_calib)
    return rot.T, -rot.T @ trans
