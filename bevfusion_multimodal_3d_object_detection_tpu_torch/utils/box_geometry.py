"""3D box geometry: corners, camera projection and the LiDAR-to-camera
transforms from the stored nuScenes calibrations (host-side numpy).

The port's own copy of
``bevfusion_multimodal_3d_object_detection_tpu/utils/box_geometry.py:14-91``:
`box_corners_3d` and `project_box_to_image` draw the inference engine's
camera panel; `cam_to_lidar_transform` and `lidar_to_cam_transform` give
`data.dataset.NuScenesDataset` its ``cam_front_projection``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..data.converter import quat_rotation_matrix


def box_corners_3d(box7: np.ndarray) -> np.ndarray:
    """[x, y, z, w, l, h, yaw] -> (8, 3) corners in the box's (LiDAR) frame:
    w along x at yaw 0, l along y, z at the box center."""
    x, y, z, w, l, h, yaw = box7[:7]
    dx, dy, dz = w / 2.0, l / 2.0, h / 2.0
    corners = np.array(
        [
            [dx, dy, dz], [dx, dy, -dz], [dx, -dy, dz], [dx, -dy, -dz],
            [-dx, dy, dz], [-dx, dy, -dz], [-dx, -dy, dz], [-dx, -dy, -dz],
        ]
    )
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return corners @ rot.T + np.array([x, y, z])


# box edges as corner-index pairs (for drawing)
BOX_EDGES = [
    (0, 1), (2, 3), (4, 5), (6, 7),  # vertical
    (0, 2), (1, 3), (4, 6), (5, 7),  # along l
    (0, 4), (1, 5), (2, 6), (3, 7),  # along w
]


def project_box_to_image(
    box7: np.ndarray,
    intrinsic: np.ndarray,
    lidar_to_cam_rot: np.ndarray,
    lidar_to_cam_trans: np.ndarray,
    image_hw: Tuple[int, int],
) -> Optional[np.ndarray]:
    """(8, 2) pixel corners of a LiDAR-frame box, or None when the box is
    behind the camera or every corner is outside the image."""
    corners = box_corners_3d(np.asarray(box7, np.float64))
    cam = corners @ lidar_to_cam_rot.T + lidar_to_cam_trans
    if cam[:, 2].max() <= 0.1:  # fully behind the camera
        return None
    z = np.clip(cam[:, 2], 0.1, None)
    uv = ((cam / z[:, None]) @ np.asarray(intrinsic, np.float64).T)[:, :2]
    h, w = image_hw
    if (
        (uv[:, 0] < 0).all() or (uv[:, 0] >= w).all()
        or (uv[:, 1] < 0).all() or (uv[:, 1] >= h).all()
    ):
        return None
    return uv


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
