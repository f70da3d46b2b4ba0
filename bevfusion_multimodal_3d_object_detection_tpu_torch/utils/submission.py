"""The official nuScenes detection submission.

The port's own copy of
``bevfusion_multimodal_3d_object_detection_tpu/utils/submission.py:36-141``:
LiDAR-frame detections go to the GLOBAL frame through each sample's
``lidar_calibrated_sensor`` (lidar -> ego) and ``lidar_pose`` (ego ->
global) from the info pickles, and are written in the ``submission.json``
schema ``{"meta": {...}, "results": {sample_token: [box, ...]}}``.
Quaternions are [w, x, y, z].
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import DEFAULT_CLASSES
from ..data.converter import quat_multiply, quat_normalize, quat_rotation_matrix


def _yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])


def detection_to_global(
    box: np.ndarray,
    velocity: Optional[np.ndarray],
    lidar_calib: Dict,
    lidar_pose: Dict,
    rotate_velocity: bool = False,
):
    """One LiDAR-frame box [x, y, z, w, l, h, yaw] (+ optional [vx, vy]) ->
    (translation[3], size[3] (w, l, h), rotation quat[4] wxyz, velocity[2])
    in the GLOBAL frame.

    `rotate_velocity` is off by default: the converter stores GT velocities
    in the global frame unrotated, so a model trained on them predicts
    global-frame velocities already."""
    q_l2e = quat_normalize(np.asarray(lidar_calib["rotation"], float))
    t_l2e = np.asarray(lidar_calib["translation"], float)
    q_e2g = quat_normalize(np.asarray(lidar_pose["rotation"], float))
    t_e2g = np.asarray(lidar_pose["translation"], float)
    r_l2e = quat_rotation_matrix(q_l2e)
    r_e2g = quat_rotation_matrix(q_e2g)

    center = np.asarray(box[:3], float)
    center = r_e2g @ (r_l2e @ center + t_l2e) + t_e2g
    rotation = quat_normalize(quat_multiply(q_e2g, quat_multiply(q_l2e, _yaw_quat(float(box[6])))))
    if velocity is None:
        vel = np.zeros(2)
    elif rotate_velocity:
        v = np.array([float(velocity[0]), float(velocity[1]), 0.0])
        vel = (r_e2g @ (r_l2e @ v))[:2]
    else:
        vel = np.asarray(velocity[:2], float)
    return center, np.asarray(box[3:6], float), rotation, vel


def export_nuscenes_submission(
    detections: List[Dict[str, np.ndarray]],
    infos: Sequence[Dict],
    path: str,
    classes: Sequence[str] = DEFAULT_CLASSES,
    use_camera: bool = True,
    use_lidar: bool = True,
    use_radar: bool = True,
    max_boxes_per_sample: int = 500,
) -> Dict:
    """Write ``submission.json`` to `path` and return it. `detections[i]`
    (boxes (K, 7+), scores, labels, optional velocities) belongs to the
    sample of `infos[i]` (an info-pickle entry with 'token',
    'lidar_calibrated_sensor', 'lidar_pose'); the official server takes at
    most 500 boxes per sample."""
    if len(detections) != len(infos):
        # the official server rejects a submission that misses sample tokens
        raise ValueError(
            f"submission needs one detection dict per info: got "
            f"{len(detections)} detections for {len(infos)} samples"
        )
    results: Dict[str, List[Dict]] = {}
    for det, info in zip(detections, infos):
        boxes = np.asarray(det["boxes"], float)
        scores = np.asarray(det["scores"], float)
        labels = np.asarray(det["labels"], int)
        vels = det.get("velocities")
        entries = []
        for k in range(min(len(scores), max_boxes_per_sample)):
            center, size, rot, vel = detection_to_global(
                boxes[k], None if vels is None else np.asarray(vels)[k],
                info["lidar_calibrated_sensor"], info["lidar_pose"],
            )
            entries.append({
                "sample_token": info["token"],
                "translation": [float(x) for x in center],
                "size": [float(x) for x in size],
                "rotation": [float(x) for x in rot],
                "velocity": [float(x) for x in vel],
                "detection_name": classes[int(labels[k])],
                "detection_score": float(scores[k]),
                "attribute_name": "",
            })
        results[info["token"]] = entries
    submission = {
        "meta": {
            "use_camera": bool(use_camera),
            "use_lidar": bool(use_lidar),
            "use_radar": bool(use_radar),
            "use_map": False,
            "use_external": False,
        },
        "results": results,
    }
    with open(path, "w") as f:
        json.dump(submission, f)
    return submission
