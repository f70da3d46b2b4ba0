"""The port's nuScenes submission export against the JAX package's: the
same detections and infos give the same submission.json (exactly), and the
port's LiDAR -> global transform inverts a global -> LiDAR transform built
from its own quaternion helpers (`sensor_to_global`, `quat_inverse`,
`quat_yaw`) to 1e-9."""

import json

import numpy as np
import pytest

from bevfusion_multimodal_3d_object_detection_tpu.data import converter as jax_converter
from bevfusion_multimodal_3d_object_detection_tpu.utils import submission as jax_submission
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import converter
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import submission


def _pose(rng, planar=False):
    q = rng.randn(4)
    if planar:
        q[1:3] = 0.0
    return {"rotation": list(converter.quat_normalize(q)), "translation": list(rng.uniform(-5, 5, 3))}


def _case(seed):
    rng = np.random.RandomState(seed)
    infos = [{"token": f"tok{i}", "lidar_pose": _pose(rng), "lidar_calibrated_sensor": _pose(rng)}
             for i in range(3)]
    dets = [
        {"boxes": rng.randn(4, 7).astype(np.float32), "scores": rng.uniform(0, 1, 4).astype(np.float32),
         "labels": np.array([0, 3, 7, 9]), "velocities": rng.randn(4, 2).astype(np.float32)},
        {"boxes": np.zeros((0, 7), np.float32), "scores": np.zeros(0, np.float32),
         "labels": np.zeros(0, np.int64)},
        {"boxes": rng.randn(2, 7), "scores": np.array([0.3, 0.2]), "labels": np.array([1, 2])},  # no velocities
    ]
    return dets, infos


@pytest.mark.parametrize("seed", [0, 1])
def test_export_matches_jax(seed, tmp_path):
    dets, infos = _case(seed)
    got = submission.export_nuscenes_submission(dets, infos, str(tmp_path / "port.json"), use_radar=False,
                                                max_boxes_per_sample=3)
    want = jax_submission.export_nuscenes_submission(dets, infos, str(tmp_path / "jax.json"), use_radar=False,
                                                     max_boxes_per_sample=3)
    assert got == want
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert json.loads((tmp_path / "port.json").read_text())["meta"] == {
        "use_camera": True, "use_lidar": True, "use_radar": False, "use_map": False, "use_external": False}
    assert [len(v) for v in got["results"].values()] == [3, 0, 2]
    with pytest.raises(ValueError, match="one detection dict per info"):
        submission.export_nuscenes_submission(dets[:2], infos, str(tmp_path / "x.json"))


@pytest.mark.parametrize("rotate_velocity", [False, True])
def test_detection_to_global_matches_jax(rotate_velocity):
    rng = np.random.RandomState(2)
    for _ in range(10):
        calib, pose = _pose(rng), _pose(rng)
        box, vel = rng.randn(7), rng.randn(2)
        got = submission.detection_to_global(box, vel, calib, pose, rotate_velocity=rotate_velocity)
        want = jax_submission.detection_to_global(box, vel, calib, pose, rotate_velocity=rotate_velocity)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(3)
    for _ in range(10):
        a, b = rng.randn(4), rng.randn(4)
        for name in ("quat_normalize", "quat_inverse", "quat_rotation_matrix", "quat_yaw"):
            assert np.array_equal(getattr(converter, name)(a), getattr(jax_converter, name)(a)), name
        assert np.array_equal(converter.quat_multiply(a, b), jax_converter.quat_multiply(a, b))
        pose, calib = _pose(rng), _pose(rng)
        for g, w in zip(converter.sensor_to_global(pose, calib), jax_converter.sensor_to_global(pose, calib)):
            assert np.array_equal(g, w)


def test_lidar_to_global_roundtrip():
    """A global box taken to the LiDAR frame with the inverse of
    `sensor_to_global` comes back from `detection_to_global`: centre to
    1e-9, and for planar poses the yaw too."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        pose, calib = _pose(rng, planar=True), _pose(rng, planar=True)
        rot, trans = converter.sensor_to_global(pose, calib)
        center_g = rng.uniform(-100, 100, 3)
        yaw_g = rng.uniform(-np.pi, np.pi)
        c_lidar = rot.T @ (center_g - trans)
        q_sensor = converter.quat_multiply(pose["rotation"], calib["rotation"])
        q_lidar = converter.quat_multiply(converter.quat_inverse(q_sensor),
                                          [np.cos(yaw_g / 2), 0, 0, np.sin(yaw_g / 2)])
        yaw_lidar = converter.quat_yaw(q_lidar)
        box7 = np.array([*c_lidar, 1.9, 4.5, 1.7, yaw_lidar])
        center, size, quat, vel = submission.detection_to_global(box7, np.array([1.0, 2.0]), calib, pose)
        np.testing.assert_allclose(center, center_g, rtol=0, atol=1e-9)
        np.testing.assert_allclose(size, [1.9, 4.5, 1.7])
        np.testing.assert_allclose(vel, [1.0, 2.0])  # global velocities pass through
        d = converter.quat_yaw(quat) - yaw_g
        assert abs(np.arctan2(np.sin(d), np.cos(d))) < 1e-9
