"""nuScenes -> info pickles (offline data prep), synthetic infos and the
quaternion helpers.

The port's own copies from
``bevfusion_multimodal_3d_object_detection_tpu/data/converter.py``:

- `quat_normalize`, `quat_inverse`, `quat_multiply`, `quat_rotation_matrix`
  and `quat_yaw` (``:56-93``), quaternions [w, x, y, z] as nuScenes stores
  them, and `_Box` (``:96-115``), the devkit's Box as far as the converter
  uses it;
- `ConfigDrivenNuScenesConverter` (``:118-434``): the config-driven
  converter behind the ``data_converter`` CLI, with the reference's ratio
  split (Q11) or the official mini splits (``dataset.split_mode``), the
  substring class match (Q20) or its corrected aliases, prior LiDAR and
  radar sweeps (``dataset.num_sweeps`` / ``radar_num_sweeps``), `save_infos`
  and `show_config`. The nuScenes devkit is imported at the first data
  access and raises a clear ImportError where it is missing;
- `extract_sweeps` (``:552-587``): the prior sweeps of a sample_data token;
- `sensor_to_global` (``:523-532``) and `transform_points_between_sensors`
  (``:535-550``), the ego-motion compensation of multi-sweep loading;
- `write_synthetic_infos` (``:436-515``): ``nuscenes_infos_{split}.pkl``
  files of the converter's schema with seeded GT boxes and no sensor files;
  the same seed and directory give infos equal, value for value, to the JAX
  package's.
"""

from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import CAMERA_ORDER, DEFAULT_CLASSES, RADAR_ORDER, CompatFlags, load_config

# corrected Q20 aliases: nuScenes category substrings the reference's
# `cls in category_name` rule can never hit for these two classes
_CLASS_ALIASES = {
    "traffic_cone": ("trafficcone",),
    "construction_vehicle": ("vehicle.construction",),
}


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


class _Box:
    """The nuScenes devkit's Box as far as the converter uses it: center,
    wlh and quaternion with the same translate and rotate semantics."""

    def __init__(self, center, wlh, quat):
        self.center = np.asarray(center, np.float64)
        self.wlh = np.asarray(wlh, np.float64)
        self.quat = quat_normalize(np.asarray(quat, np.float64))

    def translate(self, t: np.ndarray) -> None:
        self.center = self.center + t

    def rotate(self, q: np.ndarray) -> None:
        self.center = quat_rotation_matrix(q) @ self.center
        self.quat = quat_multiply(q, self.quat)

    @property
    def yaw(self) -> float:
        return quat_yaw(self.quat)


class ConfigDrivenNuScenesConverter:
    """Config-driven converter CLI backend (ref: data_converter.py:19-452)."""

    def __init__(self, config_path: str = "configs/base.yaml"):
        self.config = load_config(config_path)
        d = self.config["dataset"]
        self.version = d.get("version", "v1.0-mini")
        self.data_root = d.get("data_root", "data/nuscenes")
        self.classes: List[str] = list(d.get("classes", []))
        self.pc_range: List[float] = list(d.get("point_cloud_range", [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]))
        self.camera_types: List[str] = list((d.get("cameras", {}) or {}).get("names", []))
        self.radar_types: List[str] = list((d.get("radars", {}) or {}).get("names", []))
        mp = d.get("max_points", {}) or {}
        self.max_lidar_points = mp.get("lidar", 35000)
        self.max_radar_points = mp.get("radar_per_sensor", 125)
        self.split_ratios = d.get("split_ratios", {"train": 0.7, "val": 0.2, "test": 0.1})
        # 'ratio' = reference behavior (quirk Q11); 'official' uses the
        # devkit's mini_train/mini_val scene lists
        self.split_mode = d.get("split_mode", "ratio")
        # >1 adds a 'sweeps' list per info (prior LiDAR sweeps with poses)
        self.num_sweeps = d.get("num_sweeps", 1)
        # >1 adds 'pose' + 'sweeps' to each radar entry
        self.radar_num_sweeps = d.get("radar_num_sweeps", 1)
        # Q20: the substring match drops traffic_cone / construction_vehicle
        # GT; compat.substring_class_matching: false adds the aliases
        self.substring_class_matching = CompatFlags.from_config(self.config).substring_class_matching
        self.out_dir = Path(self.data_root)

        # the devkit loads at the first data access, so --show-config works
        # without it
        self._nusc = None
        print("Configuration loaded successfully!")
        print(f"Dataset: {d.get('name', 'nuscenes')} {self.version}")
        print(f"Classes: {len(self.classes)} classes")
        print(f"Cameras: {len(self.camera_types)}")
        print(f"Radars: {len(self.radar_types)}")

    @property
    def nusc(self):
        if self._nusc is None:
            try:
                from nuscenes.nuscenes import NuScenes
            except ImportError as e:
                raise ImportError(
                    "data conversion requires the `nuscenes-devkit` package "
                    "(pip install nuscenes-devkit) and a local nuScenes "
                    "download; converted pickles from any source with the "
                    "same schema also work directly."
                ) from e
            self._nusc = NuScenes(version=self.version, dataroot=self.data_root, verbose=True)
        return self._nusc

    # -- per-sample extraction -------------------------------------------------
    def get_sample_data(self, sample_token: str) -> Dict:
        nusc = self.nusc
        sample = nusc.get("sample", sample_token)

        lidar_token = sample["data"]["LIDAR_TOP"]
        lidar_data = nusc.get("sample_data", lidar_token)
        lidar_path = os.path.join(nusc.dataroot, lidar_data["filename"])
        lidar_pose = nusc.get("ego_pose", lidar_data["ego_pose_token"])
        lidar_calib = nusc.get("calibrated_sensor", lidar_data["calibrated_sensor_token"])

        cam_infos = {}
        for cam in self.camera_types:
            if cam not in sample["data"]:
                continue
            cam_data = nusc.get("sample_data", sample["data"][cam])
            cam_calib = nusc.get("calibrated_sensor", cam_data["calibrated_sensor_token"])
            cam_infos[cam] = {
                "filename": cam_data["filename"],
                "calibrated_sensor": {
                    "translation": cam_calib["translation"],
                    "rotation": cam_calib["rotation"],
                    "camera_intrinsic": cam_calib["camera_intrinsic"],
                },
            }

        radar_infos = {}
        for radar in self.radar_types:
            if radar not in sample["data"]:
                continue
            radar_data = nusc.get("sample_data", sample["data"][radar])
            radar_calib = nusc.get("calibrated_sensor", radar_data["calibrated_sensor_token"])
            entry = {
                "filename": radar_data["filename"],
                "calibrated_sensor": {
                    "translation": radar_calib["translation"],
                    "rotation": radar_calib["rotation"],
                },
            }
            if self.radar_num_sweeps > 1:
                radar_pose = nusc.get("ego_pose", radar_data["ego_pose_token"])
                entry["pose"] = {
                    "translation": radar_pose["translation"],
                    "rotation": radar_pose["rotation"],
                }
                entry["sweeps"] = extract_sweeps(
                    nusc, sample["data"][radar], self.radar_num_sweeps - 1, path_key="path",
                )
            radar_infos[radar] = entry

        ann = self._get_annotations(sample, lidar_pose, lidar_calib)

        sweeps: List[Dict] = []
        if self.num_sweeps > 1:
            sweeps = extract_sweeps(nusc, lidar_token, self.num_sweeps - 1)

        return {
            "token": sample_token,
            "sweeps": sweeps,
            "timestamp": sample["timestamp"],
            "scene_token": sample["scene_token"],
            "lidar_path": lidar_path,
            "lidar_pose": {
                "translation": lidar_pose["translation"],
                "rotation": lidar_pose["rotation"],
            },
            "lidar_calibrated_sensor": {
                "translation": lidar_calib["translation"],
                "rotation": lidar_calib["rotation"],
            },
            "cams": cam_infos,
            "radars": radar_infos,
            "gt_boxes": ann["gt_boxes"],
            "gt_names": ann["gt_names"],
            "gt_velocity": ann["gt_velocity"],
            "num_lidar_pts": ann["num_lidar_pts"],
            "num_radar_pts": ann["num_radar_pts"],
            "valid_flag": ann["valid_flag"],
        }

    def _get_annotations(self, sample, ego_pose, calib) -> Dict:
        rows = []
        for ann_token in sample["anns"]:
            ann = self.nusc.get("sample_annotation", ann_token)
            name = self._get_class_name(ann["category_name"])
            if name == "unknown":
                continue

            box = _Box(ann["translation"], ann["size"], ann["rotation"])
            # global -> ego -> sensor (ref: data_converter.py:237-247)
            box.translate(-np.asarray(ego_pose["translation"]))
            box.rotate(quat_inverse(ego_pose["rotation"]))
            box.translate(-np.asarray(calib["translation"]))
            box.rotate(quat_inverse(calib["rotation"]))

            c = box.center
            r = self.pc_range
            if not (r[0] <= c[0] <= r[3] and r[1] <= c[1] <= r[4] and r[2] <= c[2] <= r[5]):
                continue

            velocity = self.nusc.box_velocity(ann_token)
            if np.any(np.isnan(velocity)):
                velocity = np.zeros(3)

            rows.append({
                "box7": [c[0], c[1], c[2], box.wlh[0], box.wlh[1], box.wlh[2], box.yaw],
                "name": name,
                "velocity": np.asarray(velocity[:2]),
                "num_lidar_pts": ann.get("num_lidar_pts", 0),
                "num_radar_pts": ann.get("num_radar_pts", 0),
            })

        if not rows:
            return {
                "gt_boxes": np.zeros((0, 7)),
                "gt_names": np.array([]),
                "gt_velocity": np.zeros((0, 2)),
                "num_lidar_pts": np.array([]),
                "num_radar_pts": np.array([]),
                "valid_flag": np.array([], dtype=bool),
            }
        return {
            "gt_boxes": np.array([r["box7"] for r in rows]),
            "gt_names": np.array([r["name"] for r in rows]),
            "gt_velocity": np.array([r["velocity"] for r in rows]),
            "num_lidar_pts": np.array([r["num_lidar_pts"] for r in rows]),
            "num_radar_pts": np.array([r["num_radar_pts"] for r in rows]),
            "valid_flag": np.array([True] * len(rows), dtype=bool),
        }

    def _get_class_name(self, category_name: str) -> str:
        """Substring match (quirk Q20, ref: data_converter.py:265-269); with
        `substring_class_matching` off, also the corrected aliases of
        'movable_object.trafficcone' and 'vehicle.construction'."""
        for cls in self.classes:
            if cls in category_name:
                return cls
        if not self.substring_class_matching:
            for cls, aliases in _CLASS_ALIASES.items():
                if cls in self.classes and any(a in category_name for a in aliases):
                    return cls
        return "unknown"

    # -- splits ------------------------------------------------------------------
    def _get_split_scenes(self, split: str) -> List[str]:
        if self.split_mode == "official":
            # corrected Q11: the devkit's mini_train / mini_val scene lists
            from nuscenes.utils import splits as nusc_splits

            if split == "train":
                return list(nusc_splits.mini_train)
            if split in ("val", "test"):
                return list(nusc_splits.mini_val)
            raise ValueError(f"Unknown split: {split}")

        all_scenes = [s["name"] for s in self.nusc.scene]
        n = len(all_scenes)
        train_end = int(n * self.split_ratios["train"])
        val_end = train_end + int(n * self.split_ratios["val"])
        if split == "train":
            return all_scenes[:train_end]
        if split == "val":
            return all_scenes[train_end:val_end]
        if split == "test":
            return all_scenes[val_end:]
        raise ValueError(f"Unknown split: {split}")

    def convert_split(self, split: str) -> List[Dict]:
        print(f"\nProcessing {split} split...")
        scene_names = set(self._get_split_scenes(split))
        infos: List[Dict] = []
        for scene in self.nusc.scene:
            if scene["name"] not in scene_names:
                continue
            token = scene["first_sample_token"]
            while token:
                try:
                    infos.append(self.get_sample_data(token))
                except Exception as e:  # the reference's fault tolerance (ref :288-292)
                    print(f"Warning: Failed to process sample {token}: {e}")
                token = self.nusc.get("sample", token)["next"]
        print(f"Collected {len(infos)} samples for {split} split")
        return infos

    def save_infos(self, infos: List[Dict], split: str) -> None:
        d = self.config["dataset"]
        key = {"train": "ann_file_train", "val": "ann_file_val", "test": "ann_file_test"}.get(split)
        output_path = Path(d.get(key) if key and d.get(key) else self.out_dir / f"nuscenes_infos_{split}.pkl")
        output_path.parent.mkdir(parents=True, exist_ok=True)
        data = {
            "infos": infos,
            "metadata": {
                "version": self.version,
                "classes": self.classes,
                "num_classes": len(self.classes),
                "point_cloud_range": self.pc_range,
                "cameras": self.camera_types,
                "radars": self.radar_types,
                "max_points": {"lidar": self.max_lidar_points, "radar_per_sensor": self.max_radar_points},
            },
        }
        with open(output_path, "wb") as f:
            pickle.dump(data, f)
        print(f"Saved {len(infos)} samples to {output_path}")

    def show_config(self) -> None:
        print(json.dumps(self.config.get("dataset", {}), indent=2, default=str))


def extract_sweeps(nusc, sample_data_token: str, num_sweeps: int, path_key: str = "lidar_path") -> List[Dict]:
    """Walk sample_data['prev'] collecting up to `num_sweeps` prior sweeps of
    any sensor: {path_key, 'pose', 'calib', 'time_lag_s'} each (`path_key` is
    'lidar_path' for LiDAR, 'path' for radar). Needs a devkit `nusc`."""
    sweeps = []
    sd = nusc.get("sample_data", sample_data_token)
    key_time = sd["timestamp"]
    token = sd["prev"]
    while token and len(sweeps) < num_sweeps:
        sw = nusc.get("sample_data", token)
        pose = nusc.get("ego_pose", sw["ego_pose_token"])
        calib = nusc.get("calibrated_sensor", sw["calibrated_sensor_token"])
        sweeps.append({
            path_key: os.path.join(nusc.dataroot, sw["filename"]),
            "pose": {k: pose[k] for k in ("rotation", "translation")},
            "calib": {k: calib[k] for k in ("rotation", "translation")},
            "time_lag_s": (key_time - sw["timestamp"]) / 1e6,
        })
        token = sw["prev"]
    return sweeps


def sensor_to_global(pose: Dict, calib: Dict):
    """Compose sensor->ego->global into (R, t) from {'rotation': quat,
    'translation': xyz} dicts (nuScenes convention)."""
    r_ego = quat_rotation_matrix(pose["rotation"])
    t_ego = np.asarray(pose["translation"], np.float64)
    r_sens = quat_rotation_matrix(calib["rotation"])
    t_sens = np.asarray(calib["translation"], np.float64)
    # x_global = r_ego @ (r_sens @ x + t_sens) + t_ego
    return r_ego @ r_sens, r_ego @ t_sens + t_ego


def transform_points_between_sensors(
    points: np.ndarray,
    src_pose: Dict, src_calib: Dict,
    dst_pose: Dict, dst_calib: Dict,
) -> np.ndarray:
    """(N, >=3) points from the source sensor's frame at its capture pose
    into the destination sensor's frame, in float32; channels past xyz are
    kept as they are."""
    r_src, t_src = sensor_to_global(src_pose, src_calib)
    r_dst, t_dst = sensor_to_global(dst_pose, dst_calib)
    out = points.copy().astype(np.float32)
    xyz_global = points[:, :3].astype(np.float64) @ r_src.T + t_src
    out[:, :3] = ((xyz_global - t_dst) @ r_dst).astype(np.float32)  # R_dst^T, applied on the right
    return out


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
