"""Shared helpers for the port's loader, checkpoint and trainer tests: a
synthetic nuScenes tree written from a seed (infos by the port's
`write_synthetic_infos`, JPEG cameras, LiDAR bins) and a narrow config of
the repo's base.yaml that points at it."""

import copy
import pathlib
import pickle

import numpy as np

from bevfusion_multimodal_3d_object_detection_tpu_torch.config import load_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.converter import write_synthetic_infos

ROOT = pathlib.Path(__file__).resolve().parents[1]


def lidar_cloud(rng, n_points):
    """(n_points, 5) float32 [x, y, z, intensity, ring]: about 70 % inside
    the default point cloud range."""
    pts = np.empty((n_points, 5), np.float32)
    pts[:, :2] = rng.uniform(-60.0, 60.0, (n_points, 2))
    pts[:, 2] = rng.uniform(-6.0, 4.0, n_points)
    pts[:, 3] = rng.uniform(0.0, 255.0, n_points)
    pts[:, 4] = rng.randint(0, 32, n_points)
    return pts


def write_radar_pcd(path, pts):
    """A binary nuScenes-style radar .pcd of (N, 6) [x, y, z, vx, vy, rcs]
    points, with an integer field between them as the real files have."""
    n = len(pts)
    fields = [("x", "F", 4), ("y", "F", 4), ("z", "F", 4), ("id", "I", 2), ("rcs", "F", 4),
              ("vx", "F", 4), ("vy", "F", 4)]
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format", "VERSION 0.7",
        "FIELDS " + " ".join(f[0] for f in fields), "SIZE " + " ".join(str(f[2]) for f in fields),
        "TYPE " + " ".join(f[1] for f in fields), "COUNT " + " ".join("1" for _ in fields),
        f"WIDTH {n}", "HEIGHT 1", "VIEWPOINT 0 0 0 1 0 0 0", f"POINTS {n}", "DATA binary",
    ]) + "\n"
    rec = np.zeros(n, np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"), ("id", "i2"), ("rcs", "f4"),
                                ("vx", "f4"), ("vy", "f4")]))
    for i, name in enumerate(("x", "y", "z", "vx", "vy", "rcs")):
        rec[name] = pts[:, i]
    rec["id"] = np.arange(n)
    pathlib.Path(path).write_bytes(header.encode() + rec.tobytes())


def write_test_tree(data_root, samples_per_split=4, image_hw=(36, 60), n_points=500, seed=0,
                  splits=("train", "val"), radar_points=0):
    """Infos for `splits` under `data_root`, and their sensor files: six
    RGB JPEGs of `image_hw`, a LiDAR .bin of `n_points` five-float points
    (`lidar_cloud`) and, with `radar_points`, five radar .pcd files of that
    many points per sample."""
    from PIL import Image

    data_root = pathlib.Path(data_root)
    write_synthetic_infos(str(data_root), splits=splits, samples_per_split=samples_per_split, seed=seed)
    rng = np.random.RandomState(seed + 1)
    for split in splits:
        with open(data_root / f"nuscenes_infos_{split}.pkl", "rb") as f:
            infos = pickle.load(f)["infos"]
        for info in infos:
            lidar_cloud(rng, n_points).tofile(info["lidar_path"])
            for cam in info["cams"].values():
                Image.fromarray(rng.randint(0, 255, (*image_hw, 3), np.uint8)).save(
                    data_root / cam["filename"])
            if radar_points:
                for radar in info["radars"].values():
                    write_radar_pcd(data_root / radar["filename"],
                                    rng.randn(radar_points, 6).astype(np.float32) * 10)
    return data_root


def tree_config(tmp_path, data_root, modality="camera+lidar+radar", **train):
    """base.yaml at test size (32x64 cameras, 256 LiDAR and 16 radar points,
    narrow MLPs, a 16x16 BEV grid of 32 channels), reading `data_root` and
    writing under `tmp_path`; `train` overrides keys of the train block.
    The LiDAR branch's 512 -> 128x25x25 dense layer (41 M parameters) has no
    config key, so a `modality` without LiDAR keeps checkpoints small."""
    cfg = copy.deepcopy(load_config(str(ROOT / "configs" / "base.yaml")))
    d, m, t = cfg["dataset"], cfg["model"], cfg["train"]
    m["modality_config"] = modality
    d["data_root"] = str(data_root)
    d["cameras"]["image_size"] = [32, 64]
    d["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    d["bev_h"] = d["bev_w"] = 16
    m["camera_encoder"].update(input_size=[32, 64], output_channels=32)
    m["lidar_encoder"].update(max_points=256, mlp_layers=[8, 16], feature_dim=16)
    m["radar_encoder"].update(max_points_per_sensor=16, mlp_layers=[8, 16, 32], feature_dim=32)
    m["bev_fusion"].update(bev_channels=32, bev_h=16, bev_w=16)
    m["centernet_head"].update(in_channels=32, head_conv=16)
    t.update(num_epochs=1, batch_size=2)
    t["checkpoint"].update(save_dir=str(tmp_path / "checkpoints"), save_interval=1)
    t["logging"]["log_dir"] = str(tmp_path / "logs")
    t.update(train)
    return cfg
