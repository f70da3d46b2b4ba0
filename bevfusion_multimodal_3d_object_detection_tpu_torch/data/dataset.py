"""Input pipeline: pickle-info dataset, splat plans, fixed-shape batches.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/data/dataset.py``
(numpy, the port's own copies), with the same static shapes:

- `_decode_image` / `_load_image` (``:41-62``): PIL decode, bilinear resize,
  and on the float wire ImageNet normalization, NHWC; with ``emit_uint8`` the
  raw bytes ship and the train and eval steps normalize on the device;
- `parse_radar_pcd` / `read_radar_pcd` (``:65-117``);
- `NuScenesDataset` (``:120-570``): LiDAR bins (quirk Q5's 4-float parse by
  default) through the native point prep or numpy, or with ``num_sweeps``
  > 1 and sweeps in the info the key sweep and prior ones in its frame with
  a time-lag channel (``:307-348``, 5 channels); Q4's random radar points
  or the parsed radar files, with ``radar_num_sweeps`` > 1 and sweeps in a
  radar's entry aggregated into its key frame (``:370-405``); GT encoding,
  ``cam_front_projection``, and on the geometric path the frustum cells,
  for the val split with ``splat_mode: pallas`` the chunk plans, and with
  ``splat_mode: culled`` the culled pair plans instead of the cells, on
  every split (``:491-531``: capacities fixed once from sample 0 under a
  lock);
- `frustum_cells` (``:535-570``) and `chunk_plans` (``:466-489``), which
  the geometric eval path also calls on its own; the plans are read-only,
  one set a calibration in the caller's cache;
- `SyntheticNuScenesDataset` (``:573-630``);
- `collate_fn` (``:632-665``): GT padded to ``max_objects`` (boxes, label -1,
  velocities); a plan shared by the batch's samples stays one array;
- `DataLoader` (``:668-776``): seeded shuffle, ``drop_last``, a prefetch
  thread that re-raises loader errors, ``num_workers`` loader threads, and
  the per-process (data-parallel: per-node) strided share of the epoch.
"""

from __future__ import annotations

import pickle
import queue as queue_mod
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import CAMERA_ORDER, DEFAULT_CLASSES, RADAR_ORDER, CompatFlags, DataSpec, DetectorSpec
from ..ops.bev_pool import precompute_bev_chunks
from ..ops.bev_splat import (
    precompute_culled_pairs,
    precompute_culled_pairs_batch,
    precompute_frustum_cells,
)
from .converter import quat_rotation_matrix, sensor_to_global, transform_points_between_sensors

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# a batch's model inputs, and the geometric path's per-sample plans by what
# reads them (`GeometricCameraBEV.reads`): frustum cells, chunk plans,
# culled pair plans
INPUT_KEYS = ("camera_imgs", "lidar_points", "radar_points")
CHUNK_KEYS = ("point_idx", "local_ids", "block_idx")
PAIR_KEYS = ("seg_idx", "seg_id", "pair_cell", "pair_pix")
PLAN_KEYS = {"cells": ("camera_cells",), "chunks": tuple(f"camera_{k}" for k in CHUNK_KEYS),
             "pairs": tuple(f"camera_{k}" for k in PAIR_KEYS)}
ALL_PLAN_KEYS = tuple(k for keys in PLAN_KEYS.values() for k in keys)
_BATCH_KEYS = (*INPUT_KEYS, *ALL_PLAN_KEYS)


def _decode_image(path: Path, h: int, w: int, draft: bool):
    """PIL decode + bilinear resize -> RGB image at (w, h); `draft` decodes
    JPEGs at the smallest power-of-two DCT scale at least the target."""
    from PIL import Image

    img = Image.open(path)
    if draft:
        img.draft("RGB", (w, h))
    return img.convert("RGB").resize((w, h), Image.BILINEAR)


def normalize_host_images(images) -> np.ndarray:
    """uint8 RGB (..., H, W, 3) -> float32: [0,1] + ImageNet normalize, on
    the host (the float wire)."""
    return (np.asarray(images, np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def _load_image(path: Path, h: int, w: int, draft: bool = False) -> np.ndarray:
    """PIL decode + bilinear resize + [0,1] + ImageNet normalize -> (H, W, 3)."""
    return normalize_host_images(_decode_image(path, h, w, draft))


def parse_radar_pcd(path: Path) -> np.ndarray:
    """Minimal nuScenes radar .pcd parser -> (N, 7) float32
    [x, y, z, vx, vy, rcs, t(=0)] (unpadded); (0, 7) on any parse failure."""
    empty = np.zeros((0, 7), np.float32)
    try:
        raw = Path(path).read_bytes()
        header_end = raw.index(b"DATA binary\n") + len(b"DATA binary\n")
        header = raw[:header_end].decode("ascii", "ignore").splitlines()
        fields: List[str] = []
        sizes: List[int] = []
        types: List[str] = []
        count = 0
        for line in header:
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("SIZE"):
                sizes = [int(v) for v in line.split()[1:]]
            elif line.startswith("TYPE"):
                types = line.split()[1:]
            elif line.startswith("POINTS"):
                count = int(line.split()[1])
        if not fields or count == 0:
            return empty
        fmt_map = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
                   ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}
        dtype = np.dtype([(name, fmt_map[(t, s)]) for name, t, s in zip(fields, types, sizes)])
        pts = np.frombuffer(raw[header_end: header_end + count * dtype.itemsize], dtype=dtype)
        out = np.zeros((len(pts), 7), np.float32)
        for ci, name in enumerate(("x", "y", "z", "vx", "vy", "rcs")):
            if name in pts.dtype.names:
                out[:, ci] = pts[name].astype(np.float32)
        return out
    except Exception:  # the reference's loader never reads radar: any bad file reads as empty
        return empty


def read_radar_pcd(path: Path, max_points: int) -> np.ndarray:
    """`parse_radar_pcd` zero-padded / truncated to (max_points, 7)."""
    pts = parse_radar_pcd(path)[:max_points]
    out = np.zeros((max_points, 7), np.float32)
    out[: len(pts)] = pts
    return out


def _read_lidar_bin(path, record: int) -> np.ndarray:
    """(N, 4) float32 points of a LiDAR .bin of `record` floats a point;
    Q5 (record=4) is the reference's misaligned parse of the 5-float
    nuScenes records."""
    raw = np.fromfile(str(path), dtype=np.float32)
    return raw[: (raw.size // record) * record].reshape(-1, record)[:, :4]


def frustum_cells(
    info: Dict,
    image_size: Tuple[int, int],
    bev_hw: Tuple[int, int],
    depth_bins: int,
    depth_min: float,
    depth_max: float,
    pc_range: Tuple[float, ...],
    stride: int = 16,
    z_range: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """(N_cam, D, H', W') int32 BEV cell of every frustum point of the six
    cameras of one sample info (-1 out of range, or with `z_range` out of
    [z_min, z_max)). Intrinsics are scaled from the native 1600x900 nuScenes
    images to `image_size`; the feature grid is the camera encoder's, at
    its total `stride` (16 for ResNet-18, 8 for Swin-T and its neck)."""
    h, w = image_size
    fh, fw = h // stride, w // stride
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
                depth_bins=depths, bev_hw=bev_hw, pc_range=pc_range, z_range=z_range,
            )
        )
    return np.stack(out)


def _cached_plans(cache: Optional[Dict], key, camera_cells: np.ndarray, plan_of, keys) -> Dict[str, np.ndarray]:
    """The plans of a calibration's (N_cam, ...) cells: `plan_of(row)`, one
    camera's plan, stacked over the cameras under `keys`, read-only. `cache`
    (the caller's dict) keeps them by `key`, so a repeated calibration gets
    the same arrays, which `collate_fn` shares across a batch and the eval
    step copies to the device once; it is emptied past 256 camera plans to
    bound host memory."""
    plans = None if cache is None else cache.get(key)
    if plans is None:
        per_cam = [plan_of(cam_cells.reshape(-1)) for cam_cells in camera_cells]
        plans = {k: np.stack([p[k] for p in per_cam]) for k in keys}
        for a in plans.values():
            a.setflags(write=False)
        if cache is not None:
            if (len(cache) + 1) * len(camera_cells) > 256:
                cache.clear()
            cache[key] = plans
    return dict(plans)


def chunk_plans(camera_cells: np.ndarray, num_cells: int,
                cache: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """(N_cam, D, H', W') cells -> {point_idx, local_ids: (N_cam, n_chunks,
    T), block_idx: (N_cam, n_chunks)} int32, one plan per camera, read-only.

    `cache`, a dict the caller keeps (one per dataset, say), holds the plans
    by the cells' bytes, since calibrations repeat across a scene: a
    repeated calibration gets the same arrays (see `_cached_plans`)."""
    key = (num_cells, camera_cells.shape, camera_cells.tobytes())
    return _cached_plans(cache, key, camera_cells, lambda row: precompute_bev_chunks(row, num_cells), CHUNK_KEYS)


class NuScenesDataset:
    """Pickle-backed dataset (``nuscenes_infos_{split}.pkl``, the reference
    converter's schema, ref: data_converter.py:140-161, 336-356). `config`
    overrides the sizes, classes and range from its ``dataset:`` block and
    wires the geometric path's cells and plans from ``model.bev_fusion``.
    The culled pair plans' capacities are ``cull_points`` / ``cull_pairs``
    when both are given, else 5 % over sample 0's counts."""

    def __init__(
        self,
        data_root: str = "./data/nuscenes",
        split: str = "train",
        max_points: int = 35000,
        max_radar_points: int = 125,
        image_size=(448, 800),
        classes=DEFAULT_CLASSES,
        pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
        compat: CompatFlags = CompatFlags(),
        config: Optional[Dict] = None,
        seed: Optional[int] = None,
        return_camera_cells: bool = False,
        return_camera_chunks: bool = False,
        return_camera_pairs: bool = False,
        cull_points: int = 0,
        cull_pairs: int = 0,
        bev_h: int = 50,
        bev_w: int = 50,
        depth_bins: int = 40,
        depth_min: float = 1.0,
        depth_max: float = 60.0,
        feature_stride: int = 16,
        camera_zbound: Optional[Tuple[float, float]] = None,
        use_native: bool = True,
        emit_uint8: bool = False,
        num_sweeps: int = 1,
        radar_num_sweeps: int = 1,
        jpeg_draft_decode: bool = False,
    ):
        if config is not None:
            ds = DataSpec.from_config(config)
            data_root = ds.data_root
            max_points = ds.max_lidar_points
            max_radar_points = ds.max_radar_points
            image_size = ds.image_size
            classes = ds.classes
            pc_range = ds.pc_range
            num_sweeps = ds.num_sweeps
            radar_num_sweeps = ds.radar_num_sweeps
            jpeg_draft_decode = ds.jpeg_draft_decode
            compat = CompatFlags.from_config(config)
            bev_cfg = (config.get("model", {}) or {}).get("bev_fusion", {}) or {}
            if bev_cfg.get("camera_to_bev", "pseudo") == "geometric":
                splat_mode = bev_cfg.get("splat_mode", "matmul")
                # chunk plans feed the fused splat, which only inference
                # runs: the train split does not carry them
                return_camera_chunks = splat_mode == "pallas" and split != "train"
                # the culled pair plans train too, and replace the cells:
                # the culled branch never reads them
                return_camera_pairs = splat_mode == "culled"
                return_camera_cells = not return_camera_pairs
                cull_points = bev_cfg.get("splat_cull_points", 0)
                cull_pairs = bev_cfg.get("splat_cull_pairs", 0)
                # the frustum's grid, feature stride and z range: the
                # camera grid and encoder of the model's spec
                model_spec = DetectorSpec.from_config(config)
                bev_h, bev_w = model_spec.bev.camera_grid
                depth_bins = model_spec.bev.depth_bins
                depth_min, depth_max = model_spec.bev.depth_min, model_spec.bev.depth_max
                feature_stride = model_spec.camera.total_stride
                camera_zbound = model_spec.bev.camera_zbound

        self.data_root = Path(data_root)
        self.split = split
        self.max_points = max_points
        self.max_radar_points = max_radar_points
        self.image_size = tuple(image_size)
        self.classes = list(classes)
        self.pc_range = tuple(pc_range)
        self.compat = compat
        # the per-sample RNG comes from (seed, index): loading is
        # deterministic whatever the order or thread
        self.seed = 0 if seed is None else int(seed)
        self.return_camera_cells = return_camera_cells
        self.return_camera_chunks = return_camera_chunks
        self._chunk_cache: Dict = {}
        self.return_camera_pairs = return_camera_pairs
        self._pair_cache: Dict = {}
        self._cull_caps = (int(cull_points), int(cull_pairs)) if cull_points and cull_pairs else None
        # two loader threads must not size the capacities from different
        # samples: one batch would then mix plan shapes
        self._cull_caps_lock = threading.Lock()
        self.use_native = use_native
        self.emit_uint8 = emit_uint8
        self.num_sweeps = num_sweeps
        self.radar_num_sweeps = radar_num_sweeps
        self.jpeg_draft_decode = jpeg_draft_decode
        self.bev_h, self.bev_w = bev_h, bev_w
        self.depth_bins = depth_bins
        self.depth_min, self.depth_max = depth_min, depth_max
        self.feature_stride, self.camera_zbound = feature_stride, camera_zbound

        with open(self.data_root / f"nuscenes_infos_{split}.pkl", "rb") as f:
            data = pickle.load(f)
        self.infos = data["infos"]
        meta_classes = data.get("metadata", {}).get("classes")
        if meta_classes:
            self.classes = list(meta_classes)
        print(f"Loaded {len(self.infos)} samples for {split} split")

    def __len__(self) -> int:
        return len(self.infos)

    def _encode_labels(self, names) -> np.ndarray:
        label_map = {n: i for i, n in enumerate(self.classes)}
        return np.array([label_map.get(n, -1) for n in names], dtype=np.int64)

    def _load_cameras(self, info) -> np.ndarray:
        h, w = self.image_size
        paths = [self.data_root / info["cams"][cam]["filename"] for cam in CAMERA_ORDER]
        if self.emit_uint8:
            # raw bytes; the steps normalize on the device
            imgs = [np.asarray(_decode_image(p, h, w, self.jpeg_draft_decode), np.uint8) for p in paths]
        else:
            imgs = [_load_image(p, h, w, self.jpeg_draft_decode) for p in paths]
        return np.stack(imgs)  # (6, H, W, 3)

    def _load_lidar(self, info, rng) -> np.ndarray:
        if self.num_sweeps > 1 and info.get("sweeps"):
            return self._load_multi_sweep(info, rng)
        record = 4 if self.compat.lidar_four_float_parse else 5
        if self.use_native:
            from .native import load_lidar_native

            # drawn before the radar's draws, as in the JAX package
            return load_lidar_native(
                str(info["lidar_path"]), record, self.max_points, 4, self.pc_range,
                seed=rng.randint(1 << 31),
            )
        pts = _read_lidar_bin(info["lidar_path"], record)
        return self._pad_or_subsample(self._in_range(pts), self.max_points, rng)

    def _in_range(self, pts: np.ndarray) -> np.ndarray:
        x0, y0, z0, x1, y1, z1 = self.pc_range
        m = ((pts[:, 0] > x0) & (pts[:, 0] < x1) & (pts[:, 1] > y0) & (pts[:, 1] < y1)
             & (pts[:, 2] > z0) & (pts[:, 2] < z1))
        return pts[m]

    def _load_multi_sweep(self, info, rng) -> np.ndarray:
        """The key sweep and up to num_sweeps - 1 prior sweeps, each moved
        into the key sweep's frame (ego motion compensated), with the sweep's
        time lag as a fifth channel (0 for the key sweep) -> (max_points, 5)
        [x, y, z, intensity, dt]. A prior sweep whose file cannot be read is
        skipped."""
        record = 4 if self.compat.lidar_four_float_parse else 5
        key_pose, key_calib = info["lidar_pose"], info["lidar_calibrated_sensor"]
        key_pts = _read_lidar_bin(info["lidar_path"], record)
        clouds = [np.concatenate([key_pts, np.zeros((len(key_pts), 1), np.float32)], axis=1)]
        for sweep in info["sweeps"][: self.num_sweeps - 1]:
            try:
                pts = _read_lidar_bin(sweep["lidar_path"], record)
            except OSError:
                continue
            pts = transform_points_between_sensors(pts, sweep["pose"], sweep["calib"], key_pose, key_calib)
            dt = np.full((len(pts), 1), float(sweep.get("time_lag_s", 0.0)), np.float32)
            clouds.append(np.concatenate([pts, dt], axis=1))
        return self._pad_or_subsample(self._in_range(np.concatenate(clouds, axis=0)), self.max_points, rng)

    def _load_radars(self, info, rng) -> np.ndarray:
        out = []
        for radar in RADAR_ORDER:
            if self.compat.random_radar_points:
                # Q4: dummy gaussian points (ref: train_detect.py:173-177)
                out.append(rng.randn(self.max_radar_points, 7).astype(np.float32))
                continue
            entry = info["radars"][radar]
            if self.radar_num_sweeps > 1 and entry.get("sweeps"):
                out.append(self._load_radar_multi_sweep(entry, rng))
            else:
                out.append(read_radar_pcd(self.data_root / entry["filename"], self.max_radar_points))
        return np.stack(out)  # (5, Nr, 7)

    def _load_radar_multi_sweep(self, entry, rng) -> np.ndarray:
        """One radar's key frame and up to radar_num_sweeps - 1 prior sweeps
        in the key frame: positions ego motion compensated, (vx, vy) rotated
        into the key frame, the t channel the sweep's time lag (0 for the
        key frame) -> (max_radar_points, 7), subsampled or zero-padded."""
        key_pose, key_calib = entry["pose"], entry["calibrated_sensor"]
        clouds = [parse_radar_pcd(self.data_root / entry["filename"])]
        r_key, _ = sensor_to_global(key_pose, key_calib)
        for sweep in entry["sweeps"][: self.radar_num_sweeps - 1]:
            pts = parse_radar_pcd(Path(sweep["path"]))
            if not len(pts):
                continue
            pts = transform_points_between_sensors(pts, sweep["pose"], sweep["calib"], key_pose, key_calib)
            # velocities only rotate: v_key = R_key^T R_sweep v
            r_sweep, _ = sensor_to_global(sweep["pose"], sweep["calib"])
            r_rel = r_key.T @ r_sweep
            v = np.concatenate([pts[:, 3:5], np.zeros((len(pts), 1), np.float32)], axis=1)
            pts[:, 3:5] = (v @ r_rel.T)[:, :2].astype(np.float32)
            pts[:, 6] = float(sweep.get("time_lag_s", 0.0))
            clouds.append(pts)
        pts = np.concatenate([c for c in clouds if len(c)] or clouds, axis=0)
        return self._pad_or_subsample(pts, self.max_radar_points, rng)

    def _pad_or_subsample(self, pts: np.ndarray, n: int, rng) -> np.ndarray:
        if pts.shape[0] >= n:
            idx = rng.choice(pts.shape[0], n, replace=False)
            return pts[idx].astype(np.float32)
        pad = np.zeros((n - pts.shape[0], pts.shape[1]), np.float32)
        return np.concatenate([pts.astype(np.float32), pad], axis=0)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        rng = np.random.RandomState(self.seed * 1000003 + idx)
        sample = {
            "camera_imgs": self._load_cameras(info),
            "lidar_points": self._load_lidar(info, rng),
            "radar_points": self._load_radars(info, rng),
            "gt_boxes": np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7),
            "gt_labels": self._encode_labels(info["gt_names"]),
            "gt_velocities": np.asarray(info["gt_velocity"], np.float32).reshape(-1, 2),
            "token": info["token"],
        }
        if self.return_camera_cells or self.return_camera_chunks or self.return_camera_pairs:
            cells = self._frustum_cells(info)
            if self.return_camera_cells or self.return_camera_chunks:
                sample["camera_cells"] = cells
            if self.return_camera_chunks:
                plans = chunk_plans(cells, self.bev_h * self.bev_w, self._chunk_cache)
                for k in CHUNK_KEYS:
                    sample[f"camera_{k}"] = plans[k]
            if self.return_camera_pairs:
                plans = self._pair_plans(cells)
                for k in PAIR_KEYS:
                    sample[f"camera_{k}"] = plans[k]
        cam_front = info.get("cams", {}).get("CAM_FRONT", {})
        if "calibrated_sensor" in cam_front and "lidar_calibrated_sensor" in info:
            # front-camera projection for the visualization path (intrinsics
            # scaled from the native 1600x900 to image_size)
            from ..utils.box_geometry import lidar_to_cam_transform

            h, w = self.image_size
            cs = cam_front["calibrated_sensor"]
            intr = np.asarray(cs["camera_intrinsic"], np.float64)
            rot, trans = lidar_to_cam_transform(cs, info["lidar_calibrated_sensor"])
            sample["cam_front_projection"] = {
                "intrinsic": np.diag([w / 1600.0, h / 900.0, 1.0]) @ intr,
                "rot": rot,
                "trans": trans,
            }
        return sample

    def _frustum_cells(self, info) -> np.ndarray:
        return frustum_cells(info, self.image_size, (self.bev_h, self.bev_w), self.depth_bins,
                             self.depth_min, self.depth_max, self.pc_range, self.feature_stride,
                             self.camera_zbound)

    def _pair_plans(self, camera_cells: np.ndarray) -> Dict[str, np.ndarray]:
        """(N_cam, D, H', W') cells -> the culled pair plans: seg_idx, seg_id
        (N_cam, T_cap) and pair_cell, pair_pix (N_cam, U_cap) int32. The
        capacities are fixed once, whichever thread comes first: 5 % over
        sample 0's counts (or the config's), so every sample, thread, epoch
        and host gives one shape; a later sample that does not fit raises
        with the config keys to set. The plans are read-only and cached by
        the cells' bytes (`_cached_plans`)."""
        num_cells = self.bev_h * self.bev_w
        hw = camera_cells.shape[-2] * camera_cells.shape[-1]
        if self._cull_caps is None:
            with self._cull_caps_lock:
                if self._cull_caps is None:
                    _, self._cull_caps = precompute_culled_pairs_batch(
                        self._frustum_cells(self.infos[0]), hw, num_cells, headroom=1.05, sizes_only=True,
                    )
        t_cap, u_cap = self._cull_caps
        return _cached_plans(
            self._pair_cache, (camera_cells.shape, camera_cells.tobytes()), camera_cells,
            lambda row: precompute_culled_pairs(row, hw, num_cells, point_capacity=t_cap, pair_capacity=u_cap),
            PAIR_KEYS,
        )


class SyntheticNuScenesDataset:
    """Config-shaped random dataset for tests and benchmarks (no files)."""

    def __init__(
        self,
        num_samples: int = 8,
        image_size=(448, 800),
        max_points: int = 35000,
        max_radar_points: int = 125,
        num_cameras: int = 6,
        num_radars: int = 5,
        max_gt: int = 12,
        num_classes: int = 10,
        pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
        seed: int = 0,
    ):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.max_points = max_points
        self.max_radar_points = max_radar_points
        self.num_cameras = num_cameras
        self.num_radars = num_radars
        self.max_gt = max_gt
        self.num_classes = num_classes
        self.pc_range = pc_range
        self.seed = seed
        self.classes = list(DEFAULT_CLASSES)[:num_classes]

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        h, w = self.image_size
        n_gt = rng.randint(1, self.max_gt + 1)
        x0, y0, _, x1, y1, _ = self.pc_range
        boxes = np.zeros((n_gt, 7), np.float32)
        boxes[:, 0] = rng.uniform(x0 * 0.9, x1 * 0.9, n_gt)
        boxes[:, 1] = rng.uniform(y0 * 0.9, y1 * 0.9, n_gt)
        boxes[:, 2] = rng.uniform(-2.0, 0.5, n_gt)
        boxes[:, 3:6] = rng.uniform(0.5, 6.0, (n_gt, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_gt)
        return {
            "camera_imgs": rng.randn(self.num_cameras, h, w, 3).astype(np.float32),
            "lidar_points": rng.randn(self.max_points, 4).astype(np.float32),
            "radar_points": rng.randn(self.num_radars, self.max_radar_points, 7).astype(np.float32),
            "gt_boxes": boxes,
            "gt_labels": rng.randint(0, self.num_classes, n_gt).astype(np.int64),
            "gt_velocities": np.zeros((n_gt, 2), np.float32),
            "token": f"synthetic_{idx}",
        }


def _stacked(key: str, values: List[np.ndarray]) -> np.ndarray:
    """`values` along a new batch axis. A plan that every sample holds as
    the same read-only array (one calibration's, from `chunk_plans` or the
    pair plans) becomes a read-only view of it with stride 0 on that axis:
    the same values, and no copy."""
    first = values[0]
    if (key in ALL_PLAN_KEYS and isinstance(first, np.ndarray) and not first.flags.writeable
            and all(v is first for v in values)):
        return np.broadcast_to(first[None], (len(values),) + first.shape)
    return np.stack(values)


def collate_fn(samples: List[Dict[str, np.ndarray]], max_objects: int = 500) -> Dict[str, np.ndarray]:
    """Stack the model inputs and, where the samples carry them, the frustum
    cells, the chunk plans (``camera_point_idx``, ``camera_local_ids``,
    ``camera_block_idx``) and the culled pair plans (``camera_seg_idx``,
    ``camera_seg_id``, ``camera_pair_cell``, ``camera_pair_pix``) along a new
    batch axis; a plan that every sample shares read-only stays shared
    (`_stacked`). Samples with GT get it
    padded to a fixed `max_objects`: boxes (B, M, 7) zero rows, labels
    (B, M) -1, velocities (B, M, 2); and their tokens as a list
    (the reference pads to the batch's largest, ref: train_detect.py:197-242)."""
    out = {k: _stacked(k, [s[k] for s in samples]) for k in _BATCH_KEYS if k in samples[0]}
    if "gt_labels" in samples[0]:
        b = len(samples)
        gt_boxes = np.zeros((b, max_objects, 7), np.float32)
        gt_labels = np.full((b, max_objects), -1, np.int64)
        gt_vel = np.zeros((b, max_objects, 2), np.float32)
        for i, s in enumerate(samples):
            n = min(len(s["gt_labels"]), max_objects)
            gt_boxes[i, :n] = s["gt_boxes"][:n]
            gt_labels[i, :n] = s["gt_labels"][:n]
            gt_vel[i, :n] = s["gt_velocities"][:n]
        out.update(gt_boxes=gt_boxes, gt_labels=gt_labels, gt_velocities=gt_vel)
    if "token" in samples[0]:
        out["tokens"] = [s["token"] for s in samples]
    return out


class DataLoader:
    """Batching iterator over a dataset: a seeded shuffle per epoch,
    ``drop_last``, ``num_workers`` threads for the per-sample loads (PIL
    decode and file reads release the GIL) and a prefetch thread that keeps
    up to `prefetch` collated batches ahead; an error in it is raised in the
    consumer. With `process_count` > 1 (data parallelism: the torchrun node
    index and node count) every process draws the same epoch permutation and
    takes its strided slice, truncated to the same length on every process
    (``data/dataset.py:686-745`` of the JAX package): the epoch is covered
    once, up to ``process_count - 1`` samples, and every process runs the
    same number of batches."""

    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        shuffle: bool = False,
        drop_last: bool = False,
        max_objects: int = 500,
        prefetch: int = 2,
        seed: int = 0,
        num_workers: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.max_objects = max_objects
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = max(1, process_count)

    def _fetch(self, indices) -> List[Dict[str, np.ndarray]]:
        if self.num_workers and self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.num_workers) as pool:
                return list(pool.map(self.dataset.__getitem__, (int(i) for i in indices)))
        return [self.dataset[int(i)] for i in indices]

    def _local_count(self) -> int:
        # unequal counts would leave a process waiting in a collective at
        # the epoch's end
        return len(self.dataset) // self.process_count

    def __len__(self) -> int:
        n = self._local_count()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        if self.process_count > 1:
            idx = idx[self.process_index::self.process_count][: self._local_count()]
        batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        if self.prefetch <= 0:
            for b in batches:
                yield collate_fn(self._fetch(b), self.max_objects)
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue_mod.Full:
                    continue

        def worker():
            # a loader error must surface in the consumer, not end the
            # epoch early: it is queued and raised below
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    put(collate_fn(self._fetch(b), self.max_objects))
                put(sentinel)
            except BaseException as e:  # noqa: BLE001 - handed to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early (or fails) releases the thread
            stop.set()
            t.join()
