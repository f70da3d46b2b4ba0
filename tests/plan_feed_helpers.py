"""A geometric detector at test size and collated batches for the eval
step's plan feed (`train.loop.DevicePlans`), in the port's own config
classes: no JAX, so the card's tests import it too."""

import numpy as np
import torch

from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import dataset as port_dataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import decode as port_decode
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import preprocess as port_preprocess

NUM_CELLS = 100  # the 10x10 grid
CHUNKS = tuple(f"camera_{k}" for k in port_dataset.CHUNK_KEYS)
INPUTS = ("camera_imgs", "lidar_points", "radar_points")


def spec(mode: str = "pallas") -> port_config.DetectorSpec:
    """32x64 images (2x4 features), 4 depth bins onto a 10x10 grid, narrow
    point chains and head, the full ResNet-18 trunk."""
    c = port_config
    return c.DetectorSpec(
        camera=c.CameraEncoderSpec(image_size=(32, 64)),
        lidar=c.LidarEncoderSpec(max_points=256, mlp_layers=(16, 32, 64)),
        radar=c.RadarEncoderSpec(max_points_per_sensor=16, mlp_layers=(8, 16, 32), feat_dim=32),
        bev=c.BEVFusionSpec(bev_h=10, bev_w=10, bev_channels=32, lidar_hidden_dim=16, lidar_start_size=5,
                            camera_to_bev="geometric", depth_bins=4, splat_mode=mode),
        centernet=c.CenterNetHeadSpec(in_channels=32, head_conv=16),
    )


def model(mode: str = "pallas", seed: int = 3) -> MultiModal3DDetector:
    return MultiModal3DDetector(spec(mode)).init_weights(torch.Generator().manual_seed(seed))


def cells(seed: int) -> np.ndarray:
    """One calibration's (6, D, 2, 4) frustum cells, -1 out of range."""
    return np.random.RandomState(seed).randint(-1, NUM_CELLS, (6, 4, 2, 4)).astype(np.int32)


def samples(calibrations, cache=None, seed: int = 0):
    """One sample per entry of `calibrations` (seeds of `cells`): uint8
    cameras, points, the frustum cells and the chunk plans of `chunk_plans`
    with `cache`, as the dataset ships them."""
    s, n = spec(), len(calibrations)
    rng = np.random.RandomState(seed)
    cams = rng.randint(0, 256, (n, 6) + s.camera.image_size + (3,)).astype(np.uint8)
    lidar = rng.randn(n, s.lidar.max_points, 4).astype(np.float32)
    radar = rng.randn(n, 5, s.radar.max_points_per_sensor, 7).astype(np.float32)
    out = []
    for i, calibration in enumerate(calibrations):
        c = cells(calibration)
        plans = port_dataset.chunk_plans(c, NUM_CELLS, cache)
        out.append({"camera_imgs": cams[i], "lidar_points": lidar[i], "radar_points": radar[i], "camera_cells": c,
                    **{f"camera_{k}": v for k, v in plans.items()}})
    return out


def parent_step(m: MultiModal3DDetector, batch, device) -> dict:
    """The eval step copying every array of the batch, plans included, and
    the forward given them all: what `make_eval_step` did before it moved
    only the plans the lift reads."""
    device = torch.device(device)
    s = m.spec
    x_min, y_min, _, x_max, y_max, _ = s.bev.pc_range
    t = {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in batch.items()
         if isinstance(v, np.ndarray)}
    kwargs = {"camera_cells": t["camera_cells"]}
    if CHUNKS[0] in t:
        kwargs["camera_chunks"] = tuple(t[k] for k in CHUNKS)
    with torch.inference_mode():
        preds = m(port_preprocess.normalize_images(t["camera_imgs"], size=s.camera.image_size),
                  t["lidar_points"], t["radar_points"], **kwargs)
        return port_decode.decode_centernet_predictions(
            preds, max_detections=100, voxel_size=((x_max - x_min) / s.bev.bev_w, (y_max - y_min) / s.bev.bev_h),
            pc_range=s.bev.pc_range, class_always_zero=port_config.CompatFlags().decode_class_always_zero)


def same(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
