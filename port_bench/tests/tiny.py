"""A configuration and traffic small enough for the CPU: the cells' code
paths at narrow images, few points and short chains."""

import copy

from core import registry

TRAFFIC = {
    "pool": 4, "clients": 4, "lidar_real": [40, 64], "radar_real": [2, 8], "batch_size": 2, "batches": 4,
    "check_requests": 16, "check_samples": 4, "trace_batches": 2, "trace_steps": 2, "max_objects": 16,
    "boxes": [2, 6], "rate": 20.0, "bf16": True,
}


def config(name: str, image_hw=(64, 128)) -> dict:
    """The configuration `name` at `image_hw` cameras, 64 LiDAR points on a
    4-16-32 chain, 8 points a radar on 7-8-16, 8 depth bins."""
    cfg = copy.deepcopy(registry.config(registry.benchmark(), name))
    m, d = cfg["model"], cfg["dataset"]
    d["cameras"]["image_size"] = m["camera_encoder"]["input_size"] = list(image_hw)
    d["max_points"] = {"lidar": 64, "radar_per_sensor": 8}
    m["lidar_encoder"]["max_points"] = 64
    m["lidar_encoder"]["mlp_layers"] = [16, 32]
    m["lidar_encoder"]["feature_dim"] = 32
    m["radar_encoder"]["max_points_per_sensor"] = 8
    m["radar_encoder"]["mlp_layers"] = [8, 16]
    m["radar_encoder"]["feature_dim"] = 16
    m["bev_fusion"]["depth_bins"] = 8
    return cfg
