"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
carry specs and variables from the JAX package to the port, and make
seeded random weights that give every layer O(1) activations."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def to_port_spec(spec):
    """A JAX-package spec dataclass -> the port's class of the same name."""
    cls = getattr(port_config, type(spec).__name__)
    kwargs = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        kwargs[f.name] = to_port_spec(v) if dataclasses.is_dataclass(v) else v
    return cls(**kwargs)


def narrow_spec(modality="camera+lidar+radar", bev=16, **bev_kw):
    """A detector spec at test size: 32x64 images, 256 LiDAR points, 16 radar
    points per sensor, narrow MLPs and BEV channels, full ResNet width."""
    use_c, use_l, use_r = jax_config.parse_modalities(modality)
    return jax_config.DetectorSpec(
        use_camera=use_c, use_lidar=use_l, use_radar=use_r,
        camera=jax_config.CameraEncoderSpec(image_size=(32, 64)),
        lidar=jax_config.LidarEncoderSpec(max_points=256, mlp_layers=(16, 32, 64)),
        radar=jax_config.RadarEncoderSpec(
            max_points_per_sensor=16, mlp_layers=(8, 16, 32), feat_dim=32
        ),
        bev=jax_config.BEVFusionSpec(
            bev_h=bev, bev_w=bev, bev_channels=32, lidar_hidden_dim=16,
            lidar_start_size=5, **bev_kw,
        ),
        centernet=jax_config.CenterNetHeadSpec(in_channels=32, head_conv=16),
    )


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def random_variables(variables, seed=0):
    """Replace every leaf of a flax variables tree with seeded values:
    LeCun-normal kernels, small biases, BatchNorm scale/var in [0.5, 1.5]
    and small means, so the comparison exercises every parameter."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, numpy_tree(variables))


def detector_inputs(spec, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    h, w = spec.camera.image_size
    lidar = rng.randn(batch, spec.lidar.max_points, 4).astype(np.float32)
    lidar[:, spec.lidar.max_points // 2:] = 0.0  # zero padding
    return (
        rng.randn(batch, 6, h, w, 3).astype(np.float32),
        lidar,
        rng.randn(batch, 5, spec.radar.max_points_per_sensor, 7).astype(np.float32),
    )


def nchw(x):
    return np.transpose(x, (0, 3, 1, 2))
