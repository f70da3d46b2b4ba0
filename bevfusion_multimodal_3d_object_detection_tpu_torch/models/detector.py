"""Detector assembly + factory.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/models/detector.py:40-190``
for ``fusion_type: bev`` with the CenterNet head. The public layouts are the
JAX package's, so the two compare like with like:

  camera_imgs:  (B, N_cam, H, W, 3)
  lidar_points: (B, N, C)
  radar_points: (B, R, N_r, C_r)
  camera_cells: (B, N_cam, D, H', W') int, camera_chunks: the per-camera
                chunk plans (``camera_to_bev: geometric`` only)

and the prediction maps come back NHWC. Inside, everything is NCHW.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import DetectorSpec, load_config
from .encoders import MultiRadarEncoder, PointNetLiDAREncoder, ResNetCameraEncoder
from .fusion import FlexibleBEVFusion
from .heads import CenterNetHead


class MultiModal3DDetector(nn.Module):
    def __init__(self, spec: DetectorSpec = DetectorSpec(),
                 mask_padding: bool = False, fold_bn: bool = False):
        super().__init__()
        if spec.fusion_type != "bev":
            raise NotImplementedError(
                f"fusion_type={spec.fusion_type!r} is not ported yet "
                "(ROADMAP queue A: attention and late fusion)"
            )
        if not spec.head_is_centernet:
            raise NotImplementedError(
                f"detection_head={spec.detection_head!r} is not ported yet "
                "(ROADMAP queue A: the MLP head)"
            )
        if spec.use_lidar and spec.lidar.encoder_type.lower() == "voxelnet":
            raise NotImplementedError(
                "lidar encoder VoxelNet is not ported yet (ROADMAP queue A: VoxelNet)"
            )
        self.spec = spec
        channels = {}
        if spec.use_camera:
            self.camera_encoder = ResNetCameraEncoder(spec.camera, fold_bn=fold_bn)
            channels["camera_channels"] = spec.camera.out_channels
        if spec.use_lidar:
            self.lidar_encoder = PointNetLiDAREncoder(spec.lidar, mask_padding)
            channels["lidar_channels"] = self.lidar_encoder.out_channels
        if spec.use_radar:
            self.radar_encoder = MultiRadarEncoder(spec.radar, mask_padding)
            channels["radar_channels"] = self.radar_encoder.out_channels
        self.fusion = FlexibleBEVFusion(
            spec.bev, spec.use_camera, spec.use_lidar, spec.use_radar, **channels
        )
        self.det_head = CenterNetHead(spec.centernet)

    def forward(self, camera_imgs: Optional[torch.Tensor] = None,
                lidar_points: Optional[torch.Tensor] = None,
                radar_points: Optional[torch.Tensor] = None,
                camera_cells: Optional[torch.Tensor] = None,
                camera_chunks: Optional[Tuple[torch.Tensor, ...]] = None) -> Dict[str, torch.Tensor]:
        s = self.spec
        cam = lidar = radar = None
        if s.use_camera:
            # NHWC views -> NCHW views
            cam = self.camera_encoder(camera_imgs.permute(0, 1, 4, 2, 3))
        if s.use_lidar:
            lidar = self.lidar_encoder(lidar_points)
        if s.use_radar:
            radar = self.radar_encoder(radar_points)
        fused = self.fusion(cam, lidar, radar, camera_cells=camera_cells, camera_chunks=camera_chunks)
        preds = self.det_head(fused)
        return {k: v.permute(0, 2, 3, 1) for k, v in preds.items()}

    def init_weights(self, generator: torch.Generator) -> "MultiModal3DDetector":
        """Seeded init: LeCun-normal conv/linear weights (flax's default
        scale), zero biases, identity BatchNorms, and the head's own
        N(0, 0.001) init with the heatmap prior bias."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.reset_parameters()
            self.det_head.reset_parameters(generator)
        return self


def create_detector(modality_config: Optional[str] = None,
                    fusion_type: Optional[str] = None,
                    detection_head: Optional[str] = None,
                    num_classes: Optional[int] = None,
                    config: Optional[Dict] = None,
                    config_path: Optional[str] = None,
                    mask_padding: bool = False,
                    fold_bn: bool = False) -> MultiModal3DDetector:
    """Factory mirroring the JAX `create_detector`: a modality string,
    fusion type, head and/or a config dict or path; direct arguments
    override config values."""
    if config is None and config_path is not None:
        config = load_config(config_path)
    spec = DetectorSpec.from_config(
        config, modality_config=modality_config, fusion_type=fusion_type,
        detection_head=detection_head, num_classes=num_classes,
    )
    return MultiModal3DDetector(spec, mask_padding=mask_padding, fold_bn=fold_bn)
