"""Detector assembly + factory.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/models/detector.py:40-190``:
the encoders of the active modalities (PointNet or VoxelNet LiDAR), the
fusion by ``fusion_type`` (``bev``, ``attention``, ``late``) and the head
(CenterNet for ``bev`` with ``detection_head: centernet``, else the MLP
head). The public layouts are the JAX package's, so the two compare like
with like:

  camera_imgs:  (B, N_cam, H, W, 3)
  lidar_points: (B, N, C)
  radar_points: (B, R, N_r, C_r)
  camera_cells: (B, N_cam, D, H', W') int, camera_chunks: the per-camera
                chunk plans (``camera_to_bev: geometric`` only)

and the prediction maps come back NHWC; the MLP head gives {'cls', 'box'}.
Inside, everything is NCHW.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import DetectorSpec, load_config
from .encoders import (
    MultiRadarEncoder,
    PointNetLiDAREncoder,
    ResNetCameraEncoder,
    VoxelNetLiDAREncoder,
)
from .fusion import FlexibleAttentionFusion, FlexibleBEVFusion, FlexibleLateFusion
from .heads import CenterNetHead, MLPDetectionHead


class MultiModal3DDetector(nn.Module):
    def __init__(self, spec: DetectorSpec = DetectorSpec(),
                 mask_padding: bool = False, fold_bn: bool = False):
        super().__init__()
        self.spec = spec
        channels = {}
        if spec.use_camera:
            self.camera_encoder = ResNetCameraEncoder(spec.camera, fold_bn=fold_bn)
            channels["camera_channels"] = spec.camera.out_channels
        if spec.use_lidar:
            if spec.lidar.encoder_type.lower() == "voxelnet":
                self.lidar_encoder = VoxelNetLiDAREncoder(spec.lidar, pc_range=spec.bev.pc_range)
            else:
                self.lidar_encoder = PointNetLiDAREncoder(spec.lidar, mask_padding)
            channels["lidar_channels"] = self.lidar_encoder.out_channels
        if spec.use_radar:
            self.radar_encoder = MultiRadarEncoder(spec.radar, mask_padding)
            channels["radar_channels"] = self.radar_encoder.out_channels
        mods = (spec.use_camera, spec.use_lidar, spec.use_radar)
        if spec.fusion_type == "bev":
            self.fusion = FlexibleBEVFusion(spec.bev, *mods, **channels)
            fused_channels = spec.bev.bev_channels
        elif spec.fusion_type == "attention":
            self.fusion = FlexibleAttentionFusion(spec.attention, *mods, **channels)
            fused_channels = self.fusion.out_channels
        elif spec.fusion_type == "late":
            self.fusion = FlexibleLateFusion(spec.late, *mods, **channels)
            fused_channels = self.fusion.out_channels
        else:
            raise ValueError(f"Unknown fusion type: {spec.fusion_type}")
        if spec.head_is_centernet:
            self.det_head = CenterNetHead(spec.centernet)
        else:  # the MLP head for the global fusions (ref: fusion.py:1074-1088)
            self.det_head = MLPDetectionHead(spec.mlp, fused_channels)

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
        if s.fusion_type == "bev":
            fused = self.fusion(cam, lidar, radar, camera_cells=camera_cells, camera_chunks=camera_chunks)
        else:
            fused = self.fusion(cam, lidar, radar)
        preds = self.det_head(fused)
        if not s.head_is_centernet:
            return preds
        return {k: v.permute(0, 2, 3, 1) for k, v in preds.items()}

    def get_config_str(self) -> str:
        s = self.spec
        return f"{s.modality_string()}_{s.fusion_type}_{s.detection_head}"

    def init_weights(self, generator: torch.Generator) -> "MultiModal3DDetector":
        """Seeded init: LeCun-normal conv/linear weights (flax's default
        scale), zero biases, identity BatchNorms and LayerNorms, N(0, 1)
        positional embeddings (flax's ``normal(1.0)``), and the head's own
        init (CenterNet: N(0, 0.001) with the heatmap prior bias)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
                    m.reset_parameters()
                elif isinstance(m, FlexibleAttentionFusion):
                    for p in m.pos_embeds():
                        p.normal_(0.0, 1.0, generator=generator)
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
