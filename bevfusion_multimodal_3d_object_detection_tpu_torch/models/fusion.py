"""BEV fusion (PyTorch, NCHW).

Port of ``bevfusion_multimodal_3d_object_detection_tpu/models/fusion.py``
``:34-276``: each active modality is projected to a (bev_h, bev_w) grid, the
grids are concatenated and fused by two conv-BN-ReLU layers. The camera goes
to the grid in one of two ways (`BEVFusionSpec.camera_to_bev`):

- ``pseudo``: mean over cameras, conv-BN-ReLU twice, bilinear resize;
- ``geometric``: `GeometricCameraBEV`, a lift-splat over depth bins into
  the BEV cells each frustum point falls in (``:58-158``), with the splat
  of ``splat_mode: matmul`` or, at inference with chunk plans,
  ``splat_mode: pallas`` (kernel B2).

Submodule names follow the flax tree (``camera_proj1_conv``,
``geometric_camera_bev.depth_head``, ``lidar_init1``...).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BEVFusionSpec
from ..ops.bev_pool import num_cells_padded
from ..ops.bev_splat import lift_splat_matmul_rows, lift_splat_pallas_rows
from .resnet import batch_norm


def bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW bilinear resize with half-pixel centres, as
    ``jax.image.resize(method="linear")``: that filter antialiases along an
    axis it shrinks, so `antialias` is on exactly when one shrinks. Computed
    in f32 and cast back."""
    if x.shape[2] == h and x.shape[3] == w:
        return x
    shrink = h < x.shape[2] or w < x.shape[3]
    return F.interpolate(
        x.float(), size=(h, w), mode="bilinear", align_corners=False,
        antialias=shrink,
    ).to(x.dtype)


class GeometricCameraBEV(nn.Module):
    """Lift-splat camera-to-BEV: per camera a 1x1 depth head predicts a
    distribution over D depth bins and a 1x1 projection gives the BEV
    channels; the features weighted by the depth probabilities are summed
    into the cells of their frustum points, summed over cameras, and refined
    by conv-BN-ReLU.

    camera_features (B, N, C_cam, H', W'); camera_cells (B, N, D, H', W')
    int, -1 out of range; camera_chunks: the per-camera chunk plans
    (point_idx, local_ids, block_idx) of `ops.bev_pool.precompute_bev_chunks`,
    each (B, N, ...). Output (B, bev_channels, bev_h, bev_w)."""

    def __init__(self, spec: BEVFusionSpec, camera_channels: int = 512):
        super().__init__()
        if spec.splat_mode not in ("matmul", "pallas"):
            raise NotImplementedError(
                f"splat_mode={spec.splat_mode!r} is not ported yet "
                "(ROADMAP, still to port: the scatter and culled splats)"
            )
        self.spec = spec
        c = spec.bev_channels
        self.depth_head = nn.Conv2d(camera_channels, spec.depth_bins, 1)
        self.feat_proj = nn.Conv2d(camera_channels, c, 1)
        self.splat_refine_conv = nn.Conv2d(c, c, 3, 1, 1)
        self.splat_refine_bn = batch_norm(c)

    def forward(self, camera_features: torch.Tensor, camera_cells: Optional[torch.Tensor] = None,
                camera_chunks: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
        s = self.spec
        b, n = camera_features.shape[:2]
        flat = camera_features.reshape((b * n,) + camera_features.shape[2:])
        depth_logits = self.depth_head(flat)
        feat = self.feat_proj(flat)
        num_cells = s.bev_h * s.bev_w
        if s.splat_mode == "pallas" and camera_chunks is not None and not self.training:
            # kernel B2 (inference only, as in the JAX package); f32 out
            pi, li, bi = (a.reshape((b * n,) + a.shape[2:]) for a in camera_chunks)
            bev = lift_splat_pallas_rows(
                feat, depth_logits, pi, li, bi, num_cells, num_cells_padded(num_cells)
            ).to(feat.dtype)
        else:
            if camera_cells is None:
                raise ValueError("the matmul splat needs camera_cells")
            bev = lift_splat_matmul_rows(
                feat, depth_logits, camera_cells.reshape(b * n, -1), num_cells
            )
        bev = bev.reshape(b, n, s.bev_h, s.bev_w, s.bev_channels).sum(dim=1)
        bev = self.splat_refine_conv(bev.permute(0, 3, 1, 2))
        return F.relu(self.splat_refine_bn(bev))


class FlexibleBEVFusion(nn.Module):
    """Inputs (each may be None when its modality is off):
      camera_features: (B, N_cam, C_cam, H', W') or (B, C_cam, H', W')
                       (5-D for camera_to_bev: geometric)
      lidar_features:  (B, C_lidar)
      radar_features:  (B, C_radar)
      camera_cells, camera_chunks: the geometric path's frustum cells and
                       chunk plans (see `GeometricCameraBEV`)
    Output: (B, bev_channels, bev_h, bev_w)."""

    def __init__(self, spec: BEVFusionSpec = BEVFusionSpec(),
                 use_camera: bool = True, use_lidar: bool = True,
                 use_radar: bool = True, camera_channels: int = 512,
                 lidar_channels: int = 1024, radar_channels: int = 256):
        super().__init__()
        if spec.camera_to_bev not in ("pseudo", "geometric"):
            raise ValueError(f"unknown camera_to_bev {spec.camera_to_bev!r}")
        self.spec = spec
        self.use_camera, self.use_lidar, self.use_radar = use_camera, use_lidar, use_radar
        c = spec.bev_channels
        if use_camera and spec.camera_to_bev == "geometric":
            self.geometric_camera_bev = GeometricCameraBEV(spec, camera_channels)
        elif use_camera:
            self._add_conv_bn("camera_proj1", camera_channels, 512, 3)
            self._add_conv_bn("camera_proj2", 512, c, 1)
        if use_lidar:
            hid, start = spec.lidar_hidden_dim, spec.lidar_start_size
            self.lidar_init1 = nn.Linear(lidar_channels, 512)
            self.lidar_init2 = nn.Linear(512, hid * start * start)
            self._add_conv_bn("lidar_up1", hid, hid, 3)
            self._add_conv_bn("lidar_up2", hid, c, 3)
        if use_radar:
            self.radar_proj = nn.Linear(radar_channels, c)
            self._add_conv_bn("radar_refine1", c, c, 3)
            self._add_conv_bn("radar_refine2", c, c, 3)
        n_mod = int(use_camera) + int(use_lidar) + int(use_radar)
        if n_mod == 0:
            raise ValueError("No modality enabled")
        self._add_conv_bn("bev_fusion1", n_mod * c, 2 * c, 3)
        self._add_conv_bn("bev_fusion2", 2 * c, c, 3)

    def _add_conv_bn(self, name: str, cin: int, cout: int, k: int) -> None:
        self.add_module(f"{name}_conv", nn.Conv2d(cin, cout, k, 1, k // 2))
        self.add_module(f"{name}_bn", batch_norm(cout))

    def _conv_bn_relu(self, x: torch.Tensor, name: str) -> torch.Tensor:
        x = getattr(self, f"{name}_conv")(x)
        return F.relu(getattr(self, f"{name}_bn")(x))

    def forward(self, camera_features: Optional[torch.Tensor] = None,
                lidar_features: Optional[torch.Tensor] = None,
                radar_features: Optional[torch.Tensor] = None,
                camera_cells: Optional[torch.Tensor] = None,
                camera_chunks: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
        s = self.spec
        bev_feats = []
        for used, feats, name in (
            (self.use_camera, camera_features, "camera"),
            (self.use_lidar, lidar_features, "lidar"),
            (self.use_radar, radar_features, "radar"),
        ):
            if used and feats is None:
                raise ValueError(f"{name} is enabled but no {name} features were given")

        if self.use_camera and s.camera_to_bev == "geometric":
            if camera_features.ndim != 5:
                raise ValueError("geometric camera-to-BEV needs (B, N_cam, C, H', W') features")
            bev_feats.append(self.geometric_camera_bev(camera_features, camera_cells, camera_chunks))
        elif self.use_camera:
            cam = camera_features
            if cam.ndim == 5:  # mean over cameras (ref: fusion.py:233-236)
                cam = cam.mean(dim=1)
            cam = self._conv_bn_relu(cam, "camera_proj1")
            cam = self._conv_bn_relu(cam, "camera_proj2")
            bev_feats.append(bilinear_resize(cam, s.bev_h, s.bev_w))

        if self.use_lidar:
            hid, start = s.lidar_hidden_dim, s.lidar_start_size
            y = F.relu(self.lidar_init1(lidar_features))
            # channel-first reshape like the reference; already NCHW here
            y = self.lidar_init2(y).reshape(y.shape[0], hid, start, start)
            y = self._conv_bn_relu(y, "lidar_up1")
            y = bilinear_resize(y, start * 2, start * 2)
            y = self._conv_bn_relu(y, "lidar_up2")
            bev_feats.append(bilinear_resize(y, s.bev_h, s.bev_w))

        if self.use_radar:
            r = F.relu(self.radar_proj(radar_features))
            # broadcast the global vector over the grid (ref: fusion.py:277-278)
            r = r[:, :, None, None].expand(-1, -1, s.bev_h, s.bev_w)
            r = self._conv_bn_relu(r, "radar_refine1")
            bev_feats.append(self._conv_bn_relu(r, "radar_refine2"))

        x = torch.cat(bev_feats, dim=1)
        x = self._conv_bn_relu(x, "bev_fusion1")
        return self._conv_bn_relu(x, "bev_fusion2")
