"""Modality encoders (PyTorch, NCHW inside).

Port of ``bevfusion_multimodal_3d_object_detection_tpu/models/encoders.py``:

- `ResNetCameraEncoder` (``:34-79``): ResNet-18 trunk (stride 16) + 1x1
  projection 256->512 + BN + ReLU; the 6 views fold into the batch;
  ``remat`` checkpoints the trunk's residual blocks in training.
- `PointNetLiDAREncoder`, `RadarEncoder`, `MultiRadarEncoder` (``:141-283``):
  shared per-point MLPs + global max. In eval mode the whole chain runs as
  the fused PointNet (`ops.pointnet_fused`, BN folded from the module's own
  buffers once and reused until the weights change): the kernel on a CUDA
  tensor, its plain version on a CPU tensor. The MLP's parameters and
  buffers stay f32 when the model is cast, so the fold runs in f32 and each
  folded weight is rounded once to the working dtype, as in the JAX package.
  Train mode runs the plain chain (the JAX package trains on it too), with
  BatchNorm batch statistics over batch x points in the MLP's f32 and
  flax's running statistics (`models.batch_norm`).
- `VFELayer`, `VoxelNetLiDAREncoder` (``:286-401``): a point MLP, a
  scatter-max of the points into a coarse voxel grid (``.at[].max`` in JAX,
  ``scatter_reduce(..., "amax")`` here: no hand kernel, neither package has
  one), three stride-2 3-D convs and a max over space. Its point MLP is not
  fused and follows a cast of the model, as the JAX package computes it in
  the model's dtype. `VFELayer` is unused, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CameraEncoderSpec, LidarEncoderSpec, RadarEncoderSpec
from ..ops.pointnet_fused import pointnet_fused
from .batch_norm import FlaxBatchNorm1d, FlaxBatchNorm3d
from .resnet import ResNet18Trunk, batch_norm

_NEG_INF = -1e9


class ResNetCameraEncoder(nn.Module):
    """(B, N_cam, 3, H, W) or (B*N_cam, 3, H, W) -> the same leading axes
    with (out_channels, H/16, W/16)."""

    def __init__(self, spec: CameraEncoderSpec = CameraEncoderSpec(),
                 fold_bn: bool = False):
        super().__init__()
        self.spec = spec
        self.fold_bn = fold_bn
        self.trunk = ResNet18Trunk(fold_bn=fold_bn, remat=spec.remat)
        self.channel_proj = nn.Conv2d(
            self.trunk.out_channels, spec.out_channels, 1, bias=fold_bn
        )
        if not fold_bn:
            self.channel_proj_bn = batch_norm(spec.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        x = self.channel_proj(self.trunk(x))
        if not self.fold_bn:
            x = self.channel_proj_bn(x)
        x = F.relu(x)
        return x.reshape(lead + x.shape[1:])


class _PointMLP(nn.Module):
    """Shared per-point MLP: Linear + (BatchNorm) + ReLU per layer over
    (B, N, C); BN statistics run over batch and points, like BatchNorm1d on
    (B, C, N)."""

    def __init__(self, in_channels: int, layers: Sequence[int], use_bn: bool = True,
                 keep_f32: bool = True):
        super().__init__()
        self.num_layers = len(layers)
        self.use_bn = use_bn
        self.keep_f32 = keep_f32
        width = in_channels
        for i, out in enumerate(layers):
            self.add_module(f"mlp{i + 1}", nn.Linear(width, out))
            if use_bn:
                self.add_module(f"bn{i + 1}", FlaxBatchNorm1d(out, eps=1e-5, momentum=0.1))
            width = out

    def _apply(self, fn, recurse=True):
        # BatchNorm folds from the f32 parameters, as the JAX fused path does
        # (pointnet_pallas.py:51-68): a cast of the model to a narrower type
        # (.to(bf16), .half()) moves this MLP's tensors to the new device but
        # keeps them in f32; a cast to f64 is followed. With keep_f32=False
        # (an MLP that B1 never folds) every cast is followed.
        if not self.keep_f32:
            return super()._apply(fn, recurse)

        def keep_f32(t):
            out = fn(t)
            if (t.dtype == torch.float32 and out.is_floating_point()
                    and out.dtype.itemsize < t.dtype.itemsize):
                out = t.detach().to(out.device)
            return out

        return super()._apply(keep_f32, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"mlp{i}")(x)
            if self.use_bn:
                shape = x.shape
                x = getattr(self, f"bn{i}")(x.reshape(-1, shape[-1])).reshape(shape)
            x = F.relu(x)
        return x

    def folded(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """f32 (in, out) weights and biases with inference BN folded in
        (``pointnet_pallas.py:36-68``)."""
        weights, biases = [], []
        for i in range(1, self.num_layers + 1):
            lin = getattr(self, f"mlp{i}")
            w = lin.weight.float().t()
            b = lin.bias.float()
            if self.use_bn:
                bn = getattr(self, f"bn{i}")
                inv = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
                w = w * inv[None, :]
                b = (b - bn.running_mean.float()) * inv + bn.bias.float()
            weights.append(w)
            biases.append(b.contiguous())
        return weights, biases


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    """Max over `dim`, leaving out elements where `mask` is False; rows with
    every element masked give 0. `mask=None` is the plain max (quirk Q13)."""
    if mask is None:
        return x.amax(dim=dim)
    neg = torch.tensor(_NEG_INF, dtype=x.dtype, device=x.device)
    out = torch.where(mask, x, neg).amax(dim=dim)
    return torch.where(out <= neg, torch.zeros_like(out), out)


def points_validity_mask(points: torch.Tensor) -> torch.Tensor:
    """(..., N, C) -> (..., N, 1) bool: True where any channel is nonzero."""
    return (points != 0).any(dim=-1, keepdim=True)


class _PointEncoder(nn.Module):
    """Point MLP + global max over points, fused at inference."""

    def __init__(self, in_channels: int, layers: Sequence[int], use_bn: bool,
                 mask_padding: bool):
        super().__init__()
        self.in_channels = in_channels
        self.mask_padding = mask_padding
        self.point_mlp = _PointMLP(in_channels, layers, use_bn)
        self.out_channels = layers[-1]
        self._fold_cache = None  # (key, weights, biases) of the last fold

    def _apply(self, *args, **kwargs):
        self._fold_cache = None  # .to() / .cuda() / .half() replace the tensors
        return super()._apply(*args, **kwargs)

    def _folded(self, dtype: torch.dtype, device: torch.device):
        """Folded weights in `dtype` and f32 biases on `device`, made once and
        reused until a parameter or buffer of the MLP changes."""
        tensors = [*self.point_mlp.parameters(), *self.point_mlp.buffers()]
        key = (dtype, device, tuple((t.data_ptr(), t._version) for t in tensors))
        if self._fold_cache is None or self._fold_cache[0] != key:
            # ordinary tensors even when called under inference_mode
            with torch.inference_mode(False), torch.no_grad():
                weights, biases = self.point_mlp.folded()
                weights = [w.to(device, dtype).contiguous() for w in weights]
                biases = [b.to(device) for b in biases]
            self._fold_cache = (key, weights, biases)
        return self._fold_cache[1], self._fold_cache[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # accept (B, C, N) like the reference (encoders.py:160, :207)
        c_in = self.in_channels
        if x.ndim == 3 and x.shape[-1] != c_in and x.shape[1] == c_in:
            x = x.transpose(1, 2)
        if not self.training:
            weights, biases = self._folded(x.dtype, x.device)
            return pointnet_fused(
                x.contiguous(), weights, biases, mask_padding=self.mask_padding
            )
        mask = points_validity_mask(x) if self.mask_padding else None
        mlp_dtype = self.point_mlp.mlp1.weight.dtype  # f32 under a cast model
        return masked_max(self.point_mlp(x.to(mlp_dtype)), mask, dim=1).to(x.dtype)


class PointNetLiDAREncoder(_PointEncoder):
    """(B, N, C) or (B, C, N) zero-padded points -> (B, mlp_layers[-1])."""

    def __init__(self, spec: LidarEncoderSpec = LidarEncoderSpec(),
                 mask_padding: bool = False):
        super().__init__(spec.input_channels, spec.mlp_layers,
                         spec.use_batch_norm, mask_padding)
        self.spec = spec


class RadarEncoder(_PointEncoder):
    """Single-radar PointNet-lite: (B, N, 7) -> (B, mlp_layers[-1])."""

    def __init__(self, spec: RadarEncoderSpec = RadarEncoderSpec(),
                 mask_padding: bool = False):
        super().__init__(spec.input_channels, spec.mlp_layers,
                         spec.use_batch_norm, mask_padding)
        self.spec = spec


class MultiRadarEncoder(nn.Module):
    """Shared RadarEncoder over R radars (folded into the batch) + fusion:
    (B, R, N, 7) -> (B, feat_dim) for concat, (B, mlp_layers[-1]) for
    max / mean."""

    def __init__(self, spec: RadarEncoderSpec = RadarEncoderSpec(),
                 mask_padding: bool = False):
        super().__init__()
        self.spec = spec
        self.shared_radar = RadarEncoder(spec, mask_padding)
        width = self.shared_radar.out_channels
        if spec.fusion_method == "concat":
            self.fusion = nn.Linear(spec.num_radars * width, spec.feat_dim)
            self.out_channels = spec.feat_dim
        elif spec.fusion_method in ("max", "mean"):
            self.out_channels = width
        else:
            raise ValueError(f"Unknown radar fusion method: {spec.fusion_method}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, r = x.shape[0], x.shape[1]
        feats = self.shared_radar(x.reshape((b * r,) + x.shape[2:])).reshape(b, r, -1)
        method = self.spec.fusion_method
        if method == "concat":
            # radar-major flatten before Linear(R*feat -> feat) (encoders.py:272-276)
            return self.fusion(feats.reshape(b, -1))
        if method == "max":
            return feats.amax(dim=1)
        return feats.mean(dim=1)


class VFELayer(nn.Module):
    """Voxel feature encoding (``encoders.py:286-305``): Linear -> BatchNorm
    -> ReLU to out_channels // 2, then each point's features concatenated
    with their (masked) max over the voxel's points. (V, P, C) ->
    (V, P, out_channels); `mask` (V, P, 1) bool or None."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        half = out_channels // 2
        self.dense = nn.Linear(in_channels, half)
        self.bn = FlaxBatchNorm1d(half, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.dense(x)
        y = F.relu(self.bn(y.reshape(-1, y.shape[-1])).reshape(y.shape))
        agg = masked_max(y, mask, dim=-2)[..., None, :].expand_as(y)
        return torch.cat([y, agg], dim=-1)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor of `like`'s dtype, as JAX's weak
    typing rounds it before the operation (it matters in bf16)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


class VoxelNetLiDAREncoder(nn.Module):
    """(B, N, C) zero-padded points -> (B, feat_dim) (``encoders.py:308-401``).

    A point MLP 4 -> 32 -> 64 (``vfe``), voxel ids on a (D, H, W) grid over
    `pc_range` (padded points go to a trash voxel), a scatter-max of the
    point features into the voxels (empty voxels 0), three stride-2
    Conv3d + BatchNorm + ReLU (64, 128, 256), a max over space and a dense
    projection. Convolutions run NCDHW."""

    def __init__(self, spec: LidarEncoderSpec = LidarEncoderSpec(),
                 pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 grid: Tuple[int, int, int] = (10, 32, 32)):
        super().__init__()
        self.spec, self.pc_range, self.grid = spec, tuple(pc_range), tuple(grid)
        self.vfe = _PointMLP(spec.input_channels, (32, 64), spec.use_batch_norm, keep_f32=False)
        width = 64
        for i, ch in enumerate((64, 128, 256), start=1):
            self.add_module(f"conv3d_{i}", nn.Conv3d(width, ch, 3, 2, 1))
            self.add_module(f"conv3d_bn{i}", FlaxBatchNorm3d(ch, eps=1e-5, momentum=0.1))
            width = ch
        self.proj = nn.Linear(width, spec.feat_dim)
        self.out_channels = spec.feat_dim

    def voxel_ids(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, N) voxel index of each point in [0, D*H*W), D*H*W for padding,
        with the JAX package's arithmetic in the points' dtype."""
        d, h, w = self.grid
        x_min, y_min, z_min, x_max, y_max, z_max = self.pc_range

        def index(coord, lo, hi, n):
            t = (coord - _scalar(lo, coord)) / _scalar(hi - lo, coord) * _scalar(n, coord)
            return t.to(torch.int32).clamp(0, n - 1).long()

        ix = index(x[..., 0], x_min, x_max, w)
        iy = index(x[..., 1], y_min, y_max, h)
        iz = index(x[..., 2], z_min, z_max, d)
        vid = (iz * h + iy) * w + ix
        return torch.where(mask[..., 0], vid, torch.full_like(vid, d * h * w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        d, h, w = self.grid
        mask = points_validity_mask(x)
        feats = self.vfe(x)  # (B, N, 64)
        c = feats.shape[-1]
        vid = self.voxel_ids(x, mask)
        neg = _scalar(_NEG_INF, feats)
        feats = torch.where(mask, feats, neg)
        voxels = torch.full((b, d * h * w + 1, c), _NEG_INF, dtype=feats.dtype, device=feats.device)
        voxels = voxels.scatter_reduce(1, vid[..., None].expand(-1, -1, c), feats, "amax")
        voxels = voxels[:, : d * h * w]
        voxels = torch.where(voxels <= neg, torch.zeros_like(voxels), voxels)
        voxels = voxels.reshape(b, d, h, w, c).permute(0, 4, 1, 2, 3)  # NDHWC -> NCDHW
        for i in (1, 2, 3):
            voxels = getattr(self, f"conv3d_{i}")(voxels)
            voxels = F.relu(getattr(self, f"conv3d_bn{i}")(voxels))
        return self.proj(voxels.amax(dim=(2, 3, 4)))
