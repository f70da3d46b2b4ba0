"""Plain PyTorch forward pass of the BEVFusion-style detector, from the
configuration and a flat variables dict.

This is the benchmark's yardstick: it imports nothing of the program. The
variables are the detector's published checkpoint layout (the flax tree of
the JAX package and of its port), flattened to ``"<collection>/<path>"``
keys: conv kernels HWIO, dense kernels (in, out), BatchNorm ``scale`` /
``bias`` in ``params`` and ``mean`` / ``var`` in ``batch_stats``.

The model (``configs/base.yaml`` of the reference repository):

- cameras (B, 6, H, W, 3), ImageNet-normalized, through a ResNet-18 trunk
  to layer3 (stride 16), a 1x1 projection to 512, BatchNorm, ReLU;
- camera to BEV, ``pseudo``: mean over the views, conv3x3-BN-ReLU to 512,
  conv1x1-BN-ReLU to 256, bilinear resize to the BEV grid; ``geometric``:
  a 1x1 depth head (softmax over the depth bins) and a 1x1 feature
  projection per view, each frustum point's feature times its depth
  probability summed into its BEV cell, summed over views, conv3x3-BN-ReLU;
- LiDAR (B, N, 4): a shared per-point MLP (dense-BN-ReLU) and a max over
  all N points, padding rows included (quirk Q13); dense 1024->512, ReLU,
  dense to 128x25x25, conv-BN-ReLU, bilinear x2, conv-BN-ReLU to 256;
- radar (B, 5, N_r, 7): the same per-point MLP shared by the five radars,
  their features concatenated, dense to 256, dense-ReLU, broadcast over the
  grid, conv-BN-ReLU twice;
- the three BEV maps concatenated, conv-BN-ReLU to 512 and to 256, and a
  CenterNet head of five conv3x3-ReLU-conv1x1 branches (heatmap sigmoided).

`precision` is ``"f32"`` (TF32 must be off, see `exact_float32`) or
``"fp8"``: the same arithmetic with every conv and dense input and weight
rounded to float8 e4m3 (one scale a tensor) and multiplied in bf16, the
serving cells' control. Normalizations, softmax and reductions stay in f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN convolutions inside; restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Spec:
    """The sizes the forward pass needs, read from the raw YAML dict."""

    def __init__(self, cfg: Dict):
        m, d = cfg["model"], cfg["dataset"]
        self.image_hw = tuple(m["camera_encoder"]["input_size"])
        self.cam_channels = m["camera_encoder"]["output_channels"]
        self.lidar_in = m["lidar_encoder"]["input_channels"]
        self.lidar_layers = list(m["lidar_encoder"]["mlp_layers"])
        self.lidar_points = m["lidar_encoder"]["max_points"]
        r = m["radar_encoder"]
        self.radar_in, self.radar_layers = r["input_channels"], list(r["mlp_layers"])
        self.num_radars, self.radar_points, self.radar_feat = r["num_radars"], r["max_points_per_sensor"], r["feature_dim"]
        b = m["bev_fusion"]
        self.bev_h, self.bev_w, self.bev_c = b["bev_h"], b["bev_w"], b["bev_channels"]
        self.camera_to_bev = b.get("camera_to_bev", "pseudo")
        self.depth_bins = b.get("depth_bins", 40)
        self.depth_min, self.depth_max = b.get("depth_min", 1.0), b.get("depth_max", 60.0)
        self.lidar_hidden, self.lidar_start = 128, 25
        h = m["centernet_head"]
        self.head_conv, self.num_classes = h["head_conv"], h["num_classes"]
        self.max_detections = h["max_detections"]
        self.pc_range = tuple(d["point_cloud_range"])
        self.num_cameras = d["cameras"]["num_cameras"]


# -- the variables' names and shapes -------------------------------------------

def _conv(shapes, name, k, cin, cout, bias=True):
    shapes[f"params/{name}/kernel"] = (k, k, cin, cout)
    if bias:
        shapes[f"params/{name}/bias"] = (cout,)


def _dense(shapes, name, cin, cout):
    shapes[f"params/{name}/kernel"] = (cin, cout)
    shapes[f"params/{name}/bias"] = (cout,)


def _bn(shapes, name, c):
    shapes[f"params/{name}/scale"] = (c,)
    shapes[f"params/{name}/bias"] = (c,)
    shapes[f"batch_stats/{name}/mean"] = (c,)
    shapes[f"batch_stats/{name}/var"] = (c,)


TRUNK = ((64, 1), (128, 2), (256, 2))  # (channels, first stride) of layer1..3


def variable_shapes(spec: Spec) -> Dict[str, Tuple[int, ...]]:
    """Every variable of the model, by flat name, in a fixed order."""
    s: Dict[str, Tuple[int, ...]] = {}
    t = "camera_encoder/trunk"
    _conv(s, f"{t}/conv1", 7, 3, 64, bias=False)
    _bn(s, f"{t}/bn1", 64)
    cin = 64
    for li, (ch, stride) in enumerate(TRUNK, start=1):
        for bi in range(2):
            blk = f"{t}/layer{li}_{bi}"
            first_stride = stride if bi == 0 else 1
            _conv(s, f"{blk}/conv1", 3, cin, ch, bias=False)
            _bn(s, f"{blk}/bn1", ch)
            _conv(s, f"{blk}/conv2", 3, ch, ch, bias=False)
            _bn(s, f"{blk}/bn2", ch)
            if first_stride != 1 or cin != ch:
                _conv(s, f"{blk}/downsample_conv", 1, cin, ch, bias=False)
                _bn(s, f"{blk}/downsample_bn", ch)
            cin = ch
    _conv(s, "camera_encoder/channel_proj", 1, 256, spec.cam_channels, bias=False)
    _bn(s, "camera_encoder/channel_proj_bn", spec.cam_channels)
    for enc, cin, layers in (("lidar_encoder/point_mlp", spec.lidar_in, spec.lidar_layers),
                             ("radar_encoder/shared_radar/point_mlp", spec.radar_in, spec.radar_layers)):
        for i, out in enumerate(layers, start=1):
            _dense(s, f"{enc}/mlp{i}", cin, out)
            _bn(s, f"{enc}/bn{i}", out)
            cin = out
    _dense(s, "radar_encoder/fusion", spec.num_radars * spec.radar_layers[-1], spec.radar_feat)
    c = spec.bev_c
    if spec.camera_to_bev == "geometric":
        g = "fusion/geometric_camera_bev"
        _conv(s, f"{g}/depth_head", 1, spec.cam_channels, spec.depth_bins)
        _conv(s, f"{g}/feat_proj", 1, spec.cam_channels, c)
        _conv(s, f"{g}/splat_refine_conv", 3, c, c)
        _bn(s, f"{g}/splat_refine_bn", c)
    else:
        _conv(s, "fusion/camera_proj1_conv", 3, spec.cam_channels, 512)
        _bn(s, "fusion/camera_proj1_bn", 512)
        _conv(s, "fusion/camera_proj2_conv", 1, 512, c)
        _bn(s, "fusion/camera_proj2_bn", c)
    hid, start = spec.lidar_hidden, spec.lidar_start
    _dense(s, "fusion/lidar_init1", spec.lidar_layers[-1], 512)
    _dense(s, "fusion/lidar_init2", 512, hid * start * start)
    _conv(s, "fusion/lidar_up1_conv", 3, hid, hid)
    _bn(s, "fusion/lidar_up1_bn", hid)
    _conv(s, "fusion/lidar_up2_conv", 3, hid, c)
    _bn(s, "fusion/lidar_up2_bn", c)
    _dense(s, "fusion/radar_proj", spec.radar_feat, c)
    for n in ("radar_refine1", "radar_refine2"):
        _conv(s, f"fusion/{n}_conv", 3, c, c)
        _bn(s, f"fusion/{n}_bn", c)
    _conv(s, "fusion/bev_fusion1_conv", 3, 3 * c, 2 * c)
    _bn(s, "fusion/bev_fusion1_bn", 2 * c)
    _conv(s, "fusion/bev_fusion2_conv", 3, 2 * c, c)
    _bn(s, "fusion/bev_fusion2_bn", c)
    for name, out in (("heatmap", spec.num_classes), ("offset", 2), ("size", 3), ("rot", 2), ("vel", 2)):
        _conv(s, f"det_head/{name}_head/conv1", 3, c, spec.head_conv)
        _conv(s, f"det_head/{name}_head/conv2", 1, spec.head_conv, out)
    return s


# -- arithmetic ---------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, back in bf16."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)


class Forward:
    """One forward pass: `train` takes batch statistics (and records them in
    `stats` when given), else the running statistics."""

    def __init__(self, spec: Spec, v: Dict[str, torch.Tensor], train: bool = False,
                 precision: str = "f32", stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.spec, self.v, self.train, self.precision, self.stats = spec, v, train, precision, stats

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.precision == "fp8" else x.float()

    def conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        k = self.v[f"params/{name}/kernel"]
        pad = k.shape[0] // 2
        w = self._in(k.permute(3, 2, 0, 1))
        b = self.v.get(f"params/{name}/bias")
        y = F.conv2d(self._in(x), w, None, stride, pad).float()
        return y if b is None else y + b.float()[None, :, None, None]

    def dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        k, b = self.v[f"params/{name}/kernel"], self.v[f"params/{name}/bias"]
        return (self._in(x) @ self._in(k)).float() + b.float()

    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """BatchNorm over every axis but the channels (axis 1 of NCHW, the
        last of point rows)."""
        x = x.float()
        ch_last = x.ndim == 2
        dims = [0] if ch_last else [0, 2, 3]
        shape = (1, -1) if ch_last else (1, -1, 1, 1)
        if self.train:
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            if self.stats is not None:
                self.stats[name] = (mean.detach(), var.detach())
        else:
            mean = self.v[f"batch_stats/{name}/mean"].float()
            var = self.v[f"batch_stats/{name}/var"].float()
        inv = torch.rsqrt(var + BN_EPS) * self.v[f"params/{name}/scale"].float()
        return (x - mean.view(shape)) * inv.view(shape) + self.v[f"params/{name}/bias"].float().view(shape)

    def conv_bn_relu(self, x, name, stride=1):
        return F.relu(self.bn(self.conv(x, f"{name}_conv", stride), f"{name}_bn"))

    # -- modules --
    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        t = "camera_encoder/trunk"
        x = F.relu(self.bn(self.conv(x, f"{t}/conv1", 2), f"{t}/bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        cin = 64
        for li, (ch, stride) in enumerate(TRUNK, start=1):
            for bi in range(2):
                blk = f"{t}/layer{li}_{bi}"
                st = stride if bi == 0 else 1
                y = F.relu(self.bn(self.conv(x, f"{blk}/conv1", st), f"{blk}/bn1"))
                y = self.bn(self.conv(y, f"{blk}/conv2"), f"{blk}/bn2")
                if st != 1 or cin != ch:
                    x = self.bn(self.conv(x, f"{blk}/downsample_conv", st), f"{blk}/downsample_bn")
                x = F.relu(y + x)
                cin = ch
        return x

    def camera(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) normalized -> (B, N, C, H/16, W/16)."""
        b, n = imgs.shape[:2]
        x = imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)
        x = self.trunk(x)
        x = F.relu(self.bn(self.conv(x, "camera_encoder/channel_proj"), "camera_encoder/channel_proj_bn"))
        return x.reshape((b, n) + x.shape[1:])

    def points(self, pts: torch.Tensor, prefix: str, n_layers: int) -> torch.Tensor:
        """(B, N, C) -> (B, feat): the shared MLP and the max over all rows."""
        b, n, c = pts.shape
        x = pts.reshape(b * n, c).float()
        for i in range(1, n_layers + 1):
            x = F.relu(self.bn(self.dense(x, f"{prefix}/mlp{i}"), f"{prefix}/bn{i}"))
        return x.reshape(b, n, -1).amax(dim=1)

    def geometric(self, feats: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
        """feats (B, N, C, h, w), cells (N, D, h, w) int (-1 out of range)
        -> (B, bev_c, bev_h, bev_w): the lift-splat as dense per-view
        weights (cells x pixels) and one batched product."""
        s = self.spec
        b, n, c, h, w = feats.shape
        g = "fusion/geometric_camera_bev"
        flat = feats.reshape(b * n, c, h, w)
        probs = torch.softmax(self.conv(flat, f"{g}/depth_head"), dim=1)  # (BN, D, h, w) f32
        feat = self.conv(flat, f"{g}/feat_proj")  # (BN, C', h, w)
        num_cells, hw, d = s.bev_h * s.bev_w, h * w, probs.shape[1]
        ids = cells.reshape(1, n, d, hw).expand(b, -1, -1, -1).reshape(b * n, d, hw).long()
        ids = torch.where(ids < 0, torch.full_like(ids, num_cells), ids)
        dest = ids + torch.arange(hw, device=ids.device) * (num_cells + 1)
        weights = torch.zeros(b * n, hw * (num_cells + 1), device=feats.device)
        weights.scatter_add_(1, dest.reshape(b * n, -1), probs.reshape(b * n, -1))
        weights = weights.reshape(b * n, hw, num_cells + 1)[:, :, :num_cells]
        feat_rows = feat.reshape(b * n, -1, hw).transpose(1, 2)  # (BN, hw, C')
        bev = torch.bmm(self._in(weights.transpose(1, 2)), self._in(feat_rows)).float()
        bev = bev.reshape(b, n, num_cells, -1).sum(dim=1)  # (B, cells, C')
        bev = bev.transpose(1, 2).reshape(b, -1, s.bev_h, s.bev_w)
        return F.relu(self.bn(self.conv(bev, f"{g}/splat_refine_conv"), f"{g}/splat_refine_bn"))

    def __call__(self, imgs: torch.Tensor, lidar: torch.Tensor, radar: torch.Tensor,
                 cells: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """imgs (B, N, H, W, 3) normalized f32, lidar (B, N_l, C_l), radar
        (B, R, N_r, C_r) -> NHWC maps heatmap (sigmoided), offset, size,
        rot, vel, in f32."""
        s = self.spec
        cam = self.camera(imgs)
        if s.camera_to_bev == "geometric":
            cam_bev = self.geometric(cam, cells)
        else:
            x = self.conv_bn_relu(cam.float().mean(dim=1), "fusion/camera_proj1")
            x = self.conv_bn_relu(x, "fusion/camera_proj2")
            cam_bev = _resize(x, s.bev_h, s.bev_w)
        lf = self.points(lidar, "lidar_encoder/point_mlp", len(s.lidar_layers))
        y = F.relu(self.dense(lf, "fusion/lidar_init1"))
        y = self.dense(y, "fusion/lidar_init2").reshape(-1, s.lidar_hidden, s.lidar_start, s.lidar_start)
        y = self.conv_bn_relu(y, "fusion/lidar_up1")
        y = _resize(y, 2 * s.lidar_start, 2 * s.lidar_start)
        y = self.conv_bn_relu(y, "fusion/lidar_up2")
        lidar_bev = _resize(y, s.bev_h, s.bev_w)
        b, r = radar.shape[:2]
        rf = self.points(radar.reshape((b * r,) + radar.shape[2:]), "radar_encoder/shared_radar/point_mlp",
                         len(s.radar_layers))
        rf = self.dense(rf.reshape(b, -1), "radar_encoder/fusion")
        rb = F.relu(self.dense(rf, "fusion/radar_proj"))[:, :, None, None].expand(-1, -1, s.bev_h, s.bev_w)
        rb = self.conv_bn_relu(rb, "fusion/radar_refine1")
        rb = self.conv_bn_relu(rb, "fusion/radar_refine2")
        x = torch.cat([cam_bev.float(), lidar_bev.float(), rb.float()], dim=1)
        x = self.conv_bn_relu(x, "fusion/bev_fusion1")
        x = self.conv_bn_relu(x, "fusion/bev_fusion2")
        out = {}
        for name in ("heatmap", "offset", "size", "rot", "vel"):
            y = self.conv(F.relu(self.conv(x, f"det_head/{name}_head/conv1")), f"det_head/{name}_head/conv2")
            out[name] = (torch.sigmoid(y) if name == "heatmap" else y).permute(0, 2, 3, 1)
        return out


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize, half-pixel centres; antialiased where it shrinks."""
    if x.shape[2] == h and x.shape[3] == w:
        return x
    shrink = h < x.shape[2] or w < x.shape[3]
    return F.interpolate(x.float(), size=(h, w), mode="bilinear", align_corners=False, antialias=shrink)


def normalize_uint8(imgs: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> ImageNet-normalized f32."""
    mean = torch.tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, device=imgs.device)
    return (imgs.float() / 255.0 - mean) / std


def calibrate_statistics(spec: Spec, v: Dict[str, torch.Tensor], imgs, lidar, radar, cells=None) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    one forward pass over these inputs (f32), as a trained model's would
    match the data it sees."""
    stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    with torch.no_grad(), exact_float32():
        Forward(spec, v, train=True, stats=stats)(imgs, lidar, radar, cells)
    for name, (mean, var) in stats.items():
        v[f"batch_stats/{name}/mean"].copy_(mean)
        v[f"batch_stats/{name}/var"].copy_(var)


def make_variables(spec: Spec, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded variables in a few large draws on `device`: conv and dense
    kernels LeCun-normal (std 1/sqrt(fan_in)), biases N(0, 0.1^2), BatchNorm
    scales U(0.5, 1.5) and biases N(0, 0.1^2); running statistics zero mean
    and unit variance until `calibrate_statistics`."""
    shapes = variable_shapes(spec)
    sizes = [math.prod(s) for s in shapes.values()]
    normal = torch.randn(sum(sizes), generator=generator, device=device)
    uniform = torch.rand(sum(sizes), generator=generator, device=device)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for (name, shape), size in zip(shapes.items(), sizes):
        n, u = normal[offset:offset + size].view(shape), uniform[offset:offset + size].view(shape)
        offset += size
        leaf = name.rsplit("/", 1)[1]
        if leaf == "kernel":
            t = n / math.sqrt(math.prod(shape[:-1]))
        elif leaf == "scale":
            t = 0.5 + u
        elif leaf == "mean":
            t = torch.zeros(shape, device=device)
        elif leaf == "var":
            t = torch.ones(shape, device=device)
        else:
            t = 0.1 * n
        out[name] = t.contiguous()
    return out

