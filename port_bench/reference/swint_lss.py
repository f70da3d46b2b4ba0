"""Plain PyTorch forward pass of `bevfusion_swint_lss`: BEVFusion's camera
stream (Swin-T, GeneralizedLSSFPN, the LSS lift onto a 360x360 camera grid
and its 2x downsample) feeding the detector of `reference.model`.

It imports nothing of the program; it reuses `reference.model` by import
(the variables' layout, the seeded draws' rules, the BatchNorm, the LiDAR
and radar branches, the fusion and the head). The equations:

- Swin-T (Liu et al., arXiv 2103.14030, as mmdet builds it for BEVFusion):
  a 4x4 stride-4 patch convolution and LayerNorm (eps 1e-5); four stages of
  2, 2, 6, 2 blocks at 96, 192, 384, 768 channels with 3, 6, 12, 24 heads;
  a block is x + W-MSA(LN(x)), then x + fc2(GELU(fc1(LN(x)))), the odd
  blocks shifted. W-MSA pads the map with zeros to whole 7x7 windows after
  the LayerNorm, rolls a shifted block's map by -3 on both axes, and in
  each window adds to q k^T / sqrt(d) the relative-position bias (a
  (13 x 13, heads) table, indexed as mmdet's ``double_step_seq`` does) and,
  shifted, -100 between tokens of different regions of the rolled map;
  softmax, times v, the output dense, rolled back and cropped. Between
  stages a 2x2 patch merge (the tokens at (0,0), (1,0), (0,1), (1,1) of each
  block concatenated, LayerNorm, a dense without bias to twice the
  channels). Stages 1, 2, 3 go on, each through its own LayerNorm;
- GeneralizedLSSFPN: stage 3 resized bilinearly (half-pixel) to stage 2's
  16x44, concatenated after it, conv1x1-BN-ReLU to 256 and conv3x3-BN-ReLU;
  that resized to stage 1's 32x88, likewise; the 32x88x256 map goes on;
- the LSS lift: a 1x1 depth conv (softmax over 118 bins) and a 1x1
  feature conv to 80; every frustum point's feature x probability added
  by `index_add_` into its cell of the 360x360 grid (`frustum_cells`:
  pixel centres (i + 0.5) x 8, x / y over [-54, 54) in 0.3 m, z in
  [-10, 10)), summed over the six cameras; then conv3x3-BN-ReLU,
  stride-2 conv3x3-BN-ReLU, conv3x3-BN-ReLU (no conv biases) to 180x180;
- the rest as `reference.model.Forward` on the 180x180 grid, the fusion's
  first conv taking 80 + 256 + 256 channels.

Float32 throughout, TF32 off (`reference.model.exact_float32`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import model as ref

LN_EPS = 1e-5
MASKED = -100.0
BIAS_TABLE_STD = 1.0  # a trained table's scale: the bias moves the logits as q k^T does


class Spec(ref.Spec):
    """`reference.model.Spec` and the camera stream's sizes."""

    def __init__(self, cfg: Dict):
        super().__init__(cfg)
        cam, b = cfg["model"]["camera_encoder"], cfg["model"]["bev_fusion"]
        sw = cam["swin"]
        self.embed, self.depths, self.heads = sw["embed_dim"], list(sw["depths"]), list(sw["num_heads"])
        self.window, self.mlp_ratio, self.patch = sw["window_size"], sw["mlp_ratio"], sw["patch_size"]
        self.out_indices = list(sw["out_indices"])
        self.stride = self.patch * 2 ** self.out_indices[0]
        down = b["camera_downsample"]
        self.cam_h, self.cam_w = b["bev_h"] * down, b["bev_w"] * down
        self.cam_c = b["camera_bev_channels"]
        self.zbound = tuple(b["camera_zbound"])

    @property
    def feature_hw(self) -> Tuple[int, int]:
        return self.image_hw[0] // self.stride, self.image_hw[1] // self.stride


# -- the variables' names and shapes -------------------------------------------

def _ln(shapes, name, c):
    shapes[f"params/{name}/scale"] = (c,)
    shapes[f"params/{name}/bias"] = (c,)


def variable_shapes(spec: Spec) -> Dict[str, Tuple[int, ...]]:
    """Every variable, by flat name, in a fixed order: the camera stream,
    then `reference.model`'s LiDAR, radar, fusion and head."""
    s: Dict[str, Tuple[int, ...]] = {}
    t, c = "camera_encoder/trunk", spec.embed
    ref._conv(s, f"{t}/patch_embed", spec.patch, 3, c)
    _ln(s, f"{t}/patch_norm", c)
    for i, (depth, heads) in enumerate(zip(spec.depths, spec.heads)):
        dim = c * 2 ** i
        for j in range(depth):
            blk = f"{t}/stage{i}_block{j}"
            _ln(s, f"{blk}/norm1", dim)
            ref._dense(s, f"{blk}/attn/qkv", dim, 3 * dim)
            ref._dense(s, f"{blk}/attn/proj", dim, dim)
            s[f"params/{blk}/attn/relative_position_bias_table"] = ((2 * spec.window - 1) ** 2, heads)
            _ln(s, f"{blk}/norm2", dim)
            hidden = int(dim * spec.mlp_ratio)
            ref._dense(s, f"{blk}/fc1", dim, hidden)
            ref._dense(s, f"{blk}/fc2", hidden, dim)
        if i in spec.out_indices:
            _ln(s, f"{t}/out_norm{i}", dim)
        if i < len(spec.depths) - 1:
            _ln(s, f"{t}/stage{i}_merge/norm", 4 * dim)
            s[f"params/{t}/stage{i}_merge/reduction/kernel"] = (4 * dim, 2 * dim)
    widths = [c * 2 ** i for i in spec.out_indices]
    out = spec.cam_channels
    for i in range(len(widths) - 1):
        above = widths[i + 1] if i == len(widths) - 2 else out
        ref._conv(s, f"camera_encoder/neck/lateral{i}_conv", 1, widths[i] + above, out, bias=False)
        ref._bn(s, f"camera_encoder/neck/lateral{i}_bn", out)
        ref._conv(s, f"camera_encoder/neck/fpn{i}_conv", 3, out, out, bias=False)
        ref._bn(s, f"camera_encoder/neck/fpn{i}_bn", out)
    g = "fusion/geometric_camera_bev"
    ref._conv(s, f"{g}/depth_head", 1, out, spec.depth_bins)
    ref._conv(s, f"{g}/feat_proj", 1, out, spec.cam_c)
    for i in (1, 2, 3):
        ref._conv(s, f"{g}/downsample{i}_conv", 3, spec.cam_c, spec.cam_c, bias=False)
        ref._bn(s, f"{g}/downsample{i}_bn", spec.cam_c)
    for name, shape in ref.variable_shapes(spec).items():  # the ResNet stream's left out
        if not name.split("/", 1)[1].startswith(("camera_encoder/", "fusion/geometric_camera_bev/")):
            s[name] = shape
    bev = spec.bev_c
    s["params/fusion/bev_fusion1_conv/kernel"] = (3, 3, spec.cam_c + 2 * bev, 2 * bev)
    return s


def make_variables(spec: Spec, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded variables by `reference.model.make_variables`' rules (kernels
    LeCun-normal, biases N(0, 0.1^2), scales U(0.5, 1.5), running statistics
    0 / 1), and the relative-position bias tables N(0, BIAS_TABLE_STD^2)."""
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
        elif leaf == "relative_position_bias_table":
            t = BIAS_TABLE_STD * n
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


# -- geometry ------------------------------------------------------------------

def frustum_cells(spec: Spec, calibration: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]) -> np.ndarray:
    """(N_cam, D, H/8, W/8) int64 flat cell ids of the camera grid, -1 out
    of the grid or of the z range."""
    ih, iw = spec.image_hw
    fh, fw = spec.feature_hw
    depths = np.linspace(spec.depth_min, spec.depth_max, spec.depth_bins)
    uu, vv = np.meshgrid((np.arange(fw) + 0.5) * spec.stride, (np.arange(fh) + 0.5) * spec.stride)
    x0, y0, _, x1, y1, _ = spec.pc_range
    vx, vy = (x1 - x0) / spec.cam_w, (y1 - y0) / spec.cam_h
    out = []
    for intr, rot, trans in calibration:
        rays = np.stack([uu, vv, np.ones_like(uu)], -1) @ np.linalg.inv(intr).T
        pts = rays[None] * depths[:, None, None, None]
        pts = pts @ np.asarray(rot).T + np.asarray(trans)
        ix = np.floor((pts[..., 0] - x0) / vx).astype(np.int64)
        iy = np.floor((pts[..., 1] - y0) / vy).astype(np.int64)
        keep = ((ix >= 0) & (ix < spec.cam_w) & (iy >= 0) & (iy < spec.cam_h)
                & (pts[..., 2] >= spec.zbound[0]) & (pts[..., 2] < spec.zbound[1]))
        out.append(np.where(keep, iy * spec.cam_w + ix, -1))
    return np.stack(out)


# -- arithmetic ----------------------------------------------------------------

def _relative_index(window: int) -> torch.Tensor:
    """(window^2, window^2) index into the bias table, as mmdet builds it."""
    seq = (torch.arange(0, (2 * window - 1) * window, 2 * window - 1)[:, None]
           + torch.arange(window)[None, :]).reshape(1, -1)
    return (seq + seq.T).flip(1)


def _region_mask(h: int, w: int, window: int, shift: int, device) -> torch.Tensor:
    """(windows, window^2, window^2): -100 between tokens of the rolled
    h x w map that lie in different regions, else 0."""
    def band(n):
        i = torch.arange(n, device=device)
        return (i >= n - window).long() + (i >= n - shift).long()

    label = band(h)[:, None] * 3 + band(w)[None, :]
    win = label.reshape(h // window, window, w // window, window).transpose(1, 2).reshape(-1, window * window)
    return torch.where(win[:, :, None] == win[:, None, :], 0.0, MASKED)


class Forward(ref.Forward):
    """`reference.model.Forward` with the camera stream of this module."""

    spec: Spec

    def ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """LayerNorm over the last axis."""
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).pow(2).mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + LN_EPS) * self.v[f"params/{name}/scale"].float()
                + self.v[f"params/{name}/bias"].float())

    def attention(self, x: torch.Tensor, name: str, heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (N, windows, T, C) -> the same: W-MSA with the bias (and mask)."""
        n, nw, t, c = x.shape
        d = c // heads
        qkv = self.dense(x, f"{name}/qkv").reshape(n, nw, t, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
        logits = q @ k.transpose(-1, -2)  # (N, windows, heads, T, T)
        table = self.v[f"params/{name}/relative_position_bias_table"].float()
        index = _relative_index(self.spec.window).to(table.device)
        logits = logits + table[index.reshape(-1)].reshape(t, t, heads).permute(2, 0, 1)
        if mask is not None:
            logits = logits + mask[None, :, None]
        out = torch.softmax(logits, dim=-1) @ v
        return self.dense(out.transpose(2, 3).reshape(n, nw, t, c), f"{name}/proj")

    def block(self, x: torch.Tensor, name: str, heads: int, shift: int) -> torch.Tensor:
        w = self.spec.window
        n, h, wd, c = x.shape
        hp, wp = h + (-h) % w, wd + (-wd) % w
        y = torch.zeros(n, hp, wp, c, device=x.device)
        y[:, :h, :wd] = self.ln(x, f"{name}/norm1")
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
        wins = y.reshape(n, hp // w, w, wp // w, w, c).transpose(2, 3).reshape(n, -1, w * w, c)
        mask = _region_mask(hp, wp, w, shift, x.device) if shift else None
        wins = self.attention(wins, f"{name}/attn", heads, mask)
        y = wins.reshape(n, hp // w, wp // w, w, w, c).transpose(2, 3).reshape(n, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y[:, :h, :wd]
        hidden = F.gelu(self.dense(self.ln(x, f"{name}/norm2"), f"{name}/fc1"))
        return x + self.dense(hidden, f"{name}/fc2")

    def merge(self, x: torch.Tensor, name: str) -> torch.Tensor:
        n, h, w, c = x.shape
        y = torch.zeros(n, h + h % 2, w + w % 2, c, device=x.device)
        y[:, :h, :w] = x
        y = y.reshape(n, (h + 1) // 2, 2, (w + 1) // 2, 2, c).permute(0, 1, 3, 4, 2, 5).reshape(
            n, (h + 1) // 2, (w + 1) // 2, 4 * c)
        return (self._in(self.ln(y, f"{name}/norm")) @ self._in(self.v[f"params/{name}/reduction/kernel"])).float()

    def swin(self, x: torch.Tensor) -> list:
        """(N, 3, H, W) -> the out stages' NCHW maps."""
        s, t = self.spec, "camera_encoder/trunk"
        p = s.patch
        x = F.pad(x, (0, -x.shape[3] % p, 0, -x.shape[2] % p))
        k = self.v[f"params/{t}/patch_embed/kernel"].permute(3, 2, 0, 1)
        x = F.conv2d(self._in(x), self._in(k), stride=p).float() + self.v[f"params/{t}/patch_embed/bias"].float()[
            None, :, None, None]
        x = self.ln(x.permute(0, 2, 3, 1), f"{t}/patch_norm")
        outs = []
        for i, (depth, heads) in enumerate(zip(s.depths, s.heads)):
            for j in range(depth):
                x = self.block(x, f"{t}/stage{i}_block{j}", heads, s.window // 2 if j % 2 else 0)
            if i in s.out_indices:
                outs.append(self.ln(x, f"{t}/out_norm{i}").permute(0, 3, 1, 2))
            if i < len(s.depths) - 1:
                x = self.merge(x, f"{t}/stage{i}_merge")
        return outs

    def fpn(self, feats: list) -> torch.Tensor:
        x = feats[-1]
        for i in range(len(feats) - 2, -1, -1):
            up = F.interpolate(x, size=feats[i].shape[2:], mode="bilinear", align_corners=False)
            x = torch.cat([feats[i].float(), up], dim=1)
            x = F.relu(self.bn(self.conv(x, f"camera_encoder/neck/lateral{i}_conv"), f"camera_encoder/neck/lateral{i}_bn"))
            x = F.relu(self.bn(self.conv(x, f"camera_encoder/neck/fpn{i}_conv"), f"camera_encoder/neck/fpn{i}_bn"))
        return x

    def camera(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, N, H, W, 3) normalized -> (B, N, C, H/8, W/8)."""
        b, n = imgs.shape[:2]
        x = self.fpn(self.swin(imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)))
        return x.reshape((b, n) + x.shape[1:])

    def geometric(self, feats: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
        """feats (B, N, C, h, w), cells (N, D, h, w) -> (B, 80, 180, 180):
        the lift added into the camera grid one camera at a time, then the
        downsample."""
        s, g = self.spec, "fusion/geometric_camera_bev"
        b, n, c, h, w = feats.shape
        flat = feats.reshape(b * n, c, h, w)
        probs = torch.softmax(self.conv(flat, f"{g}/depth_head"), dim=1)  # (BN, D, h, w)
        feat = self.conv(flat, f"{g}/feat_proj")  # (BN, C', h, w)
        num_cells = s.cam_h * s.cam_w
        grid = torch.zeros(b, num_cells + 1, s.cam_c, device=feats.device)
        ids = cells.reshape(n, -1).long()
        ids = torch.where(ids < 0, num_cells, ids)
        for i in range(b * n):
            lifted = probs[i][:, None] * feat[i][None]  # (D, C', h, w)
            grid[i // n].index_add_(0, ids[i % n], lifted.permute(0, 2, 3, 1).reshape(-1, s.cam_c))
        x = grid[:, :num_cells].reshape(b, s.cam_h, s.cam_w, s.cam_c).permute(0, 3, 1, 2)
        for i, stride in ((1, 1), (2, 2), (3, 1)):
            x = F.relu(self.bn(self.conv(x, f"{g}/downsample{i}_conv", stride), f"{g}/downsample{i}_bn"))
        return x


def calibrate_statistics(spec: Spec, v: Dict[str, torch.Tensor], imgs, lidar, radar, cells) -> None:
    """`reference.model.calibrate_statistics` with this module's forward."""
    stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    with torch.no_grad(), ref.exact_float32():
        Forward(spec, v, train=True, stats=stats)(imgs, lidar, radar, cells)
    for name, (mean, var) in stats.items():
        v[f"batch_stats/{name}/mean"].copy_(mean)
        v[f"batch_stats/{name}/var"].copy_(var)
