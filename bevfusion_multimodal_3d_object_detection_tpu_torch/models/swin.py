"""Swin Transformer trunk and BEVFusion's LSS-FPN neck, for the camera stream.

- `SwinTransformer` (Liu et al., arXiv 2103.14030, in the form of mmdet's
  ``SwinTransformer`` that BEVFusion's nuScenes camera configurations
  build): a patch_size x patch_size stride-patch_size convolution and a
  LayerNorm; stages of `SwinBlock` pairs, window attention then
  shifted-window attention, with `PatchMerging` after every stage but the
  last; a LayerNorm on each stage in ``out_indices``, taken before its
  merge. Tokens stay channel-last (N, H, W, C); the outputs are NCHW.
- `SwinBlock`: x + attention(LN(x)), then x + MLP(LN(x)) (GELU, ratio 4).
  The attention pads the map to whole windows with zeros after the first
  LayerNorm (the pads are keys like any token, as published), rolls it by
  half a window back in the shifted blocks, and masks with -100 the
  logits between regions that the roll brought together
  (`shift_window_mask`); every window's logits get the relative-position
  bias, a ((2w - 1)^2, heads) table read at each pair's offset. The
  window attention runs as `F.scaled_dot_product_attention` with bias and
  mask as one additive mask.
- `PatchMerging`: each 2 x 2 block's four tokens (pads at the bottom and
  right where a side is odd) concatenated in the published checkpoint's
  order, (0, 0), (1, 0), (0, 1), (1, 1), LayerNorm, a dense 4C -> 2C
  without bias.
- `LSSFPN` (BEVFusion's ``GeneralizedLSSFPN``): from the coarsest level
  down, the level above resized to this one (bilinear, half-pixel),
  concatenated after this level's map, then a 1x1 and a 3x3
  conv-BN-ReLU (convolutions without bias); returns the finest level.

Module names follow the repository's flax-style tree (``stage0_block1``,
``attn.qkv``, ``lateral0_conv``...), so `utils.convert.load_jax_variables`
loads them by name; the bias table is a parameter of its attention module,
loaded as it is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SwinSpec
from .resnet import batch_norm

LN_EPS = 1e-5  # torch's LayerNorm default, as mmdet's Swin builds it
MASK_VALUE = -100.0  # the published shifted-window mask's logit


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(N, Hp, Wp, C) -> (N, windows, window^2, C), windows row-major."""
    n, h, w, c = x.shape
    x = x.view(n, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (h // window) * (w // window), window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """The inverse of `window_partition`: -> (N, h, w, C)."""
    n, c = windows.shape[0], windows.shape[-1]
    x = windows.view(n, h // window, w // window, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, c)


def shift_window_mask(h: int, w: int, window: int, shift: int, device) -> torch.Tensor:
    """(windows, window^2, window^2) additive mask of a padded h x w map
    rolled back by `shift`: 0 between tokens of one region, -100 across."""
    region = torch.zeros(1, h, w, 1, device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    label = 0
    for hs in cuts:
        for ws in cuts:
            region[:, hs, ws] = label
            label += 1
    ids = window_partition(region, window)[0, :, :, 0]  # (windows, window^2)
    differ = ids[:, None, :] != ids[:, :, None]
    return torch.where(differ, MASK_VALUE, 0.0)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside each window, with the relative-
    position bias: (N, windows, window^2, C) -> the same."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        yy, xx = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
        dy = yy.reshape(-1)[:, None] - yy.reshape(-1)[None, :]
        dx = xx.reshape(-1)[:, None] - xx.reshape(-1)[None, :]
        index = (dy + window - 1) * (2 * window - 1) + (dx + window - 1)
        self.register_buffer("relative_position_index", index, persistent=False)

    def bias(self) -> torch.Tensor:
        """(heads, window^2, window^2) from the table."""
        n = self.window * self.window
        return self.relative_position_bias_table[self.relative_position_index.reshape(-1)].reshape(n, n, -1).permute(
            2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, nw, t, c = x.shape
        h, d = self.heads, c // self.heads
        q, k, v = self.qkv(x).reshape(n, nw, t, 3, h, d).permute(3, 0, 1, 4, 2, 5).unbind(0)  # (N, nW, h, T, d)
        add = self.bias().to(x.dtype)[None]  # (1, heads, T, T)
        if mask is not None:
            add = add + mask.to(x.dtype)[:, None]
        # windows and heads on one axis, so the additive mask broadcasts over the maps
        add = add.expand(nw, -1, -1, -1).reshape(1, nw * h, t, t)
        q, k, v = (a.reshape(n, nw * h, t, d) for a in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=add)
        out = out.reshape(n, nw, h, t, d).transpose(2, 3).reshape(n, nw, t, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """One (shifted-)window transformer block on (N, H, W, C)."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def attention_mask(self, h: int, w: int, device) -> Optional[torch.Tensor]:
        """The shifted block's mask on an h x w padded map (None unshifted),
        made once a shape and device (made anew while a compiler traces)."""
        if not self.shift:
            return None
        if torch.compiler.is_compiling():
            return shift_window_mask(h, w, self.window, self.shift, device)
        key = (h, w, str(device))
        if key not in self._masks:
            with torch.inference_mode(False), torch.no_grad():
                self._masks[key] = shift_window_mask(h, w, self.window, self.shift, device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        win, s = self.window, self.shift
        y = F.pad(self.norm1(x), (0, 0, 0, -w % win, 0, -h % win))
        hp, wp = y.shape[1:3]
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = self.attn(window_partition(y, win), self.attention_mask(hp, wp, y.device))
        y = window_reverse(y, win, hp, wp)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y[:, :h, :w]
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    """(N, H, W, C) -> (N, ceil(H/2), ceil(W/2), 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """(N, 3, H, W) -> [NCHW maps of the stages in `out_indices`]."""

    def __init__(self, spec: SwinSpec = SwinSpec()):
        super().__init__()
        if len(spec.depths) != len(spec.num_heads) or not spec.out_indices:
            raise ValueError(f"swin: depths {spec.depths} and num_heads {spec.num_heads} need one entry a stage")
        self.spec = spec
        c, win, p = spec.embed_dim, spec.window_size, spec.patch_size
        self.patch_embed = nn.Conv2d(3, c, p, p)
        self.patch_norm = nn.LayerNorm(c, eps=LN_EPS)
        self.out_channels: List[int] = []
        for i, (depth, heads) in enumerate(zip(spec.depths, spec.num_heads)):
            dim = c * 2 ** i
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", SwinBlock(dim, heads, win, win // 2 if j % 2 else 0,
                                                                spec.mlp_ratio))
            if i in spec.out_indices:
                self.add_module(f"out_norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
                self.out_channels.append(dim)
            if i < len(spec.depths) - 1:
                self.add_module(f"stage{i}_merge", PatchMerging(dim))
        self.stride = p * 2 ** spec.out_indices[0]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        s, p = self.spec, self.spec.patch_size
        x = F.pad(x, (0, -x.shape[3] % p, 0, -x.shape[2] % p))
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = []
        for i, depth in enumerate(s.depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i in s.out_indices:
                outs.append(getattr(self, f"out_norm{i}")(x).permute(0, 3, 1, 2).contiguous())
            if i < len(s.depths) - 1:
                x = getattr(self, f"stage{i}_merge")(x)
        return outs


class LSSFPN(nn.Module):
    """[NCHW levels, finest first] -> the finest level's (N, out, H, W)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.levels = len(in_channels)
        for i in range(self.levels - 1):
            above = in_channels[i + 1] if i == self.levels - 2 else out_channels
            self.add_module(f"lateral{i}_conv", nn.Conv2d(in_channels[i] + above, out_channels, 1, bias=False))
            self.add_module(f"lateral{i}_bn", batch_norm(out_channels))
            self.add_module(f"fpn{i}_conv", nn.Conv2d(out_channels, out_channels, 3, 1, 1, bias=False))
            self.add_module(f"fpn{i}_bn", batch_norm(out_channels))
        self.out_channels = out_channels

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = feats[-1]
        for i in range(self.levels - 2, -1, -1):
            up = F.interpolate(x, size=feats[i].shape[2:], mode="bilinear", align_corners=False)
            x = torch.cat([feats[i], up], dim=1)
            x = F.relu(getattr(self, f"lateral{i}_bn")(getattr(self, f"lateral{i}_conv")(x)))
            x = F.relu(getattr(self, f"fpn{i}_bn")(getattr(self, f"fpn{i}_conv")(x)))
        return x
