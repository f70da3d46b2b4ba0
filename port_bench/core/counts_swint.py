"""The yardstick's arithmetic for `bevfusion_swint_lss`: its operations per
sample and kernel B2's bytes, from the configuration's shapes (a
`reference.swint_lss.Spec`), as `core.counts` counts the other
configurations: 2 x multiply-adds of convolutions, dense layers and
attention products; elementwise work, normalizations, softmax, rolls,
resizes and pooling left out.

Swin counts what the published block computes: its attention (qkv, q k^T,
the product with v, the output dense) on the map padded to whole windows,
its MLP on the real tokens, a patch merge on the map padded to even sides.
"""

from __future__ import annotations

from core.counts import b2_bytes as _b2_bytes
from core.counts import chain_flops, conv_flops


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def swin_block_flops(h: int, w: int, dim: int, window: int, mlp_ratio: float) -> float:
    """One (shifted-)window block on an h x w map of `dim` channels."""
    padded = _up(h, window) * _up(w, window)
    attention = 2.0 * padded * (3 * dim * dim + 2 * window * window * dim + dim * dim)
    return attention + 2.0 * h * w * 2 * dim * int(dim * mlp_ratio)


def swin_flops(spec) -> float:
    """The Swin trunk on one image: patch embedding, blocks, merges."""
    h, w = -(-spec.image_hw[0] // spec.patch), -(-spec.image_hw[1] // spec.patch)
    f = conv_flops(spec.image_hw[0], spec.image_hw[1], spec.patch, 3, spec.embed, spec.patch)
    for i, depth in enumerate(spec.depths):
        dim = spec.embed * 2 ** i
        f += depth * swin_block_flops(h, w, dim, spec.window, spec.mlp_ratio)
        if i < len(spec.depths) - 1:
            h, w = -(-h // 2), -(-w // 2)
            f += 2.0 * h * w * 4 * dim * 2 * dim
    return f


def neck_flops(spec) -> float:
    """The LSS-FPN on one image's out stages."""
    sizes = [(-(-spec.image_hw[0] // (spec.patch * 2 ** i)), -(-spec.image_hw[1] // (spec.patch * 2 ** i)))
             for i in spec.out_indices]
    widths = [spec.embed * 2 ** i for i in spec.out_indices]
    out, f = spec.cam_channels, 0.0
    for i in range(len(widths) - 1):
        above = widths[i + 1] if i == len(widths) - 2 else out
        f += conv_flops(*sizes[i], 1, widths[i] + above, out) + conv_flops(*sizes[i], 3, out, out)
    return f


def lift_flops(spec) -> float:
    """One sample's depth net, weighted splat (every frustum point) and
    downsample."""
    fh, fw = spec.feature_hw
    c, cams = spec.cam_c, spec.num_cameras
    f = cams * (conv_flops(fh, fw, 1, spec.cam_channels, spec.depth_bins) + conv_flops(fh, fw, 1, spec.cam_channels, c))
    f += 2.0 * cams * spec.depth_bins * fh * fw * c
    f += conv_flops(spec.cam_h, spec.cam_w, 3, c, c) + conv_flops(spec.cam_h, spec.cam_w, 3, c, c, 2)
    return f + conv_flops(spec.bev_h, spec.bev_w, 3, c, c)


def fusion_flops(spec) -> float:
    """LiDAR, radar, fusion and head of one sample, as `core.counts` counts
    them, the fusion's first conv at the camera's own width."""
    bh, bw, c = spec.bev_h, spec.bev_w, spec.bev_c
    f = chain_flops(1, spec.lidar_points, [spec.lidar_in] + spec.lidar_layers)
    hid, start = spec.lidar_hidden, spec.lidar_start
    f += 2.0 * (spec.lidar_layers[-1] * 512 + 512 * hid * start * start)
    f += conv_flops(start, start, 3, hid, hid) + conv_flops(2 * start, 2 * start, 3, hid, c)
    f += chain_flops(spec.num_radars, spec.radar_points, [spec.radar_in] + spec.radar_layers)
    f += 2.0 * (spec.num_radars * spec.radar_layers[-1] * spec.radar_feat + spec.radar_feat * c)
    f += 2 * conv_flops(bh, bw, 3, c, c)
    f += conv_flops(bh, bw, 3, spec.cam_c + 2 * c, 2 * c) + conv_flops(bh, bw, 3, 2 * c, c)
    for out in (spec.num_classes, 2, 3, 2, 2):
        f += conv_flops(bh, bw, 3, c, spec.head_conv) + conv_flops(bh, bw, 1, spec.head_conv, out)
    return f


def model_flops(spec) -> float:
    """Forward operations of one sample."""
    return spec.num_cameras * (swin_flops(spec) + neck_flops(spec)) + lift_flops(spec) + fusion_flops(spec)


def b2_bytes(spec, batch: int, feature_bytes: int) -> float:
    """Bytes of B2's launch in one batch: every camera row's pixels of the
    stride-8 map, depth bins and camera channels onto the camera grid."""
    fh, fw = spec.feature_hw
    return _b2_bytes(batch * spec.num_cameras, fh * fw, spec.depth_bins, spec.cam_c, spec.cam_h * spec.cam_w,
                     feature_bytes)
