"""The yardstick's arithmetic: the model's operations per sample, a
kernel's operations or bytes per launch, and the chip's peaks.

Operations are 2 x multiply-adds of the convolutions, dense layers, the
PointNet chains and the lift-splat's weighted sum, counted from the
configuration's shapes; elementwise work, normalizations, pooling and
resizes are left out. Nothing here looks at what the program launches, so
a change to the program cannot move the yardstick.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), 700 W
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
CHUNK_POINTS = 256  # T of the chunk plans (the program's B2 reads them)
PLAN_WINDOW = 256  # W of the chunk plans


def conv_flops(h: int, w: int, k: int, cin: int, cout: int, stride: int = 1) -> float:
    """2 x MACs of a 'same'-padded k x k conv on an h x w input."""
    oh, ow = -(-h // stride), -(-w // stride)
    return 2.0 * oh * ow * k * k * cin * cout


def chain_flops(rows: int, points: int, widths: Sequence[int]) -> float:
    """2 x MACs of a per-point dense chain C_in -> ... -> C_out over rows x
    points: what kernel B1 computes in one launch."""
    return 2.0 * rows * points * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def trunk_flops(h: int, w: int) -> float:
    """ResNet-18 to layer3 on one h x w image."""
    f = conv_flops(h, w, 7, 3, 64, 2)
    h, w = -(-h // 2), -(-w // 2)
    h, w = -(-h // 2), -(-w // 2)  # max-pool
    cin = 64
    for ch, stride in ((64, 1), (128, 2), (256, 2)):
        for bi in range(2):
            st = stride if bi == 0 else 1
            f += conv_flops(h, w, 3, cin, ch, st)
            if st != 1 or cin != ch:
                f += conv_flops(h, w, 1, cin, ch, st)
            h, w = -(-h // st), -(-w // st)
            f += conv_flops(h, w, 3, ch, ch)
            cin = ch
    return f


def model_flops(spec) -> float:
    """Forward operations of one sample."""
    ih, iw = spec.image_hw
    fh, fw = ih // 16, iw // 16
    bh, bw, c = spec.bev_h, spec.bev_w, spec.bev_c
    cams = spec.num_cameras
    f = cams * (trunk_flops(ih, iw) + conv_flops(fh, fw, 1, 256, spec.cam_channels))
    if spec.camera_to_bev == "geometric":
        f += cams * (conv_flops(fh, fw, 1, spec.cam_channels, spec.depth_bins)
                     + conv_flops(fh, fw, 1, spec.cam_channels, c))
        f += 2.0 * cams * spec.depth_bins * fh * fw * c  # the splat's weighted sum
        f += conv_flops(bh, bw, 3, c, c)
    else:
        f += conv_flops(fh, fw, 3, spec.cam_channels, 512) + conv_flops(fh, fw, 1, 512, c)
    f += chain_flops(1, spec.lidar_points, [spec.lidar_in] + spec.lidar_layers)
    hid, start = spec.lidar_hidden, spec.lidar_start
    f += 2.0 * (spec.lidar_layers[-1] * 512 + 512 * hid * start * start)
    f += conv_flops(start, start, 3, hid, hid) + conv_flops(2 * start, 2 * start, 3, hid, c)
    f += chain_flops(spec.num_radars, spec.radar_points, [spec.radar_in] + spec.radar_layers)
    f += 2.0 * (spec.num_radars * spec.radar_layers[-1] * spec.radar_feat + spec.radar_feat * c)
    f += 2 * conv_flops(bh, bw, 3, c, c)
    f += conv_flops(bh, bw, 3, 3 * c, 2 * c) + conv_flops(bh, bw, 3, 2 * c, c)
    for out in (spec.num_classes, 2, 3, 2, 2):
        f += conv_flops(bh, bw, 3, c, spec.head_conv) + conv_flops(bh, bw, 1, spec.head_conv, out)
    return f


def b1_flops(spec, batch: int) -> dict:
    """Operations of B1's two launches in one batch: the LiDAR chain over
    batch rows and the radar chain over batch x radars rows."""
    return {
        "lidar": chain_flops(batch, spec.lidar_points, [spec.lidar_in] + spec.lidar_layers),
        "radar": chain_flops(batch * spec.num_radars, spec.radar_points, [spec.radar_in] + spec.radar_layers),
    }


def b2_bytes(rows: int, pixels: int, depth_bins: int, channels: int, num_cells: int,
             feature_bytes: int) -> float:
    """Bytes of one B2 launch, each read or written once: the pixel features
    (rows, pixels, C) and the depth weights (rows, D x pixels) in the working
    type, the chunk plan (point_idx and local_ids (rows, chunks, T) int32,
    block_idx (rows, chunks) int32) and the f32 output (rows, cells, C)."""
    points = depth_bins * pixels
    cells_pad = max(-(-num_cells // PLAN_WINDOW) * PLAN_WINDOW, PLAN_WINDOW)
    chunks = cells_pad // PLAN_WINDOW + -(-points // CHUNK_POINTS)
    plan = rows * chunks * (2 * CHUNK_POINTS + 1) * 4
    return float(rows * pixels * channels * feature_bytes + rows * points * feature_bytes + plan
                 + rows * num_cells * channels * 4)
