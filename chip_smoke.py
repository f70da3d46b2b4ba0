#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

from the repository root, on a machine with one CUDA card, `nvcc` and
PyTorch built for CUDA. The kernels are built from
``bevfusion_multimodal_3d_object_detection_tpu_torch/csrc/`` into ``build/``.
Phases (any failure raises and the script exits non-zero):

1. build both kernel libraries with nvcc (sm_90a), one nvcc per source, in
   parallel;
2. hold B1 (fused PointNet) against its plain PyTorch version at the serving
   shapes: LiDAR 8x35000x4 -> ...1024 and radar 40x125x7 -> ...256, in
   f32 (TF32 off) and bf16, both mask_padding values, with BatchNorm
   statistics calibrated on the points and random non-zero biases, plus
   ragged N = 34,999, 34,945 (1 mod the 128-point bf16 tile), 100 and 125
   with every row a real point, and a 4->48->80->144 chain (partial weight
   slabs, an FMA first layer). The comparison is shown to reject the plain
   version with one bias dropped or with zero tiling rows in the max;
3. a small f32 forward + decode of the detector on the card against the
   same weights on the CPU (plain PyTorch path), with random non-zero
   biases and BatchNorm statistics, for the pseudo and the geometric
   (pallas splat, B2) camera-to-BEV;
4. the serving path: `InferenceServer` at the full width of
   configs/base.yaml (6x448x800 cameras, 35,000 LiDAR points, 5x125 radar
   points), batch 8, bf16, BN folded, seeded weights; 19 concurrent requests
   mixing uint8 and float cameras, including a partial batch. Launch
   counters are zeroed just before and read just after. Then the
   steady-state batch latency, samples/s and a per-module device-time
   breakdown;
5. B1 timings at the LiDAR and radar shapes (median, min and max of 3,
   TFLOP/s, share of the bound, and the device time alone from a CUDA
   graph) beside the plain version, a cuBLAS matmul/relu/amax chain as
   yardstick, and the bound;
6. B2 (weighted BEV pool) and B3 (sorted BEV pool) against their plain
   versions (TF32 off), per element, on plans of bench_kernels.py's
   6-camera ring calibration: B2 on 48 rows of 28x50 pixels, D = 40,
   C = 256, 50x50 cells, in f32 and bf16; B3 on 6 rows x 56,000 points; and
   both at 100x100 cells, where windows are empty and the cell count is not
   a multiple of the window. The comparison is shown to reject the plain
   version with every weight 1, with pads gathering a real row, with
   out-of-range points sent to cell 0, and with one chunk shifted a window;
7. the geometric eval path: base.yaml with camera_to_bev: geometric and
   splat_mode: pallas, `train.loop.make_eval_step` at full width, bf16,
   batch 8, seeded weights, uint8 cameras and ring-calibration chunk plans
   from `data.dataset.chunk_plans`, over 3 batches with the launch counters
   zeroed just before and read just after. Then ms per batch, samples/s,
   peak memory and a per-module device-time breakdown;
8. B2 and B3 timings beside the plain versions, a library yardstick
   (`lift_splat_matmul_rows`; one `index_add_`) and the bound.

Prints a `kernels` JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from bevfusion_multimodal_3d_object_detection_tpu_torch.config import (
    CompatFlags,
    DetectorSpec,
    LidarEncoderSpec,
    load_config,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import chunk_plans, collate_fn
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.encoders import PointNetLiDAREncoder
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import _build
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import bev_pool as bp
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import pointnet_fused as pf
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.bev_splat import (
    lift_splat_matmul_rows,
    precompute_frustum_cells,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.decode import (
    decode_centernet_predictions,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.preprocess import normalize_images
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import make_eval_step

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Per element, |kernel - plain| <= TOL * (|plain| + FLOOR * mean |plain|).
# f32 sums in another order. bf16 rounds every layer's output (one ulp is
# 2^-8..2^-7 of the value), and a rounding that flips in one layer carries
# through the next ones: 2^-5 is 4-8 ulps (on an H100 a few outputs in 10^4
# differ, by up to 4 ulps). Dropping any one folded bias, or letting tiling
# rows into the max, exceeds it by two orders of magnitude or more, and the
# check asserts that. FLOOR keeps outputs near 0 from asking for more than
# the magnitude of the rest allows.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -5}
FLOOR = 2.0 ** -4
PORT, JAX_PKG = "bevfusion_multimodal_3d_object_detection_tpu_torch", "bevfusion_multimodal_3d_object_detection_tpu"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "pointnet_fused": (f"{PORT}/csrc/pointnet_fused.cu", f"{JAX_PKG}/ops/pointnet_pallas.py:116"),
    "bev_pool_weighted": (f"{PORT}/csrc/bev_pool.cu", f"{JAX_PKG}/ops/bev_pool_pallas.py:166"),
    "bev_pool_sorted": (f"{PORT}/csrc/bev_pool.cu", f"{JAX_PKG}/ops/bev_pool_pallas.py:290"),
}
CHUNK_KEYS = ("point_idx", "local_ids", "block_idx")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Device time of `fn` alone: captured once in a CUDA graph and
    replayed, so the wrapper's host work (checks, allocation, the ctypes
    call) is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters)


def lidar_points(rng: np.random.RandomState, b: int, n: int) -> np.ndarray:
    """xyz inside the point-cloud range plus intensity, zero-padded after a
    per-sample count of real points; the last sample is all padding."""
    pts = np.zeros((b, n, 4), np.float32)
    for i in range(b - 1):
        k = rng.randint(n // 2, n + 1)
        pts[i, :k, :2] = rng.uniform(-51.2, 51.2, (k, 2))
        pts[i, :k, 2] = rng.uniform(-5.0, 3.0, k)
        pts[i, :k, 3] = rng.uniform(0.0, 1.0, k)
    return pts


def radar_points(rng: np.random.RandomState, b: int, n: int) -> np.ndarray:
    pts = rng.randn(b, n, 7).astype(np.float32)
    pts[:, n - 20:] = 0.0
    pts[-1] = 0.0
    return pts


def dense_points(rng: np.random.RandomState, b: int, n: int, c: int, spread: float) -> np.ndarray:
    """Every row a real point, in one tight cluster per sample far from the
    origin: an all-zero row the kernel added for its tiling would win the
    max in about half the columns, so the check sees it."""
    centre = rng.uniform(-spread, spread, (b, 1, c))
    return (centre + 0.01 * spread * rng.randn(b, n, c)).astype(np.float32)


def ring_camera_cells(image_size, bev_hw, depth_bins, depth_min, depth_max, pc_range) -> np.ndarray:
    """(6, D, H/16, W/16) frustum cells of bench_kernels.py's 6-camera ring
    calibration: yaw k * 60 deg, f = 1200, c = (800, 450) applied to the
    input image as it is, z-forward camera axes turned to x-forward."""
    h, w = image_size
    intr = np.array([[1200.0, 0, 800], [0, 1200.0, 450], [0, 0, 1]])
    base_rot = np.array([[0, 0, 1.0], [-1.0, 0, 0], [0, -1.0, 0]])
    depths = np.linspace(depth_min, depth_max, depth_bins)
    cells = []
    for k in range(6):
        yaw = k * np.pi / 3
        rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        cells.append(precompute_frustum_cells(
            intr, rz @ base_rot, np.zeros(3), (h // 16, w // 16), (h, w), depths, bev_hw, pc_range,
        ))
    return np.stack(cells)


def randomize_stats(model: torch.nn.Module, g: torch.Generator) -> torch.nn.Module:
    """Non-zero biases and BatchNorm statistics everywhere (the seeded init
    leaves biases at 0 and BatchNorm at identity): biases ~ N(0, 0.1), BN
    scale and var in [0.5, 1.5], BN shift and mean ~ N(0, 0.1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
    return model


def calibrate_point_mlp(mlp, points: np.ndarray, g: torch.Generator) -> None:
    """Linear biases ~ N(0, 0.1), BatchNorm running statistics measured on
    `points` (as training leaves them), BN scale in [0.5, 1.5] and shift
    ~ N(0, 0.5). Every layer's activations are then O(1), so each folded
    bias moves the output by many bf16 rounding steps."""
    bns = [m for m in mlp.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    with torch.no_grad():
        for m in mlp.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.normal_(0.0, 0.1, generator=g)
        for bn in bns:
            bn.reset_running_stats()
            bn.momentum = None  # running stats = this one batch's
        mlp.train()
        mlp(torch.from_numpy(points))
        mlp.eval()
        for bn in bns:
            bn.momentum = 0.1
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0.0, 0.5, generator=g)


def chain_args(encoder, points: np.ndarray, dtype, device):
    weights, biases = encoder.point_mlp.folded()
    return (
        torch.from_numpy(points).to(device, dtype),
        [w.to(device, dtype).contiguous() for w in weights],
        [b.to(device) for b in biases],
    )


def compare(got: torch.Tensor, want: torch.Tensor, dtype, scale=None) -> dict:
    """Per-element error of `got` against `want`, in units of the limit
    (`worst` <= 1 agrees), plus max abs error, max bf16 ulps and the share
    of elements that differ at all. The limit is relative to |want|, or to
    `scale` where given (for a sum: the sum of its terms' magnitudes)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    mag = want.abs()
    ref = mag if scale is None else scale.float()
    limit = TOL[dtype] * (ref + FLOOR * ref.mean())
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(mag, FLOOR * mag.mean()))) - 7)
    return {
        "worst": (err / limit.clamp_min(1e-30)).max().item(),
        "max_abs_err": err.max().item(),
        "max_ulps": (err / ulp).max().item(),
        "frac_diff": (err > 0).float().mean().item(),
    }


def fmt(s: dict) -> str:
    return (f"worst {s['worst']:.3g} of limit, max_abs_err {s['max_abs_err']:.3g}, "
            f"max {s['max_ulps']:.3g} bf16 ulps, {100 * s['frac_diff']:.3g}% differ")


def check_kernel(encoders, rng) -> float:
    """Phase 2: the kernel against its plain version at the serving shapes,
    with O(1) activations and non-zero folded biases, plus ragged LiDAR
    edges of the bf16 tile (N = 1 mod 128, N < 128) and a chain whose widths
    are multiples of 16 but not of the 128-column or 32-row weight slabs
    (4->48->80->144: partial slabs, an FMA first layer). The same comparison
    must reject the plain version with any one layer's bias dropped, and,
    where every row is real, with zero tiling rows let into the max.
    Returns the largest bf16 error (the serving dtype)."""
    worst = 0.0
    failures = []
    tile = _build.load("pointnet_fused", pf._declare).pointnet_fused_tile_points(1)
    cases = [
        ("lidar", lidar_points(rng, 8, 35000)),
        ("lidar-dense", dense_points(rng, 2, 34999, 4, 40.0)),
        ("lidar-dense", dense_points(rng, 2, 273 * tile + 1, 4, 40.0)),
        # 40 rows, as radar: at a few hundred GEMM rows cuBLAS sums the f32
        # plain version in another order than the kernel, and on this
        # cancelling cluster either order drifts past the f32 limit
        ("lidar-dense", dense_points(rng, 40, tile - 28, 4, 40.0)),
        ("radar", radar_points(rng, 40, 125)),
        ("radar-dense", dense_points(rng, 40, 125, 7, 2.0)),
        ("chain", lidar_points(rng, 3, 3 * tile + 44)),
        ("chain-dense", dense_points(rng, 2, 2 * tile + 1, 4, 40.0)),
    ]
    for name, pts in cases:
        enc = encoders[name.split("-")[0]]
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = chain_args(enc, pts, dtype, "cuda")
            for mask in (False, True):
                got = pf.pointnet_fused(x, w, b, mask)
                want = pf.pointnet_fused_reference(x, w, b, mask)
                s = compare(got, want, dtype)
                log(f"  B1 {name} {tuple(pts.shape)} {dtype} mask={mask}: {fmt(s)}")
                if s["worst"] > 1.0:
                    failures.append(f"B1 disagrees with its plain version: {name} {dtype} mask={mask}")
                if mask and not name.endswith("dense") and not torch.all(got[-1] == 0):
                    failures.append(f"B1 {name} {dtype}: an all-masked row must give 0")
                if dtype == torch.bfloat16:
                    worst = max(worst, s["max_abs_err"])
            # the comparison must bite: mutants of the plain version fail it
            want = pf.pointnet_fused_reference(x, w, b, False)
            mutants = {
                f"bias {i} dropped": pf.pointnet_fused_reference(
                    x, w, [torch.zeros_like(v) if j == i else v for j, v in enumerate(b)], False)
                for i in range(len(b))
            }
            if name.endswith("dense"):
                tiled = torch.cat([x, x.new_zeros(x.shape[0], -x.shape[1] % tile, x.shape[2])], dim=1)
                mutants["tiling rows in the max"] = pf.pointnet_fused_reference(tiled, w, b, False)
            for what, bad in mutants.items():
                s = compare(bad, want, dtype)
                log(f"    mutant {what}: {fmt(s)}")
                if s["worst"] <= 1.0:
                    failures.append(f"B1 check on {name} {dtype} does not reject: {what}")
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("; ".join(failures))
    return worst


def geometric_config(config) -> dict:
    """base.yaml with the geometric eval path's camera-to-BEV, overridden in
    memory as bench_kernels.py does."""
    cfg = copy.deepcopy(config)
    cfg["model"]["bev_fusion"].update(camera_to_bev="geometric", splat_mode="pallas")
    return cfg


def camera_plan_inputs(spec) -> dict:
    """One sample's ring-calibration frustum cells and chunk plans, under the
    keys the dataset gives them."""
    b = spec.bev
    cells = ring_camera_cells(spec.camera.image_size, (b.bev_h, b.bev_w), b.depth_bins,
                              b.depth_min, b.depth_max, b.pc_range)
    plans = chunk_plans(cells, b.bev_h * b.bev_w)
    return {"camera_cells": cells, **{f"camera_{k}": v for k, v in plans.items()}}


def camera_kwargs(batch: dict, device) -> dict:
    return {
        "camera_cells": torch.from_numpy(batch["camera_cells"]).to(device),
        "camera_chunks": tuple(torch.from_numpy(batch[f"camera_{k}"]).to(device) for k in CHUNK_KEYS),
    }


def check_small_model(config) -> None:
    """Phase 3: f32 forward + decode on the card == the CPU plain path, with
    pseudo and geometric (B2 on the card, its plain version on the CPU)
    camera-to-BEV."""
    for name, base in (("pseudo", config), ("geometric", geometric_config(config))):
        cfg = copy.deepcopy(base)
        cfg["model"]["camera_encoder"]["input_size"] = [64, 128]
        cfg["dataset"]["max_points"] = {"lidar": 1000, "radar_per_sensor": 125}
        spec = DetectorSpec.from_config(cfg)
        g = torch.Generator().manual_seed(1)
        cpu = randomize_stats(MultiModal3DDetector(spec).init_weights(g), g).eval()
        with torch.no_grad():  # O(1) head outputs, so the comparison bites
            for m in cpu.det_head.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
        gpu = copy.deepcopy(cpu).cuda()
        rng = np.random.RandomState(2)
        inputs = (
            rng.randn(2, 6, 64, 128, 3).astype(np.float32),
            lidar_points(rng, 2, 1000),
            np.stack([radar_points(rng, 5, 125)] * 2),
        )
        kw = {"cpu": {}, "cuda": {}}
        if name == "geometric":
            plans = camera_plan_inputs(spec)
            batch = {k: np.stack([v] * 2) for k, v in plans.items()}
            kw = {dev: camera_kwargs(batch, dev) for dev in kw}
        launches = bp.bev_pool_weighted_rows.launches
        with torch.no_grad():
            want = cpu(*(torch.from_numpy(a) for a in inputs), **kw["cpu"])
            got = gpu(*(torch.from_numpy(a).cuda() for a in inputs), **kw["cuda"])
            dec_w = decode_centernet_predictions(want, voxel_size=0.512)
            dec_g = decode_centernet_predictions(got, voxel_size=0.512)
        if name == "geometric" and bp.bev_pool_weighted_rows.launches == launches:
            raise AssertionError("the small geometric model did not launch B2")
        for k, v in want.items():
            err = (got[k].cpu() - v).abs().max().item()
            scale = max(1.0, v.abs().max().item())
            log(f"  small {name} model {k}: max_abs_err {err:.3g} (scale {scale:.3g})")
            if not err <= 1e-4 * scale:
                raise AssertionError(f"card and CPU disagree on {name} {k}")
        err = (dec_g["scores"].cpu() - dec_w["scores"]).abs().max().item()
        log(f"  small {name} model decoded scores: max_abs_err {err:.3g}")
        if not err <= 1e-4:
            raise AssertionError(f"decoded scores disagree ({name})")


def make_samples(spec, rng, n):
    h, w = spec.camera.image_size
    samples = []
    for i in range(n):
        u8 = rng.randint(0, 256, (6, h, w, 3), np.uint8)
        cams = u8 if i % 2 == 0 else ((u8 / 255.0 - 0.45) / 0.225).astype(np.float32)
        samples.append({
            "camera_imgs": cams,
            "lidar_points": lidar_points(rng, 2, spec.lidar.max_points)[0],
            "radar_points": radar_points(rng, spec.radar.num_radars, spec.radar.max_points_per_sensor),
        })
    return samples


def check_results(results, n) -> None:
    if len(results) != n:
        raise AssertionError(f"{len(results)} results for {n} requests")
    for r in results:
        if r["boxes"].shape != (100, 9) or r["scores"].shape != (100,) or r["labels"].shape != (100,):
            raise AssertionError(f"bad result shapes {r['boxes'].shape}")
        if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
            raise AssertionError("non-finite detections")


def module_breakdown(server, samples) -> dict:
    """Device ms of each module for one full bf16 batch already on the card."""
    model = server.model
    batch = (samples * server.batch_size)[: server.batch_size]
    dev = lambda k: torch.from_numpy(np.stack([s[k] for s in batch])).cuda()
    with torch.inference_mode():
        # uint8 wire, normalized on the card as the server does
        cams = normalize_images(dev("camera_imgs"), server.spec.camera.image_size).to(server.dtype)
        lidar, radar = dev("lidar_points").to(server.dtype), dev("radar_points").to(server.dtype)
        views = cams.permute(0, 1, 4, 2, 3)
        feats = {}
        parts = {
            "camera_encoder": lambda: feats.__setitem__("c", model.camera_encoder(views)),
            "lidar_encoder": lambda: feats.__setitem__("l", model.lidar_encoder(lidar)),
            "radar_encoder": lambda: feats.__setitem__("r", model.radar_encoder(radar)),
            "fusion": lambda: feats.__setitem__("f", model.fusion(feats["c"], feats["l"], feats["r"])),
            "det_head": lambda: feats.__setitem__("h", model.det_head(feats["f"])),
        }
        return {k: round(time_ms(fn, 10), 4) for k, fn in parts.items()}


def serve_main_path(config) -> dict:
    """Phase 4: the server at full width. Returns measurements."""
    torch.cuda.reset_peak_memory_stats()  # phase 2's f32 references are larger
    t0 = time.perf_counter()
    server = InferenceServer(config=config, batch_size=8, max_delay_ms=20.0,
                             score_threshold=0.0, use_bf16=True, fold_bn=True)
    t_init = time.perf_counter() - t0
    rng = np.random.RandomState(3)
    samples = make_samples(server.spec, rng, 4)
    server.start()  # warmup: both wires
    try:
        pf.pointnet_fused.launches = 0
        futures = [server.submit(samples[i % 4]) for i in range(16)]
        results = [f.result(timeout=300) for f in futures]
        futures = [server.submit(samples[i % 4]) for i in range(3)]  # a partial batch
        results += [f.result(timeout=300) for f in futures]
        launches = pf.pointnet_fused.launches
        stats = dict(server.stats)
        check_results(results, 19)
        if launches <= 0:
            raise AssertionError("the main path never launched the B1 kernel")
        log(f"  served 19 requests in {stats['batches']} batches ({stats['padded_rows']} padded rows); "
            f"B1 launches {launches}")

        latency = {}
        for wire, idx in (("uint8", 0), ("float32", 1)):
            batch = [samples[idx]] * server.batch_size
            times = []
            for _ in range(8):
                t = time.perf_counter()
                server._run_batch(batch)
                times.append((time.perf_counter() - t) * 1e3)
            latency[wire] = float(np.median(times))
        burst = 64
        t = time.perf_counter()
        futures = [server.submit(samples[2 * (i % 2)]) for i in range(burst)]
        check_results([f.result(timeout=300) for f in futures], burst)
        burst_s = time.perf_counter() - t
        breakdown = module_breakdown(server, [samples[0]])
    finally:
        server.stop()
    return {
        "init_s": t_init, "launches": launches, "batches": stats["batches"],
        "batch_latency_ms": latency,
        "samples_per_s_batch_uint8": server.batch_size / latency["uint8"] * 1e3,
        "samples_per_s_pipelined_uint8": burst / burst_s,
        "module_ms": breakdown,
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }


def time_kernel(encoder, points: np.ndarray) -> dict:
    """Phase 5: bf16 kernel (median, min and max of 3 timings of 20
    launches each through the wrapper; achieved TFLOP/s and share of the
    bound at the median; the device time alone, from a CUDA graph), plain
    version, cuBLAS chain, and the bound."""
    dtype = torch.bfloat16
    x, w, b = chain_args(encoder, points, dtype, "cuda")
    wb = [v.to(dtype) for v in b]

    def library():
        h = x
        for wi, bi in zip(w, wb):
            h = torch.relu(torch.matmul(h, wi) + bi)
        return h.amax(dim=1)

    batch, n, c_in = x.shape
    widths = [c_in] + [wi.shape[1] for wi in w]
    flops = pf.pointnet_flops(batch, n, widths)
    nbytes = (x.numel() * 2 + sum(wi.numel() * 2 for wi in w) + sum(bi.numel() * 4 for bi in b)
              + batch * widths[-1] * 2)
    bound = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3
    runs = sorted(time_ms(lambda: pf.pointnet_fused(x, w, b)) for _ in range(3))
    return {
        "ms": runs[1], "ms_min": runs[0], "ms_max": runs[2],
        "tflops": flops / runs[1] / 1e9, "bound_share": bound / runs[1],
        "device_ms": graph_ms(lambda: pf.pointnet_fused(x, w, b)),
        "plain_ms": time_ms(lambda: pf.pointnet_fused_reference(x, w, b)),
        "library_ms": time_ms(library),
        "bound_ms": bound,
        "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES else "bytes",
        "gflop": flops / 1e9,
    }


def device_plan(cells: np.ndarray, num_cells: int) -> list:
    plans = chunk_plans(cells, num_cells)
    return [torch.from_numpy(plans[k]).cuda() for k in CHUNK_KEYS]


def plan_mutants(cells: np.ndarray, plan: list, num_cells: int, n_points: int) -> dict:
    """Plans with which the plain version computes what a faulty pool would:
    pads counted (in cell 0 of their window, gathering the last real point),
    out-of-range frustum points sent to cell 0, one non-empty chunk of row 0
    moved to the next window."""
    pi, li, bi = plan
    pads = li < 0
    real = (li[0] >= 0).any(dim=1) & (bi[0] < bi[0].max())
    k = int(torch.nonzero(real)[0])
    shifted = bi.clone()
    shifted[0, k] += 1
    return {
        "pads gather a real row": [torch.where(pads, torch.full_like(pi, n_points - 1), pi),
                                   torch.where(pads, torch.zeros_like(li), li), bi],
        "out-of-range points in cell 0": device_plan(np.maximum(cells, 0), num_cells),
        "one chunk shifted a window": [pi, li, shifted],
    }


def has_empty_window(plan: list) -> bool:
    pi, li, bi = (a.cpu().numpy() for a in plan)
    return any(not (li[r][bi[r] == w] >= 0).any() for r in range(len(bi)) for w in np.unique(bi[r]))


def check_bev_pools(spec, g: torch.Generator) -> dict:
    """Phase 6: B2 and B3 against their plain versions on ring-calibration
    plans; the comparison must reject each plain-version mutant. Returns
    the largest error of each kernel.

    Kernel and plain version sum the same f32 products in another order, so
    each output's error is a few f32 ulps of the sum of its terms'
    magnitudes (the plain version on |features| and |weights|), not of the
    sum itself, which cancels to near 0 in some cells of random features:
    the limit is 1e-5 of that scale (TOL, FLOOR)."""
    b = spec.bev
    fh, fw = (s // 16 for s in spec.camera.image_size)
    hw, c, d = fh * fw, b.bev_channels, b.depth_bins
    worst = {"bev_pool_weighted": 0.0, "bev_pool_sorted": 0.0}
    failures = []

    def judge(kernel, label, got, want, scale, mutants):
        s = compare(got, want, torch.float32, scale)
        log(f"  {kernel} {label}: {fmt(s)}")
        worst[kernel] = max(worst[kernel], s["max_abs_err"])
        if s["worst"] > 1.0:
            failures.append(f"{kernel} disagrees with its plain version: {label}")
        for what, bad in mutants.items():
            s = compare(bad, want, torch.float32, scale)
            log(f"    mutant {what}: {fmt(s)}")
            if s["worst"] <= 1.0:
                failures.append(f"{kernel} check on {label} does not reject: {what}")

    for bev, rows in ((50, 48), (100, 6)):
        num_cells = bev * bev
        pad = bp.num_cells_padded(num_cells)
        cells = np.tile(ring_camera_cells(spec.camera.image_size, (bev, bev), d, b.depth_min,
                                          b.depth_max, b.pc_range), (rows // 6, 1, 1, 1))
        plan = device_plan(cells, num_cells)
        if bev == 100 and not (num_cells % bp.DEFAULT_WINDOW and has_empty_window(plan)):
            raise AssertionError("the 100x100 case must have an empty window and a ragged last one")
        n_points = d * hw
        logits = torch.randn(rows, d, hw, device="cuda", generator=g)
        weights = torch.softmax(logits, dim=1).reshape(rows, -1)
        feats = torch.randn(rows, hw, c, device="cuda", generator=g)
        mutant_plans = plan_mutants(cells, plan, num_cells, n_points)
        for dtype in (torch.float32, torch.bfloat16) if bev == 50 else (torch.float32,):
            f = feats.to(dtype)
            got = bp.bev_pool_weighted_rows(f, weights, *plan, num_cells, pad)
            ref = lambda w=weights, p=plan, x=f: bp.bev_pool_weighted_reference(x, w, *p, num_cells, pad)
            mutants = {"every weight 1": ref(w=torch.ones_like(weights))}
            mutants.update({k: ref(p=v) for k, v in mutant_plans.items()})
            if dtype == torch.bfloat16:
                mutants["weights not rounded to bf16"] = ref(x=f.float())
            judge("bev_pool_weighted", f"{rows}x{hw}x{c} {dtype} {bev}x{bev} cells", got, ref(),
                  ref(x=f.abs()), mutants)
        # B3 on the first 6 rows' plans, features per frustum point
        plan6, cells6 = [a[:6] for a in plan], cells[:6]
        pts = torch.randn(6, n_points, c, device="cuda", generator=g)
        got = bp.bev_pool_rows(pts, *plan6, num_cells, pad)
        ref = lambda p=plan6, x=pts: bp.bev_pool_sorted_reference(x, *p, num_cells, pad)
        mutants = {k: ref(v) for k, v in plan_mutants(cells6, plan6, num_cells, n_points).items()}
        judge("bev_pool_sorted", f"6x{n_points}x{c} f32 {bev}x{bev} cells", got, ref(),
              ref(x=pts.abs()), mutants)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("; ".join(failures))
    return worst


def geometric_breakdown(model, spec, compat, batch) -> tuple:
    """Device ms of each module for one full bf16 batch already on the card,
    and B2's inputs as GeometricCameraBEV makes them."""
    dev = lambda k: torch.from_numpy(batch[k]).cuda()
    with torch.inference_mode():
        cams = normalize_images(dev("camera_imgs"), spec.camera.image_size).to(torch.bfloat16)
        views = cams.permute(0, 1, 4, 2, 3)
        lidar, radar = dev("lidar_points").bfloat16(), dev("radar_points").bfloat16()
        kw = camera_kwargs(batch, "cuda")
        fusion, geo = model.fusion, model.fusion.geometric_camera_bev
        feats = {}
        parts = {
            "camera_encoder": lambda: feats.__setitem__("c", model.camera_encoder(views)),
            "geometric_camera_bev": lambda: geo(feats["c"], kw["camera_cells"], kw["camera_chunks"]),
            "lidar_encoder": lambda: feats.__setitem__("l", model.lidar_encoder(lidar)),
            "radar_encoder": lambda: feats.__setitem__("r", model.radar_encoder(radar)),
            "fusion": lambda: feats.__setitem__("f", fusion(feats["c"], feats["l"], feats["r"], **kw)),
            "det_head": lambda: feats.__setitem__("h", model.det_head(feats["f"])),
            "decode": lambda: decode_centernet_predictions(
                {k: v.permute(0, 2, 3, 1) for k, v in feats["h"].items()},
                max_detections=spec.centernet.max_detections, voxel_size=0.512,
                pc_range=spec.bev.pc_range, class_always_zero=compat.decode_class_always_zero),
        }
        ms = {k: time_ms(fn, 10) for k, fn in parts.items()}
        ms["fusion_without_camera"] = ms["fusion"] - ms["geometric_camera_bev"]
        b, n = feats["c"].shape[:2]
        flat = feats["c"].reshape((b * n,) + feats["c"].shape[2:])
        logits, feat = geo.depth_head(flat), geo.feat_proj(flat)
    chunks = [a.reshape((b * n,) + a.shape[2:]) for a in kw["camera_chunks"]]
    b2 = {"feat": feat, "logits": logits, "cells": kw["camera_cells"].reshape(b * n, -1),
          "chunks": chunks}
    return ms, b2


def geometric_eval_path(config) -> tuple:
    """Phase 7: make_eval_step on the geometric path at full width, bf16,
    batch 8, 3 batches. Returns measurements and B2's inputs."""
    cfg = geometric_config(config)
    spec, compat = DetectorSpec.from_config(cfg), CompatFlags.from_config(cfg)
    g = torch.Generator().manual_seed(4)
    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding)
    model = model.init_weights(g).to("cuda", torch.bfloat16)
    step = make_eval_step(model, compat, max_detections=spec.centernet.max_detections,
                          eval_path_decode=True)
    rng = np.random.RandomState(5)
    plans = camera_plan_inputs(spec)
    h, w = spec.camera.image_size
    batches = [collate_fn([{
        "camera_imgs": rng.randint(0, 256, (6, h, w, 3), np.uint8),
        "lidar_points": lidar_points(rng, 2, spec.lidar.max_points)[0],
        "radar_points": radar_points(rng, spec.radar.num_radars, spec.radar.max_points_per_sensor),
        **plans,
    } for _ in range(8)]) for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    step(batches[0])  # warm-up: cuDNN plans, the libraries
    torch.cuda.synchronize()

    counters = (pf.pointnet_fused, bp.bev_pool_weighted_rows, bp.bev_pool_rows)
    for k in counters:
        k.launches = 0
    outs, times = [], []
    for batch in batches:
        t = time.perf_counter()
        outs.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {k.__name__: k.launches for k in counters}
    if launches["bev_pool_weighted_rows"] < len(batches):
        raise AssertionError(f"B2 launched {launches['bev_pool_weighted_rows']} times in {len(batches)} batches")
    k = spec.centernet.max_detections
    for out in outs:
        if out["boxes"].shape != (8, k, 7) or out["scores"].shape != (8, k):
            raise AssertionError(f"bad eval-step shapes {tuple(out['boxes'].shape)}")
        if not all(torch.isfinite(out[n]).all() for n in ("boxes", "scores", "velocities")):
            raise AssertionError("non-finite eval-step output")
    ms = float(np.median(times))
    memory = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown, b2 = geometric_breakdown(model, spec, compat, batches[0])
    return {
        "launches": launches, "batch_ms": times, "batch_ms_p50": ms,
        "samples_per_s": 8 / ms * 1e3, "max_memory_gib": memory, "module_ms": breakdown,
    }, b2


def time_bev_pools(b2: dict, spec, g: torch.Generator) -> dict:
    """Phase 8: B2 at the phase 7 shape (bf16) and B3 at the phase 6 shape
    (f32): kernel, plain version, library yardstick and the bound, from the
    bytes and operations this run's plans need (plan entries read once,
    features and weights only where a real entry points, output once)."""
    num_cells = spec.bev.bev_h * spec.bev.bev_w
    pad = bp.num_cells_padded(num_cells)

    def bound(plan, n_weights_bytes, feat_bytes, out_bytes, flops):
        nbytes = sum(a.numel() * 4 for a in plan) + n_weights_bytes + feat_bytes + out_bytes
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.float32]
        return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_mb": nbytes / 1e6, "gflop": flops / 1e9}

    # B2: the model's own features and depth probabilities (bf16)
    feat, logits, cells, plan = b2["feat"], b2["logits"], b2["cells"], b2["chunks"]
    x, c = feat.shape[:2]
    with torch.inference_mode():
        rows = feat.permute(0, 2, 3, 1).reshape(x, -1, c).contiguous()
        probs = torch.softmax(logits, dim=1).reshape(x, -1)
        hw = rows.shape[1]
        real = plan[1] >= 0
        n_real = int(real.sum())
        n_pix = sum(int(torch.unique(plan[0][r][real[r]] % hw).numel()) for r in range(x))
        # the work per row and how unevenly cells and windows share it
        entry_cells = [(plan[2][r].long()[:, None] * bp.DEFAULT_WINDOW + plan[1][r])[real[r]] for r in range(x)]
        plan_stats = {
            "real_entries_per_row_max": max(int(e.numel()) for e in entry_cells),
            "busiest_window_entries": max(int(torch.bincount(e // bp.DEFAULT_WINDOW).max()) for e in entry_cells),
            "longest_cell_entries": max(int(torch.bincount(e).max()) for e in entry_cells),
        }
        out = {"bev_pool_weighted": {
            "ms": time_ms(lambda: bp.bev_pool_weighted_rows(rows, probs, *plan, num_cells, pad)),
            "plain_ms": time_ms(lambda: bp.bev_pool_weighted_reference(rows, probs, *plan, num_cells, pad), 5),
            "library_ms": time_ms(lambda: lift_splat_matmul_rows(feat, logits, cells, num_cells), 5),
            "shape": f"{x}x{hw}x{c} bf16 features, {x}x{probs.shape[1]} weights, "
                     f"{plan[0].shape[1]}x{plan[0].shape[2]} chunks per row, {num_cells} cells",
            "real_entries": n_real, **plan_stats,
            **bound(plan, n_real * 2, n_pix * c * 2, x * num_cells * c * 4, 2 * n_real * c),
        }}

        # B3: 6 rows of per-point f32 features on the first 6 rows' plans
        plan6 = [a[:6] for a in plan]
        n_points = probs.shape[1]
        pts = torch.randn(6, n_points, c, device="cuda", generator=g)
        cells6 = cells[:6].long()
        dest = (torch.where(cells6 < 0, torch.full_like(cells6, num_cells), cells6)
                + torch.arange(6, device="cuda")[:, None] * (num_cells + 1)).reshape(-1)
        src = pts.reshape(-1, c)
        real6 = int((plan6[1] >= 0).sum())
        out["bev_pool_sorted"] = {
            "ms": time_ms(lambda: bp.bev_pool_rows(pts, *plan6, num_cells, pad)),
            "plain_ms": time_ms(lambda: bp.bev_pool_sorted_reference(pts, *plan6, num_cells, pad), 5),
            "library_ms": time_ms(lambda: torch.zeros(6 * (num_cells + 1), c, device="cuda").index_add_(
                0, dest, src)),
            "shape": f"6x{n_points}x{c} f32, {num_cells} cells",
            **bound(plan6, 0, real6 * c * 4, 6 * num_cells * c * 4, real6 * c),
        }
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t = time.perf_counter()
    _build.build()
    log(f"  built {', '.join(_build.SOURCES.values())} in {time.perf_counter() - t:.1f} s")

    config = load_config("configs/base.yaml")
    spec = DetectorSpec.from_config(config)
    g = torch.Generator().manual_seed(0)
    full = MultiModal3DDetector(spec).init_weights(g).eval()
    # the chain's widths are multiples of 16 but not of B1's weight slabs
    chain = PointNetLiDAREncoder(LidarEncoderSpec(mlp_layers=(48, 80, 144))).eval()
    with torch.no_grad():
        for m in chain.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
    encoders = {"lidar": full.lidar_encoder, "radar": full.radar_encoder.shared_radar, "chain": chain}
    rng = np.random.RandomState(0)
    calibrate_point_mlp(encoders["lidar"].point_mlp, lidar_points(rng, 2, 4096), g)
    calibrate_point_mlp(encoders["radar"].point_mlp, radar_points(rng, 8, 125), g)
    calibrate_point_mlp(encoders["chain"].point_mlp, lidar_points(rng, 2, 4096), g)

    log("phase 2: B1 against its plain version (TF32 off)")
    max_err = check_kernel(encoders, rng)

    log("phase 3: small f32 model on the card against the CPU")
    check_small_model(config)

    log("phase 4: InferenceServer at full width (bf16, folded BN, batch 8)")
    torch.backends.cudnn.allow_tf32 = True  # serving runs in bf16 regardless
    serve = serve_main_path(config)
    log("  " + json.dumps({"serving": serve}))

    log("phase 5: B1 timings (bf16)")
    lidar_t = time_kernel(encoders["lidar"], lidar_points(rng, 8, spec.lidar.max_points))
    radar_t = time_kernel(encoders["radar"], radar_points(rng, 8 * spec.radar.num_radars,
                                                          spec.radar.max_points_per_sensor))
    log("  " + json.dumps({"lidar_8x35000": lidar_t, "radar_40x125": radar_t}))
    for what, t in (("LiDAR 8x35000x4", lidar_t), ("radar 40x125x7", radar_t)):
        log(f"  B1 {what} bf16: {t['ms']:.4f} ms median of 3 ({t['ms_min']:.4f}-{t['ms_max']:.4f}), "
            f"{t['tflops']:.1f} TFLOP/s, {100 * t['bound_share']:.1f}% of the bound "
            f"({t['bound_ms']:.4f} ms); device alone {t['device_ms']:.4f} ms; "
            f"cuBLAS chain {t['library_ms']:.4f} ms")

    log("phase 6: B2 and B3 against their plain versions (TF32 off)")
    torch.backends.cudnn.allow_tf32 = False
    g_cuda = torch.Generator(device="cuda").manual_seed(6)
    pool_err = check_bev_pools(spec, g_cuda)

    log("phase 7: geometric eval step at full width (bf16, batch 8, pallas splat)")
    torch.backends.cudnn.allow_tf32 = True  # the eval step runs in bf16 regardless
    geo, b2_inputs = geometric_eval_path(config)
    log("  " + json.dumps({"geometric_eval": geo}))

    log("phase 8: B2 and B3 timings")
    pools = time_bev_pools(b2_inputs, spec, g_cuda)
    log("  " + json.dumps(pools))

    def entry(name, launches, err, t):
        source, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": t["shape"]}

    lidar_t["shape"] = "lidar 8x35000x4 bf16"
    kernels = [
        dict(entry("pointnet_fused", serve["launches"], max_err, lidar_t),
             device_ms=lidar_t["device_ms"], radar_device_ms=radar_t["device_ms"],
             radar_ms=radar_t["ms"], radar_plain_ms=radar_t["plain_ms"],
             radar_bound_ms=radar_t["bound_ms"], radar_library_ms=radar_t["library_ms"],
             geometric_launches=geo["launches"]["pointnet_fused"]),
        # launches: phase 7, the geometric eval path
        entry("bev_pool_weighted", geo["launches"]["bev_pool_weighted_rows"],
              pool_err["bev_pool_weighted"], pools["bev_pool_weighted"]),
        # no model path calls B3 (as in the JAX package): its count stays 0
        entry("bev_pool_sorted", geo["launches"]["bev_pool_rows"],
              pool_err["bev_pool_sorted"], pools["bev_pool_sorted"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
