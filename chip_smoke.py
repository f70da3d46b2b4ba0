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
9. the train step, small, on the card against the CPU, for the pseudo and
   the geometric camera-to-BEV. Each of two steps starts from the same
   state (the CPU's before it) and is held to the CPU's float64 step at the
   CPU tests' fixed limits (losses 1e-5 relative, grad_norm 1e-5 in float64
   and 1e-4 in f32, AdamW first moments 1e-4 of each tensor's largest,
   parameters 1e-6 but
   near-zero-gradient elements 2 lr, BatchNorm statistics 1e-5), in float64
   and in f32 (TF32 off), cameras normalized in float64 on the host. For
   f32, the reference takes the card's side at every ReLU input and
   max-pool window that rounding puts on the other side of its kink, where
   the gradient has no single value (`TieSides`; each such tie must lie
   within 1e-5 of its tensor's largest). The f32 check is shown to reject a step whose
   loss reads bf16-rounded predictions;
10. train steps at full width: configs/base.yaml as it stands, batch 4,
   uint8 cameras, M = 500 box rows with a few dozen real boxes, seeded
   weights; f32 (TF32 off) and then with mixed_precision (bf16 autocast).
   2 warm-up and 5 timed steps on one batch: step ms (host clock up to a
   synchronize), samples/s, peak memory, the loss of every step, and the
   device ms of the step's parts (forward, targets and loss, backward,
   optimizer; CUDA events, 3 more steps). The losses
   must be finite and fall; the B1 and B2 launch counters must not move in
   phases 9 and 10 (training runs the plain point chain and the matmul
   splat, as the JAX package does);
11. the training entry point: a synthetic nuScenes tree in a temporary
   directory (8 train and 4 val samples from `write_synthetic_infos`, six
   1600x900 JPEGs and a 60,000-point LiDAR bin each, Q4 radar), then
   `train_detect.main` on configs/base.yaml at full width with only the
   data root, save and log directories, num_epochs 1 and save_interval 1
   overridden (batch 4, f32 as base.yaml trains, TF32 off); then again with
   num_epochs 2 and resume on. The resumed run must start at epoch 1 with
   parameters, BatchNorm statistics, AdamW moments and counts equal to the
   saved ones bit for bit; losses finite, the per-step log with the JAX
   keys, metrics_output.txt in the JAX report format, exactly
   checkpoint_epoch_1 and best_model after keep_last 1, and B1 launched 2
   times per validation batch and never in a train epoch (launch counter
   zeroed just before and read just after). best_model.msgpack served by
   `InferenceServer(model_path=..., use_bf16=False, fold_bn=False)` must
   agree with the Trainer's own f32 eval step at 1e-4 of the scores'
   scale. Prints epoch, loader, validation and checkpoint times and the
   peak device memory;
12. the inference, evaluation and serving entry points on phase 11's tree
   and best_model.msgpack, each with the B1 launch counter zeroed just
   before and read just after: the eval CLI (`eval.main`, Q10: the tree's
   configs/base.yaml, f32, TF32 off, batch 4) with metrics.use_official and
   metrics.save_submission, checked for the JAX report format of both
   reports, a schema-valid submission.json and 2 B1 launches per batch;
   `InferenceEngine` on the card against the CPU (plain B1) on one sample,
   prediction maps and decoded scores within 1e-4 of each output's scale,
   then its latency_s over 5 runs and B1's share of it (B1 alone at the
   engine's f32 shapes, and its bound); the inference CLI with --batch 4
   and then one sample with --no-show (matplotlib is not installed on the
   card's machine); `make_http_server` around `InferenceServer(model_path=)`
   (bf16, folded BN, batch 8): 16 concurrent npz requests through the
   port's `InferenceClient`, each equal to the in-process `server.infer` of
   the same sample (scores 1e-4, boxes 1e-3), /stats counting them, 413 on
   an oversized POST, p50 latency and requests/s; and the serve CLI in a
   subprocess, SIGTERM with a request in flight: both answered, exit 0;
13. the fusion and head variants (attention and late fusion with the MLP
   head, ``bev`` with the VoxelNet LiDAR encoder), each step with the B1
   launch counter zeroed just before and read just after: (a) small f32
   models on the card against the CPU (random non-zero biases and BatchNorm
   statistics, TF32 off), every output within 1e-4 of its scale, B1
   launched 2 times per attention or late forward and once per VoxelNet
   forward (radar only); the comparison must reject the attention with its
   heads split the other way and, on tokens of small spread, LayerNorm at
   torch's epsilon 1e-5; (b) a small train step of attention + MLP and late +
   MLP on the card against the CPU's float64 step at phase 9's limits, with
   every dropout at 0, and no B1 launch; (c) at full width (base.yaml with
   the fusion or LiDAR encoder switched), the eval step at batch 4 in f32
   (TF32 off: ms per batch, B1 launches) and train steps at batch 4 in f32
   and bf16 mixed precision as phase 10 times them (losses finite and lower
   at the last step); (d) the port's ablation CLI at full width, all 21
   variants PASS, its file in the JAX runner's format; (e) `InferenceEngine`
   with late fusion and the MLP head on one `SyntheticNuScenesDataset`
   sample, card against the CPU (cls/box within 1e-4 of their scale, the
   same label), and its latency_s; (f) B1's f32 path against the cuBLAS
   matmul/relu/amax chain (TF32 off) at 1x35000x4 and 4x35000x4.

Prints a `kernels` JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from bevfusion_multimodal_3d_object_detection_tpu_torch.config import (
    DEFAULT_CLASSES,
    CompatFlags,
    DetectorSpec,
    LidarEncoderSpec,
    TrainSpec,
    load_config,
    parse_modalities,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch import ablation
from bevfusion_multimodal_3d_object_detection_tpu_torch import eval as eval_cli
from bevfusion_multimodal_3d_object_detection_tpu_torch import inference as inference_cli
from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
from bevfusion_multimodal_3d_object_detection_tpu_torch.client import WIRE_KEYS, InferenceClient
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import native
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.converter import write_synthetic_infos
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import (
    DataLoader,
    NuScenesDataset,
    SyntheticNuScenesDataset,
    chunk_plans,
    collate_fn,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import fusion as port_fusion
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
    decode_to_host,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_images,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.inference_engine import InferenceEngine
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer, make_http_server
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as train_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import (
    Trainer,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    export_jax_variables,
    opt_state_to_jax,
)

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
    leaves biases at 0 and BatchNorm and LayerNorm at identity): biases
    ~ N(0, 0.1), BN and LayerNorm scale and BN var in [0.5, 1.5], BN and
    LayerNorm shift and BN mean ~ N(0, 0.1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear)) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(m, torch.nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
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
            bn.momentum = 1.0  # running stats = this one batch's
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


def time_kernel(encoder, points: np.ndarray, dtype=torch.bfloat16) -> dict:
    """Phase 5 (bf16) and 13f (f32): the kernel (median, min and max of 3
    timings of 20 launches each through the wrapper; achieved TFLOP/s and
    share of the bound at the median; the device time alone, from a CUDA
    graph), plain version, cuBLAS chain, and the bound."""
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
    size = torch.finfo(dtype).bits // 8
    nbytes = (x.numel() * size + sum(wi.numel() * size for wi in w) + sum(bi.numel() * 4 for bi in b)
              + batch * widths[-1] * size)
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


# ---------------------------------------------------------------------------
# Phases 9 and 10: the train step
# ---------------------------------------------------------------------------


def gt_rows(rng: np.random.RandomState, b: int, m: int, n_real: int, pc_range) -> tuple:
    """(b, m, 7) boxes and (b, m) labels: n_real boxes per sample inside the
    grid, the other rows zero with label -1 (7 columns, as the JAX loader
    collates them; velocity targets stay zero, Q12)."""
    boxes = np.zeros((b, m, 7), np.float32)
    labels = np.full((b, m), -1, np.int64)
    x0, y0, _, x1, y1, _ = pc_range
    for i in range(b):
        boxes[i, :n_real, 0] = rng.uniform(0.95 * x0, 0.95 * x1, n_real)
        boxes[i, :n_real, 1] = rng.uniform(0.95 * y0, 0.95 * y1, n_real)
        boxes[i, :n_real, 2] = rng.uniform(-2.0, 1.0, n_real)
        boxes[i, :n_real, 3:6] = rng.uniform(0.5, 5.0, (n_real, 3))
        boxes[i, :n_real, 6] = rng.uniform(-np.pi, np.pi, n_real)
        labels[i, :n_real] = rng.randint(0, 10, n_real)
    return boxes, labels


def train_batch(spec, rng: np.random.RandomState, b: int, m: int, n_real: int, extra=None) -> dict:
    h, w = spec.camera.image_size
    batch = collate_fn([{
        "camera_imgs": rng.randint(0, 256, (6, h, w, 3), np.uint8),
        "lidar_points": lidar_points(rng, 2, spec.lidar.max_points)[0],
        "radar_points": radar_points(rng, spec.radar.num_radars, spec.radar.max_points_per_sensor),
        **(extra or {}),
    } for _ in range(b)])
    batch["gt_boxes"], batch["gt_labels"] = gt_rows(rng, b, m, n_real, spec.bev.pc_range)
    return batch


def small_train_config(config) -> dict:
    cfg = copy.deepcopy(config)
    model = cfg["model"]
    model["camera_encoder"]["input_size"] = [64, 128]
    cfg["dataset"]["max_points"] = {"lidar": 1000, "radar_per_sensor": 125}
    model["lidar_encoder"]["mlp_layers"] = [64, 128, 256]
    model["radar_encoder"].update(mlp_layers=[32, 64, 128], feature_dim=128)
    model["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=64)
    model["centernet_head"].update(in_channels=64, head_conv=32)
    return cfg


class TrainRun:
    """A model of `dtype` on `device` from a state_dict (and, optionally, an
    AdamW state after one update), with its optimizer and train step."""

    def __init__(self, spec, compat, train_spec, state, device, dtype, adamw_state=None, dropout=True):
        self.model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding).to(dtype)
        self.model.load_state_dict(state)
        if not dropout:  # also late fusion's fixed Dropout(0.1), which no config key sets
            for m in self.model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
        self.opt = make_optimizer(train_spec, compat)
        self.step = make_train_step(self.model, self.opt, train_spec, compat, check_gradients=True,
                                    device=device)
        if adamw_state is not None:  # a copy: AdamW updates its moments in place
            self.opt.adamw.load_state_dict(copy.deepcopy(adamw_state))
            self.opt.updates = 1

    def __call__(self, batch) -> dict:
        losses = {k: float(v) for k, v in self.step(batch).items()}
        copy64 = lambda t: t.detach().to("cpu", torch.float64, copy=True)
        state = {k: copy64(v) for k, v in self.model.state_dict().items()}
        mu = {n: copy64(self.opt.adamw.state[p]["exp_avg"]) for n, p in self.model.named_parameters()}
        return {"losses": losses, "state": state, "mu": mu,
                "adamw": copy.deepcopy(self.opt.adamw.state_dict())}


def step_errors(got: dict, want: dict, prev_mu, lr: float, what: str, grad_norm_rtol: float = 1e-5) -> tuple:
    """One step against the same step on the CPU (float64, the same state
    before it), at the CPU tests' limits (grad_norm at `grad_norm_rtol`:
    1e-4 in f32, the first moments' limit). Returns the worst ratio to each
    limit and the failures."""
    worst = {"losses": 0.0, "first_moments": 0.0, "params": 0.0, "bn_stats": 0.0}
    where = {}
    failures = []

    def note(kind, ratio, name):
        if ratio > worst[kind]:
            worst[kind], where[kind] = ratio, name

    for k in [k for k in want["losses"] if k != "grads_finite"]:  # CenterNet or MLP-head terms
        rtol = grad_norm_rtol if k == "grad_norm" else 1e-5
        note("losses", abs(got["losses"][k] - want["losses"][k]) / (rtol * abs(want["losses"][k])), k)
    largest = max(float(v.abs().max()) for v in want["mu"].values())
    for name, m in got["mu"].items():
        ref = want["mu"][name]
        top = float(ref.abs().max())
        if top < 1e-9 * largest:  # a bias right before a BatchNorm: zero gradient
            if float(m.abs().max()) > 1e-5 * largest:
                failures.append(f"{what} {name}: a zero-gradient first moment is not ~0")
            small = torch.ones_like(m, dtype=torch.bool)
        else:
            note("first_moments", float((m - ref).abs().max()) / (1e-4 * top), name)
            g = (ref - (0 if prev_mu is None else 0.9 * prev_mu[name])).abs()
            small = g < 1e-3 * g.max()
        diff = (got["state"][name] - want["state"][name]).abs()
        if bool(small.any()) and float(diff[small].max()) > 2 * lr:
            failures.append(f"{what} {name}: a near-zero-gradient element moved more than 2 lr")
        if bool((~small).any()):
            note("params", float(diff[~small].max()) / 1e-6, name)
    for name, v in want["state"].items():
        if name.endswith("running_var") or name.endswith("running_mean"):
            scale = v.abs() if name.endswith("running_var") else v.abs().max()
            note("bn_stats", float(((got["state"][name] - v).abs() / (1e-5 * scale)).max()), name)
    failures += [f"{what} {k} at {v:.3g} of the limit ({where.get(k)})" for k, v in worst.items() if not v <= 1.0]
    return worst, failures


def compare_step(got: dict, want: dict, prev_mu, lr: float, what: str, grad_norm_rtol: float = 1e-5) -> dict:
    """`step_errors`, raising on any failure; returns the worst ratios."""
    worst, failures = step_errors(got, want, prev_mu, lr, what, grad_norm_rtol)
    if failures:
        raise AssertionError("; ".join(failures))
    return worst


class TieSides:
    """Which side of each kink a run took, in call order: for every `F.relu`
    call, where its input is positive; for every `F.max_pool2d` call, which
    input each window took. Recorded from one run (`record`) and imposed on
    another (`replay`). The gradient at a kink has no single value, and f32
    rounding can put a ReLU input within ~1e-6 of 0, or two inputs of a
    window within ~1e-7 of each other, on either side; one such tie in a
    small layer moves a whole branch's gradient (tests/torch_train_helpers.py).
    Replaying an f32 run's sides into the float64 reference compares the two
    on the same side. `flips` counts the ties replayed across, `flip_share`
    is the largest distance among them (from 0, or between the window's max
    and the input taken) over its tensor's largest |input|."""

    def __init__(self):
        self.sides, self.flips, self.flip_share = [], 0, 0.0

    @contextlib.contextmanager
    def _patched(self, relu, max_pool2d):
        plain = F.relu, F.max_pool2d
        F.relu, F.max_pool2d = relu, max_pool2d
        try:
            yield self
        finally:
            F.relu, F.max_pool2d = plain

    def _flipped(self, flip: torch.Tensor, gap: torch.Tensor, x: torch.Tensor) -> None:
        if bool(flip.any()):
            self.flips += int(flip.sum())
            self.flip_share = max(self.flip_share, float(gap[flip].abs().max() / x.detach().abs().max()))

    def record(self):
        relu, max_pool2d = F.relu, F.max_pool2d

        def record_relu(x, inplace=False):
            self.sides.append((x > 0).cpu())
            return relu(x, inplace)

        def record_pool(x, *args, **kwargs):
            out, idx = max_pool2d(x, *args, **dict(kwargs, return_indices=True))
            self.sides.append(idx.cpu())
            return out

        return self._patched(record_relu, record_pool)

    @contextlib.contextmanager
    def replay(self):
        sides = iter(self.sides)
        relu, max_pool2d = F.relu, F.max_pool2d

        def side(shape, device):
            taken = next(sides).to(device)
            if taken.shape != shape:
                raise AssertionError(f"kinks out of step: {tuple(taken.shape)} vs {tuple(shape)}")
            return taken

        def replay_relu(x, inplace=False):
            keep = side(x.shape, x.device)
            self._flipped(keep != (x > 0), x.detach(), x)
            return torch.where(keep, x, torch.zeros_like(x))

        def replay_pool(x, *args, **kwargs):
            own, own_idx = max_pool2d(x, *args, **dict(kwargs, return_indices=True))
            idx = side(own_idx.shape, x.device)
            out = x.flatten(2).gather(2, idx.flatten(2)).view_as(own)
            self._flipped(idx != own_idx, (own - out).detach(), x)
            return out

        with self._patched(replay_relu, replay_pool):
            yield self
        if next(sides, None) is not None:
            raise AssertionError("the replayed run passed fewer kinks than the recorded one")


def check_small_train(config) -> dict:
    """Phase 9. Returns the worst ratio to each limit, per camera-to-BEV and
    dtype, the ReLU inputs replayed across 0 and the rejected mutant's worst
    ratio."""
    out = {}
    counters = (pf.pointnet_fused, bp.bev_pool_weighted_rows)
    launches = [k.launches for k in counters]
    for name, base in (("pseudo", config), ("geometric", geometric_config(config))):
        cfg = small_train_config(base)
        spec, compat, ts = DetectorSpec.from_config(cfg), CompatFlags.from_config(cfg), TrainSpec.from_config(cfg)
        lr = ts.learning_rate
        g = torch.Generator().manual_seed(7)
        model = randomize_stats(MultiModal3DDetector(spec).init_weights(g), g)
        with torch.no_grad():  # O(1) head outputs
            for m in model.det_head.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
        state0 = model.state_dict()
        rng = np.random.RandomState(8)
        plans = camera_plan_inputs(spec) if name == "geometric" else None
        batches = [train_batch(spec, rng, 2, 16, 5, plans) for _ in range(2)]
        # cameras normalized in float64 on the host: the uint8 wire normalized
        # in f32 on each device differs by an ulp here and there
        batches = [dict(b, camera_imgs=(b["camera_imgs"] / 255.0 - IMAGENET_MEAN.astype(np.float64))
                        / IMAGENET_STD.astype(np.float64)) for b in batches]
        cpu_steps = []
        for b in batches:
            start = cpu_steps[-1] if cpu_steps else {"state": state0, "adamw": None}
            cpu_steps.append(TrainRun(spec, compat, ts, start["state"], "cpu", torch.float64, start["adamw"])(b))

        def starts(i):
            return (state0, None, None) if i == 0 else (cpu_steps[0]["state"], cpu_steps[0]["adamw"],
                                                        cpu_steps[0]["mu"])

        # float64 on the card, each step from the CPU's state before it
        worst = {}
        for i, b in enumerate(batches):
            state, adamw, prev_mu = starts(i)
            got = TrainRun(spec, compat, ts, state, "cuda", torch.float64, adamw)(b)
            w = compare_step(got, cpu_steps[i], prev_mu, lr, f"{name} float64 step {i + 1}")
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in w.items()}

        # f32 on the card, each step from the CPU's state before it, against
        # the CPU's float64 step on the card's side of every tie
        f32_worst, ties = {}, []
        for i, b in enumerate(batches):
            state, adamw, prev_mu = starts(i)
            ties.append(TieSides())
            with ties[i].record():
                got = TrainRun(spec, compat, ts, state, "cuda", torch.float32, adamw)(b)
            with ties[i].replay():
                want = TrainRun(spec, compat, ts, state, "cpu", torch.float64, adamw)(b)
            if i == 0:
                want1 = want
            w = compare_step(got, want, prev_mu, lr, f"{name} f32 step {i + 1}", 1e-4)
            f32_worst = {k: max(v, f32_worst.get(k, 0.0)) for k, v in w.items()}
        share = max(t.flip_share for t in ties)
        if not share <= 1e-5:
            raise AssertionError(f"{name}: the f32 step took the other side of a kink {share:.3g} of its "
                                 "tensor's largest away")

        # a wrong f32 step: the loss reads bf16-rounded predictions (the
        # forward, and so the sides of its ties, are step 1's)
        mutant = TrainRun(spec, compat, ts, state0, "cuda", torch.float32)
        loss = mutant.step.loss
        mutant.step.loss = lambda preds, batch: loss({k: v.bfloat16() for k, v in preds.items()}, batch)
        got = mutant(batches[0])
        # the lambda refers back to the step: without this the cycle would
        # keep the model and its AdamW state on the card into phase 10
        del mutant.step.loss
        mutant_worst, failures = step_errors(got, want1, None, lr, f"{name} bf16-loss mutant", 1e-4)
        if not failures:
            raise AssertionError(f"{name}: the f32 check passed a step whose loss read bf16 predictions")
        out[name] = {"float64": worst, "f32": f32_worst, "f32_ties_across": sum(t.flips for t in ties),
                     "f32_tie_share": share, "bf16_loss_mutant": mutant_worst}
        log(f"  small train {name}: worst share of each limit " + json.dumps(out[name]))
    if [k.launches for k in counters] != launches:
        raise AssertionError("a train step launched B1 or B2")
    return out


def train_breakdown(step, batch, reps: int = 3) -> dict:
    """Device ms of each part of one train step (CUDA events between the
    parts of `TrainStep.__call__`, median of `reps`): the forward with the
    batch's copy to the card and the uint8 normalize, the targets and loss,
    the backward, and the optimizer update (clip + AdamW). Runs `reps` more
    steps."""
    names = ("forward", "targets_and_loss", "backward", "optimizer")
    ms = {k: [] for k in names}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        preds = step.forward(batch)
        ev[1].record()
        losses = step.loss(preds, batch)
        ev[2].record()
        grads = step.gradients(losses["total_loss"])
        ev[3].record()
        step.update(losses, grads)
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            ms[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v)) for k, v in ms.items()}


def train_full_width(config, label: str = "") -> dict:
    """Phase 10 (and 13c for the variants): make_train_step on base.yaml at
    full width, batch 4, in f32 and with mixed_precision (bf16 autocast)."""
    spec, compat = DetectorSpec.from_config(config), CompatFlags.from_config(config)
    ts = TrainSpec.from_config(config)
    rng = np.random.RandomState(9)
    batch = train_batch(spec, rng, ts.batch_size, ts.max_objects, 40)
    out = {}
    for name, mixed in (("f32", False), ("bf16_mixed_precision", True)):
        g = torch.Generator().manual_seed(10)
        model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding).init_weights(g)
        run_spec = dataclasses.replace(ts, mixed_precision=mixed)
        opt = make_optimizer(run_spec, compat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(model, opt, run_spec, compat)
        counters = (pf.pointnet_fused, bp.bev_pool_weighted_rows)
        for k in counters:
            k.launches = 0
        losses, times = [], []
        for i in range(7):
            t = time.perf_counter()
            loss = step(batch)["total_loss"]
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
        launches = {k.__name__: k.launches for k in counters}
        if any(launches.values()):
            raise AssertionError(f"the train step launched kernels of the inference path: {launches}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{name} train losses are not finite and falling: {losses}")
        if not all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in model.parameters()):
            raise AssertionError(f"{name}: parameters left f32 or went non-finite")
        ms = float(np.median(times))
        parts = train_breakdown(step, batch)
        out[name] = {
            "batch": ts.batch_size, "step_ms": times, "step_ms_p50": ms, "part_ms": parts,
            "samples_per_s": ts.batch_size / ms * 1e3,
            "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "losses": losses, "launches": launches,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
        }
        log(f"  train {label}{name}: {ms:.2f} ms per step of {ts.batch_size} (p50 of 5), "
            f"{out[name]['samples_per_s']:.1f} samples/s, {out[name]['max_memory_gib']:.2f} GiB peak, "
            f"loss {losses[0]:.4g} -> {losses[-1]:.4g}; device ms "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f" [{card()}]")
        del model, opt, step
    return out


# the keys of a JAX per-step log line (train/loop.py:_epoch_inner of the JAX
# package: step, step_seconds and its CenterNet loss dict)
JAX_LOG_KEYS = {"step", "step_seconds", "total_loss", "heatmap_loss", "offset_loss", "size_loss",
                "rot_loss", "vel_loss"}
REPORT_CLASSES = ("car", "truck", "bus", "trailer", "construction_vehicle", "pedestrian", "motorcycle",
                  "bicycle", "traffic_cone", "barrier")  # Q9's report order


def write_nuscenes_tree(root: Path, config: dict, train: int, val: int, n_points: int) -> dict:
    """Synthetic nuScenes infos (`write_synthetic_infos`) with their sensor
    files: six RGB JPEGs per sample at the native 1600x900, smooth noise
    (a 90x160 seeded image upsampled, as camera frames are smooth), and a
    LiDAR .bin of `n_points` five-float points inside point_cloud_range
    [x, y, z, intensity in [0, 1), ring in [0, 2.9)]. Radar stays quirk Q4's
    random points (no files)."""
    from PIL import Image

    t = time.perf_counter()
    write_synthetic_infos(str(root), splits=("train", "val"), samples_per_split=max(train, val), seed=11)
    rng = np.random.RandomState(11)
    x0, y0, z0, x1, y1, z1 = config["dataset"]["point_cloud_range"]
    n_files, n_bytes = 0, 0
    for split, n in (("train", train), ("val", val)):
        path = root / f"nuscenes_infos_{split}.pkl"
        data = pickle.loads(path.read_bytes())
        data["infos"] = data["infos"][:n]
        path.write_bytes(pickle.dumps(data))
        for info in data["infos"]:
            pts = np.empty((n_points, 5), np.float32)
            pts[:, 0] = rng.uniform(x0 + 0.1, x1 - 0.1, n_points)
            pts[:, 1] = rng.uniform(y0 + 0.1, y1 - 0.1, n_points)
            pts[:, 2] = rng.uniform(z0 + 0.1, z1 - 0.1, n_points)
            pts[:, 3] = rng.uniform(0.0, 1.0, n_points)
            pts[:, 4] = rng.uniform(0.0, 2.9, n_points)
            pts.tofile(info["lidar_path"])
            for cam in info["cams"].values():
                small = Image.fromarray(rng.randint(0, 256, (90, 160, 3), np.uint8))
                img_path = root / cam["filename"]
                small.resize((1600, 900), Image.BILINEAR).save(img_path, quality=90)
                n_files += 1
                n_bytes += img_path.stat().st_size
    return {"jpegs": n_files, "jpeg_mb": n_bytes / 2 ** 20, "lidar_points": n_points,
            "write_s": time.perf_counter() - t}


@contextlib.contextmanager
def traced_trainer(record: dict):
    """Wrap the Trainer's epoch, validation and checkpoint methods for the
    duration: host seconds up to a synchronize, B1 launches inside each
    call, checkpoint sizes, and a snapshot of the state just after each
    restore."""
    names = ("train_one_epoch", "evaluate", "save_checkpoint", "load_checkpoint")
    orig = {n: getattr(Trainer, n) for n in names}

    def wrap(name):
        def inner(self, *args, **kwargs):
            b1 = pf.pointnet_fused.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[name](self, *args, **kwargs)
            torch.cuda.synchronize()
            entry = {"s": time.perf_counter() - t, "b1_launches": pf.pointnet_fused.launches - b1}
            if name.endswith("checkpoint"):
                entry["bytes"] = Path(args[0]).stat().st_size
            if name == "load_checkpoint":
                entry["state"] = trainer_state(self)
                entry["epoch"] = out
            record.setdefault(name, []).append(entry)
            return out
        return inner

    for n in names:
        setattr(Trainer, n, wrap(n))
    try:
        yield record
    finally:
        for n, fn in orig.items():
            setattr(Trainer, n, fn)


def trainer_state(trainer) -> dict:
    """Parameters, BatchNorm statistics, optimizer state (AdamW moments and
    counts, in the checkpoint's JAX layout) and the step count, on the host."""
    return {"variables": export_jax_variables(trainer.model),
            "opt_state": opt_state_to_jax(trainer.optimizer, trainer.model),
            "step": trainer.step, "updates": trainer.optimizer.updates}


def tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        if not tree:
            yield prefix, None
        for k, v in tree.items():
            yield from tree_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def assert_states_equal(got: dict, want: dict) -> int:
    """Bit for bit, with the same keys; returns the number of arrays."""
    if (got["step"], got["updates"]) != (want["step"], want["updates"]):
        raise AssertionError(f"restored counts {got['step'], got['updates']} != saved {want['step'], want['updates']}")
    n = 0
    for part in ("variables", "opt_state"):
        g, w = dict(tree_leaves(got[part])), dict(tree_leaves(want[part]))
        if set(g) != set(w):
            raise AssertionError(f"restored {part} keys differ: {sorted(set(g) ^ set(w))[:5]}")
        for k, a in w.items():
            b = g[k]
            if a is None and b is None:
                continue
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"restored {part}/{'/'.join(k)} differs from the saved value")
            n += 1
    return n


def check_report(path: Path, classes=REPORT_CLASSES) -> dict:
    """A metrics report in the JAX package's format
    (utils/metrics.py:save_and_print_metrics), classes in `classes`' order."""
    lines = path.read_text().splitlines()
    want = ["===== Evaluation Metrics =====", r"mAP : \d\.\d{4}", r"NDS : \d\.\d{4}", "", "--- AP Per Class ---",
            *(re.escape(f"{c:20s}") + r": \d\.\d{4}" for c in classes)]
    if len(lines) != len(want) or not all(re.fullmatch(w, ln) for w, ln in zip(want, lines)):
        raise AssertionError(f"{path} is not the JAX report format:\n" + "\n".join(lines))
    return {"mAP": float(lines[1].split(":")[1]), "NDS": float(lines[2].split(":")[1])}


def training_entry_point(config, tmp: Path) -> tuple:
    """Phase 11: `train_detect.main` on a synthetic nuScenes tree at full
    width on the card (one epoch; then a resume into a second), keep_last,
    the metrics report, and `best_model.msgpack` served by
    `InferenceServer(model_path=)` against the Trainer's own f32 eval step.
    The tree and the checkpoints stay in `tmp` for phase 12; returns the
    measurements and the config that points at them."""
    out = {}
    cwd = os.getcwd()
    data = tmp / "nuscenes"
    # Q5 (base.yaml) parses the 5-float records as 4 floats: 60,000
    # points put ~47,000 misparsed records in range (40,000 would give
    # ~31,000), so the native subsample to 35,000 runs either way
    out["data"] = write_nuscenes_tree(data, config, train=8, val=4, n_points=60_000)
    log(f"  wrote {out['data']['jpegs']} JPEGs ({out['data']['jpeg_mb']:.1f} MB) and 12 LiDAR bins "
        f"in {out['data']['write_s']:.1f} s")
    cfg = copy.deepcopy(config)
    cfg["dataset"]["data_root"] = str(data)
    cfg["train"]["checkpoint"].update(save_dir=str(tmp / "checkpoints"), save_interval=1)
    cfg["train"]["logging"]["log_dir"] = str(tmp / "logs")
    cfg["train"]["num_epochs"] = 1
    ts, compat = TrainSpec.from_config(cfg), CompatFlags.from_config(cfg)
    spec = DetectorSpec.from_config(cfg)

    # the loader alone: decode + resize + LiDAR prep + collate per batch
    train_ds = NuScenesDataset(split="train", config=cfg, seed=ts.seed, emit_uint8=True)
    if not (train_ds[0]["lidar_points"] != 0).any(axis=1).all():
        raise AssertionError("the LiDAR cloud was not subsampled to max_points")
    loader_ms = []
    t = time.perf_counter()
    for _ in DataLoader(train_ds, batch_size=ts.batch_size, prefetch=0):
        loader_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
    out["loader_ms_per_batch"] = loader_ms

    os.chdir(tmp)  # metrics_output.txt goes to the working directory, as in the JAX CLI
    try:
        record = {}
        pf.pointnet_fused.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with traced_trainer(record):
            t = time.perf_counter()
            first = train_detect.main(config=cfg, device="cuda")
            out["run1_s"] = time.perf_counter() - t
            saved = trainer_state(first)
            del first
            torch.cuda.empty_cache()
            cfg2 = copy.deepcopy(cfg)
            cfg2["train"]["num_epochs"] = 2
            cfg2["train"]["resume"]["enable"] = True
            t = time.perf_counter()
            second = train_detect.main(config=cfg2, device="cuda")
            out["run2_s"] = time.perf_counter() - t
        launches = pf.pointnet_fused.launches
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del second
        torch.cuda.empty_cache()
        report = check_report(tmp / "metrics_output.txt")
    finally:
        os.chdir(cwd)

    restored = record["load_checkpoint"]
    if len(restored) != 1 or restored[0]["epoch"] != 0:
        raise AssertionError(f"the resumed run did not restore epoch 0: {restored}")
    n_arrays = assert_states_equal(restored[0]["state"], saved)
    log_lines = [json.loads(s) for s in (tmp / "logs" / "train_log.jsonl").read_text().splitlines()]
    steps_per_epoch = 8 // ts.batch_size
    if [ln["step"] for ln in log_lines] != list(range(1, 2 * steps_per_epoch + 1)):
        raise AssertionError(f"steps logged {[ln['step'] for ln in log_lines]}: the resume did not start at epoch 1")
    if any(set(ln) != JAX_LOG_KEYS for ln in log_lines):
        raise AssertionError(f"train_log.jsonl keys {sorted(log_lines[0])} != the JAX keys {sorted(JAX_LOG_KEYS)}")
    losses = [ln["total_loss"] for ln in log_lines]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    files = sorted(p.name for p in (tmp / "checkpoints").iterdir())
    if files != ["best_model.msgpack", "checkpoint_epoch_1.msgpack"]:
        raise AssertionError(f"after keep_last 1 the checkpoints are {files}")
    epochs, evals = record["train_one_epoch"], record["evaluate"]
    val_batches = (4 + ts.batch_size - 1) // ts.batch_size
    if any(e["b1_launches"] for e in epochs) or any(e["b1_launches"] != 2 * val_batches for e in evals):
        raise AssertionError(f"B1 launches: train epochs {[e['b1_launches'] for e in epochs]}, "
                             f"validations {[e['b1_launches'] for e in evals]} (want 0 and {2 * val_batches})")

    # serve best_model.msgpack in f32 and hold it to the Trainer's eval step
    best = str(tmp / "checkpoints" / "best_model.msgpack")
    val_ds = NuScenesDataset(split="val", config=cfg, seed=ts.seed, emit_uint8=True)
    samples = [val_ds[i] for i in range(len(val_ds))]
    server = InferenceServer(config=cfg, model_path=best, batch_size=len(samples), score_threshold=0.0,
                             use_bf16=False, fold_bn=False, device="cuda")
    got = server._run_batch([{k: s[k] for k in ("camera_imgs", "lidar_points", "radar_points")}
                             for s in samples])
    del server
    trainer = Trainer(MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding),
                      ts, compat, device="cuda").init_state()
    trainer.load_checkpoint(best)
    step = make_eval_step(trainer.model, compat, max_detections=spec.centernet.max_detections,
                          eval_path_decode=True, device="cuda")
    want = decode_to_host(step(collate_fn(samples)), score_thresh=0.0)
    del trainer, step
    torch.cuda.empty_cache()
    scale = max(float(np.abs(w["scores"]).max()) for w in want)
    box_scale = max(float(np.abs(w["boxes"]).max()) for w in want)
    err = box_err = 0.0
    for g, w in zip(got, want):
        if len(g["scores"]) != len(w["scores"]) or not np.array_equal(g["labels"], w["labels"]):
            raise AssertionError("served and evaluated detection counts or labels differ")
        err = max(err, float(np.abs(g["scores"] - w["scores"]).max()))
        box_err = max(box_err, float(np.abs(g["boxes"][:, :7] - w["boxes"]).max()))
    if err > 1e-4 * scale or box_err > 1e-4 * box_scale:
        raise AssertionError(f"served detections differ from the eval step's: scores by {err} (scale "
                             f"{scale}), boxes by {box_err} (scale {box_scale})")

    eps = [e["s"] for e in epochs]
    # the per-step log's step_seconds cover H2D copy, forward, backward and
    # the update up to the loss's host read; the rest of an epoch waits on
    # the loader's prefetch thread
    step_s = [sum(ln["step_seconds"] for ln in log_lines[i * steps_per_epoch:(i + 1) * steps_per_epoch])
              for i in range(2)]
    out.update({
        "step_s_per_epoch": step_s, "loader_wait_s_per_epoch": [e - st for e, st in zip(eps, step_s)],
        "epoch_s": eps, "train_steps_per_s": [steps_per_epoch / s for s in eps],
        "train_samples_per_s": [steps_per_epoch * ts.batch_size / s for s in eps],
        "validation_s": [e["s"] for e in evals],
        "checkpoint_bytes": record["save_checkpoint"][0]["bytes"],
        "checkpoint_write_s": [e["s"] for e in record["save_checkpoint"]],
        "checkpoint_read_s": [e["s"] for e in record["load_checkpoint"]],
        "restored_arrays_bit_exact": n_arrays, "losses": losses, "metrics": report,
        "b1_launches": launches, "served_score_err": err, "score_scale": scale, "served_box_err": box_err,
    })
    log(f"  epochs: {', '.join(f'{s:.2f}' for s in eps)} s (host clock) = "
        f"{', '.join(f'{v:.2f}' for v in out['train_steps_per_s'])} train steps/s, "
        f"{', '.join(f'{v:.1f}' for v in out['train_samples_per_s'])} samples/s")
    log(f"  of each epoch, train steps {', '.join(f'{v:.2f}' for v in step_s)} s (per-step log), "
        f"waiting on the loader {', '.join(f'{v:.2f}' for v in out['loader_wait_s_per_epoch'])} s")
    log(f"  loader (decode + LiDAR prep + collate, one thread): "
        f"{', '.join(f'{v:.0f}' for v in loader_ms)} ms per batch of {ts.batch_size}")
    log(f"  validation: {', '.join(f'{s:.2f}' for s in out['validation_s'])} s; mAP {report['mAP']:.4f} "
        f"NDS {report['NDS']:.4f}")
    log(f"  checkpoint: {out['checkpoint_bytes'] / 2 ** 20:.1f} MiB, write "
        f"{', '.join(f'{s:.2f}' for s in out['checkpoint_write_s'])} s, read "
        f"{', '.join(f'{s:.2f}' for s in out['checkpoint_read_s'])} s; restore bit-exact over {n_arrays} arrays")
    log(f"  peak device memory {out['max_memory_gib']:.2f} GiB; B1 launches {launches} "
        f"(0 in train epochs, 2 per validation batch); served vs eval step: scores within {err:.2e} "
        f"(scale {scale:.3f}), boxes within {box_err:.2e}")
    return out, cfg


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def check_submission(path: Path, infos, classes) -> int:
    """submission.json in the nuScenes schema, one entry list per val
    sample; returns the number of boxes."""
    sub = json.loads(path.read_text())
    if sub["meta"] != {"use_camera": True, "use_lidar": True, "use_radar": True, "use_map": False,
                       "use_external": False}:
        raise AssertionError(f"submission meta {sub['meta']}")
    if list(sub["results"]) != [info["token"] for info in infos]:
        raise AssertionError(f"submission tokens {list(sub['results'])}")
    n = 0
    for token, entries in sub["results"].items():
        if not 0 < len(entries) <= 500:
            raise AssertionError(f"{len(entries)} boxes for {token}")
        for e in entries:
            ok = (e["sample_token"] == token and e["detection_name"] in classes and e["attribute_name"] == ""
                  and [len(e[k]) for k in ("translation", "size", "rotation", "velocity")] == [3, 3, 4, 2]
                  and np.isfinite(e["translation"] + e["size"] + e["rotation"] + e["velocity"]
                                  + [e["detection_score"]]).all()
                  and abs(np.linalg.norm(e["rotation"]) - 1.0) < 1e-6)
            if not ok:
                raise AssertionError(f"bad submission entry {e}")
            n += 1
    return n


def by_position(res: dict) -> dict:
    order = np.lexsort((res["boxes"][:, 1], res["boxes"][:, 0]))
    return {k: v[order] for k, v in res.items()}


def serve_cli_drain(tmp: Path, sample: dict, timeout_s: float = 180.0) -> dict:
    """The serve CLI in a subprocess (seeded weights, batch 2): a request,
    then SIGTERM with a second one in its 1 s coalescing window; both must
    be answered and the process must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.serve", "--config", "configs/base.yaml", "--port", "0",
         "--batch-size", "2", "--max-delay-ms", "1000"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp), env=env,
    )
    lines = []
    try:
        # read the output on a thread, so that a server that never listens
        # fails the phase at the deadline instead of blocking it
        ready = threading.Event()

        def read():
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("Serving on "):
                    ready.set()

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        if not ready.wait(timeout_s):
            raise AssertionError("the serve CLI did not start listening:\n" + "".join(lines))
        start_s = time.perf_counter() - t0
        client = InferenceClient(next(ln for ln in lines if ln.startswith("Serving on ")).split()[2],
                                 retries=0, timeout_s=120)
        first = client.infer(sample)
        second = {}
        t = threading.Thread(target=lambda: second.update(client.infer(sample)))
        t.start()
        time.sleep(0.3)  # the request now waits in the coalescing window
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=120)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    if rc != 0 or "scores" not in second or "Drained" not in out:
        raise AssertionError(f"the serve CLI's drain failed (exit {rc}, second answered: {'scores' in second}):\n"
                             + out)
    return {"start_s": start_s, "exit_code": rc, "answered": 2,
            "detections": [len(first["scores"]), len(second["scores"])]}


def entry_points(cfg: dict, tmp: Path) -> dict:
    """Phase 12: the inference, evaluation and serving entry points at full
    width on phase 11's tree and best_model.msgpack."""
    out = {}
    best = tmp / "checkpoints" / "best_model.msgpack"
    (tmp / "configs").mkdir(exist_ok=True)
    (tmp / "configs" / "base.yaml").write_text(yaml.safe_dump(cfg))  # Q10: the eval CLI's model config
    user = copy.deepcopy(cfg)
    user["metrics"].update(use_official=True, save_submission="submission.json")
    (tmp / "user.yaml").write_text(yaml.safe_dump(user))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        # 1. the eval CLI, each eval step timed up to a synchronize
        batch_s = []
        make_eval_step = train_loop.make_eval_step

        def timed_make_eval_step(*args, **kwargs):
            step = make_eval_step(*args, **kwargs)

            def timed(batch):
                torch.cuda.synchronize()
                t = time.perf_counter()
                result = step(batch)
                torch.cuda.synchronize()
                batch_s.append(time.perf_counter() - t)
                return result
            return timed

        train_loop.make_eval_step = timed_make_eval_step
        try:
            pf.pointnet_fused.launches = 0
            t = time.perf_counter()
            metrics = eval_cli.main("user.yaml")
            out["eval_s"] = time.perf_counter() - t
            out["eval_launches"] = pf.pointnet_fused.launches
        finally:
            train_loop.make_eval_step = make_eval_step
        out["eval_s_per_batch"] = batch_s
        report = check_report(tmp / "eval_results" / "eval_metrics_output.txt")
        official = check_report(tmp / "eval_results" / "eval_metrics_official.txt", DEFAULT_CLASSES)
        if abs(report["mAP"] - round(metrics["mAP"], 4)) > 1e-9:
            raise AssertionError(f"the report's mAP {report['mAP']} is not the CLI's {metrics['mAP']}")
        val_infos = NuScenesDataset(split="val", config=cfg).infos
        out["submission_boxes"] = check_submission(tmp / "submission.json", val_infos, DEFAULT_CLASSES)
        if len(batch_s) != 1 or out["eval_launches"] != 2 * len(batch_s):
            raise AssertionError(f"eval CLI: {len(batch_s)} batches, B1 launches {out['eval_launches']} "
                                 "(want 1 batch of 4 and 2 launches per batch)")
        out["eval_metrics"] = {"mAP": report["mAP"], "NDS": report["NDS"], "official_mAP": official["mAP"],
                               "official_NDS": official["NDS"]}

        # 2. the engine on the card against the CPU (plain B1), f32
        gpu = InferenceEngine(model_path=str(best), config=cfg)
        cpu = InferenceEngine(model_path=str(best), config=cfg, device="cpu")
        sample = NuScenesDataset(split="val", config=cfg, seed=0)[0]
        pf.pointnet_fused.launches = 0
        preds_g, dec_g = gpu._forward(sample)
        torch.cuda.synchronize()
        forward_launches = pf.pointnet_fused.launches
        preds_c, dec_c = cpu._forward(sample)
        del cpu
        errs = {}
        for k, want in list(preds_c.items()) + [("decoded_scores", dec_c["scores"])]:
            got = (preds_g[k] if k in preds_g else dec_g["scores"]).float().cpu()
            scale = max(want.abs().max().item(), 1e-30)
            errs[k] = {"max_abs_err": (got - want).abs().max().item(), "scale": scale}
            if not errs[k]["max_abs_err"] <= 1e-4 * scale:
                raise AssertionError(f"engine card vs CPU: {k} differs by {errs[k]} (limit 1e-4 of the scale)")
        out["engine_card_vs_cpu"] = errs
        pf.pointnet_fused.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):  # each run prints its detections
            runs = [gpu.run_inference(sample, visualize=False) for _ in range(6)]
        out["engine_launches"] = forward_launches + pf.pointnet_fused.launches
        if forward_launches != 2 or pf.pointnet_fused.launches != 12:
            raise AssertionError(f"engine B1 launches {forward_launches}, {pf.pointnet_fused.launches} (want 2, 12)")
        latency = [r["latency_s"] for r in runs[1:]]
        out["engine_latency_s"] = latency
        # B1 alone at the engine's shapes through its wrapper, f32 batch 1
        lidar = chain_args(gpu.model.lidar_encoder, sample["lidar_points"][None], torch.float32, "cuda")
        radar = chain_args(gpu.model.radar_encoder.shared_radar, sample["radar_points"], torch.float32, "cuda")
        b1_ms = {"lidar_1x35000": time_ms(lambda: pf.pointnet_fused(*lidar)),
                 "radar_5x125": time_ms(lambda: pf.pointnet_fused(*radar))}
        flops = sum(pf.pointnet_flops(x.shape[0], x.shape[1], [x.shape[2]] + [wi.shape[1] for wi in w])
                    for x, w, _ in (lidar, radar))
        nbytes = sum(x.numel() * 4 + sum(wi.numel() * 4 + bi.numel() * 4 for wi, bi in zip(w, b))
                     + x.shape[0] * w[-1].shape[1] * 4 for x, w, b in (lidar, radar))
        out["engine_b1_ms"] = b1_ms
        out["engine_b1_bound_ms"] = max(flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES) * 1e3
        out["engine_b1_gflop"] = flops / 1e9
        out["engine_b1_share"] = sum(b1_ms.values()) / (float(np.median(latency)) * 1e3)
        del gpu, lidar, radar
        torch.cuda.empty_cache()

        # 3. the inference CLI: --batch 4, then one sample. matplotlib is
        # not installed on the card's machine, so the figure is never drawn
        # here (--no-show)
        pf.pointnet_fused.launches = 0
        args = ["--model", str(best), "--config", "configs/base.yaml", "--split", "val",
                "--save-dir", "inference_results"]
        with contextlib.redirect_stdout(io.StringIO()):
            t = time.perf_counter()
            summary = inference_cli.main(args + ["--batch", "4"])
            out["inference_cli_batch_s"] = time.perf_counter() - t
            one = inference_cli.main(args + ["--sample-idx", "1", "--no-show"])
        out["inference_cli_launches"] = pf.pointnet_fused.launches
        written = sorted(p.name for p in (tmp / "inference_results").glob("predictions_*.json"))
        if summary["num_samples"] != 4 or len(written) != 4 or "figure_path" in one \
                or out["inference_cli_launches"] != 10:
            raise AssertionError(f"inference CLI: {summary}, wrote {written}, "
                                 f"B1 launches {out['inference_cli_launches']} (want 10)")
        out["inference_cli_samples_per_s"] = summary["samples_per_sec"]
        out["inference_cli_mean_latency_s"] = summary["mean_latency_s"]

        # 4. HTTP serving in process: bf16, folded BN, batch 8
        val_u8 = NuScenesDataset(split="val", config=cfg, seed=0, emit_uint8=True)
        samples = [{k: val_u8[i][k] for k in WIRE_KEYS} for i in range(4)]
        server = InferenceServer(config=cfg, model_path=str(best), score_threshold=0.0).start()
        httpd = make_http_server(server, "127.0.0.1", 0)
        serving = threading.Thread(target=httpd.serve_forever, daemon=True)
        serving.start()
        try:
            client = InferenceClient(f"http://127.0.0.1:{httpd.server_address[1]}", retries=0)
            want = [server.infer(s, timeout=120) for s in samples]
            client.infer(samples[0])  # one request through the socket before timing

            def timed_infer(i):
                t = time.perf_counter()
                res = client.infer(samples[i % 4])
                return res, time.perf_counter() - t

            n = 16
            pf.pointnet_fused.launches = 0
            t = time.perf_counter()
            with ThreadPoolExecutor(n) as pool:
                answered = list(pool.map(timed_infer, range(n)))
            wall = time.perf_counter() - t
            out["http_launches"] = pf.pointnet_fused.launches
            for i, (res, _) in enumerate(answered):
                g, w = by_position(res), by_position(want[i % 4])
                if len(g["scores"]) != len(w["scores"]) or not np.array_equal(g["labels"], w["labels"]) \
                        or np.abs(g["scores"] - w["scores"]).max() > 1e-4 \
                        or np.abs(g["boxes"] - w["boxes"]).max() > 1e-3:
                    raise AssertionError(f"HTTP answer {i} differs from the in-process server.infer")
            stats = client.stats()
            if stats["requests"] != 4 + 1 + n or out["http_launches"] <= 0:
                raise AssertionError(f"/stats counts {stats['requests']} requests (want {4 + 1 + n}); "
                                     f"B1 launches {out['http_launches']}")
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            conn.putrequest("POST", "/infer")
            conn.putheader("Content-Type", "application/x-npz")
            conn.putheader("Content-Length", str(2 ** 30))  # no body follows
            conn.endheaders()
            status = conn.getresponse().status
            conn.close()
            if status != 413:
                raise AssertionError(f"an oversized POST got {status}, not 413")
            lat = sorted(s for _, s in answered)
            out.update({"http_requests": n, "http_batches": stats["batches"], "http_p50_s": float(np.median(lat)),
                        "http_max_s": lat[-1], "http_requests_per_s": n / wall})
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.stop()
        del server
        torch.cuda.empty_cache()

        # 5. the serve CLI's SIGTERM drain
        out["drain"] = serve_cli_drain(tmp, samples[0])
    finally:
        os.chdir(cwd)

    where = card()
    log(f"  eval CLI: {out['eval_s']:.2f} s in all, {', '.join(f'{s:.3f}' for s in batch_s)} s per batch of 4 "
        f"(f32, TF32 off); mAP {report['mAP']:.4f} NDS {report['NDS']:.4f}, official mAP {official['mAP']:.4f}; "
        f"{out['submission_boxes']} submission boxes; B1 launches {out['eval_launches']} [{where}]")
    log(f"  engine: latency_s median {np.median(latency):.4f} s (runs {', '.join(f'{v:.4f}' for v in latency)}); "
        f"B1 {b1_ms['lidar_1x35000']:.4f} + {b1_ms['radar_5x125']:.4f} ms f32 = "
        f"{100 * out['engine_b1_share']:.1f}% of it (bound {out['engine_b1_bound_ms']:.4f} ms); card vs CPU "
        f"heatmap within {errs['heatmap']['max_abs_err']:.2e} [{where}]")
    log(f"  inference CLI: {out['inference_cli_samples_per_s']:.2f} samples/s over 4 (batch 1, f32); "
        f"B1 launches {out['inference_cli_launches']} [{where}]")
    log(f"  HTTP: {n} concurrent npz requests, p50 {out['http_p50_s'] * 1e3:.1f} ms, max "
        f"{out['http_max_s'] * 1e3:.1f} ms, {out['http_requests_per_s']:.2f} requests/s in {stats['batches']} "
        f"batches so far (bf16, batch 8); B1 launches {out['http_launches']}; 413 on an oversized POST [{where}]")
    log(f"  serve CLI: listening after {out['drain']['start_s']:.1f} s; SIGTERM with a request in flight: both "
        f"answered, exit {out['drain']['exit_code']}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the fusion and head variants
# ---------------------------------------------------------------------------

# name: (fusion_type, LiDAR encoder); B1 runs both point encoders of the
# attention and late models, and only the radar's beside VoxelNet
VARIANTS = {"attention_mlp": ("attention", "PointNet"), "late_mlp": ("late", "PointNet"),
            "bev_voxelnet": ("bev", "VoxelNet")}
B1_PER_FORWARD = {"attention_mlp": 2, "late_mlp": 2, "bev_voxelnet": 1}


def variant_config(config, name: str, dropout: bool = True) -> dict:
    """base.yaml with the variant's fusion or LiDAR encoder switched; with
    `dropout` False the spec's dropout rates are 0."""
    cfg = copy.deepcopy(config)
    model = cfg["model"]
    model["fusion_type"], model["lidar_encoder"]["type"] = VARIANTS[name]
    if not dropout:
        for key in ("attention_fusion", "late_fusion", "mlp_head"):
            model[key]["dropout"] = 0.0
    return cfg


def output_errors(got: dict, want: dict, what: str) -> dict:
    """Each output's max abs error and scale (its largest magnitude); fails
    above 1e-4 of the scale."""
    errs = {}
    for k, v in want.items():
        scale = max(v.abs().max().item(), 1e-30)
        errs[k] = {"max_abs_err": (got[k].float().cpu() - v).abs().max().item(), "scale": scale}
        if not errs[k]["max_abs_err"] <= 1e-4 * scale:
            raise AssertionError(f"{what} {k}: card and CPU differ by {errs[k]} (limit 1e-4 of the scale)")
    return errs


@contextlib.contextmanager
def heads_split_transposed():
    """A wrong attention: q, k and v split into heads as (b, heads, n,
    head_dim) without the transpose, and merged back the same way."""
    plain = port_fusion.CrossModalAttention.forward

    def forward(self, query, key, value):
        b, n_q, _ = query.shape
        hd = self.dim // self.num_heads
        split = lambda t: t.reshape(b, self.num_heads, -1, hd)  # noqa: E731
        q, k, v = split(self.query(query)), split(self.key(key)), split(self.value(value))
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / hd ** 0.5, dim=-1)
        return self.out(torch.matmul(attn, v).reshape(b, n_q, self.dim))

    port_fusion.CrossModalAttention.forward = forward
    try:
        yield
    finally:
        port_fusion.CrossModalAttention.forward = plain


def check_small_variants(config) -> dict:
    """13a: small f32 models of each variant on the card against the CPU,
    with B1's launches per forward, and the attention mutants rejected."""
    out = {}
    for name in VARIANTS:
        cfg = variant_config(config, name)
        cfg["model"]["camera_encoder"]["input_size"] = [64, 128]
        cfg["dataset"]["max_points"] = {"lidar": 1000, "radar_per_sensor": 125}
        spec = DetectorSpec.from_config(cfg)
        g = torch.Generator().manual_seed(13)
        cpu = randomize_stats(MultiModal3DDetector(spec).init_weights(g), g).eval()
        if spec.head_is_centernet:
            with torch.no_grad():  # O(1) head outputs, so the comparison bites
                for m in cpu.det_head.modules():
                    if isinstance(m, torch.nn.Conv2d):
                        m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
        gpu = copy.deepcopy(cpu).cuda()
        rng = np.random.RandomState(14)
        inputs = (rng.randn(2, 6, 64, 128, 3).astype(np.float32), lidar_points(rng, 3, 1000)[:2],
                  np.stack([radar_points(rng, 5, 125)] * 2))
        with torch.no_grad():
            pf.pointnet_fused.launches = 0
            got = gpu(*(torch.from_numpy(a).cuda() for a in inputs))
            torch.cuda.synchronize()
            launches = pf.pointnet_fused.launches
            want = cpu(*(torch.from_numpy(a) for a in inputs))
        errs = output_errors(got, want, f"small {name}")
        if launches != B1_PER_FORWARD[name]:
            raise AssertionError(f"small {name}: B1 launched {launches} times (want {B1_PER_FORWARD[name]})")
        out[name] = {"errors": errs, "launches": launches}
        log(f"  small {name}: " + ", ".join(f"{k} {e['max_abs_err']:.3g} of scale {e['scale']:.3g}"
                                            for k, e in errs.items()) + f"; B1 launches {launches} [{card()}]")
        if name != "attention_mlp":
            continue
        mutants = {}
        with torch.no_grad(), heads_split_transposed():
            mutants["heads split transposed"] = gpu(*(torch.from_numpy(a).cuda() for a in inputs))
        # tokens of small spread, where LayerNorm's epsilon decides: the
        # projections, embeddings and first attention scaled by 1e-3
        small = copy.deepcopy(cpu)
        with torch.no_grad():
            for pname, p in small.fusion.named_parameters():
                if pname.startswith(("camera_", "lidar_", "radar_", "cam_", "self_attn_0.")):
                    p.mul_(1e-3)
            want_small = small(*(torch.from_numpy(a) for a in inputs))
            small_gpu = copy.deepcopy(small).cuda()
            output_errors(small_gpu(*(torch.from_numpy(a).cuda() for a in inputs)), want_small,
                          "small attention, small tokens")
            for m in small_gpu.modules():
                if isinstance(m, torch.nn.LayerNorm):
                    m.eps = 1e-5
            mutants["LayerNorm at eps 1e-5"] = (small_gpu(*(torch.from_numpy(a).cuda() for a in inputs)),
                                                want_small)
        worst = {}
        for what, bad in mutants.items():
            bad, ref = bad if isinstance(bad, tuple) else (bad, want)
            worst[what] = max((bad[k].float().cpu() - v).abs().max().item() / (1e-4 * v.abs().max().item())
                              for k, v in ref.items())
            if worst[what] <= 1.0:
                raise AssertionError(f"the card-vs-CPU check does not reject the mutant: {what}")
        out[name]["mutants_times_limit"] = worst
        log("  mutants rejected at " + ", ".join(f"{k} {v:.3g}x the limit" for k, v in worst.items()))
    return out


def check_small_variant_train(config) -> dict:
    """13b: one small train step of attention + MLP and late + MLP on the
    card against the CPU's float64 step (float64; f32 with the CPU's
    reference on the card's side of every tie), dropout 0, no B1 launch."""
    out = {}
    launches = pf.pointnet_fused.launches
    for name in ("attention_mlp", "late_mlp"):
        cfg = small_train_config(variant_config(config, name, dropout=False))
        spec, compat, ts = DetectorSpec.from_config(cfg), CompatFlags.from_config(cfg), TrainSpec.from_config(cfg)
        g = torch.Generator().manual_seed(17)
        state0 = randomize_stats(MultiModal3DDetector(spec).init_weights(g), g).state_dict()
        rng = np.random.RandomState(18)
        b = train_batch(spec, rng, 2, 16, 5)
        b["camera_imgs"] = ((b["camera_imgs"] / 255.0 - IMAGENET_MEAN.astype(np.float64))
                            / IMAGENET_STD.astype(np.float64))
        run = functools.partial(TrainRun, spec, compat, ts, state0, dropout=False)
        want = run("cpu", torch.float64)(b)
        got = run("cuda", torch.float64)(b)
        worst = {"float64": compare_step(got, want, None, ts.learning_rate, f"{name} float64")}
        ties = TieSides()
        with ties.record():
            got = run("cuda", torch.float32)(b)
        with ties.replay():
            want = run("cpu", torch.float64)(b)
        if not ties.flip_share <= 1e-5:
            raise AssertionError(f"{name}: the f32 step took the other side of a kink {ties.flip_share:.3g} "
                                 "of its tensor's largest away")
        worst["f32"] = compare_step(got, want, None, ts.learning_rate, f"{name} f32", 1e-4)
        out[name] = dict(worst, f32_ties_across=ties.flips, losses=sorted(got["losses"]))
        log(f"  small train {name}: worst share of each limit " + json.dumps(out[name]) + f" [{card()}]")
    if pf.pointnet_fused.launches != launches:
        raise AssertionError("a variant's train step launched B1")
    return out


def variant_eval_step(cfg: dict, name: str) -> dict:
    """13c: the eval step at batch 4 in f32 (TF32 off), seeded weights,
    uint8 cameras: ms per batch (host clock up to a synchronize, 3 batches
    after one warm-up) and B1's launches."""
    spec, compat, ts = DetectorSpec.from_config(cfg), CompatFlags.from_config(cfg), TrainSpec.from_config(cfg)
    g = torch.Generator().manual_seed(19)
    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding).init_weights(g)
    step = make_eval_step(model, compat)
    batch = train_batch(spec, np.random.RandomState(20), ts.batch_size, ts.max_objects, 40)
    step(batch)
    torch.cuda.synchronize()
    pf.pointnet_fused.launches = 0
    times = []
    for _ in range(3):
        t = time.perf_counter()
        outputs = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = pf.pointnet_fused.launches
    if launches != 3 * B1_PER_FORWARD[name]:
        raise AssertionError(f"{name} eval step: B1 launched {launches} times in 3 batches")
    if not all(bool(torch.isfinite(v.float()).all()) for v in outputs.values()):
        raise AssertionError(f"{name} eval step: non-finite outputs")
    return {"batch": ts.batch_size, "ms": times, "ms_p50": float(np.median(times)), "launches": launches,
            "outputs": {k: list(v.shape) for k, v in outputs.items()}}


def variants_full_width(config) -> dict:
    """13c for each variant: the eval step, then phase 10's train steps."""
    out = {}
    where = card()
    for name in VARIANTS:
        cfg = variant_config(config, name)
        torch.cuda.empty_cache()
        ev = variant_eval_step(cfg, name)
        log(f"  {name} eval step: {ev['ms_p50']:.2f} ms per batch of {ev['batch']} (f32, TF32 off; p50 of 3: "
            f"{', '.join(f'{v:.2f}' for v in ev['ms'])}); B1 launches {ev['launches']} [{where}]")
        torch.cuda.empty_cache()
        out[name] = {"eval_step": ev, "train": train_full_width(cfg, f"{name} ")}
    return out


ABLATION_LINE = re.compile(r"^(\S+) +(\S+) +PASS +[\d,]+  \S.*$")


def ablation_full_width(tmp: Path) -> dict:
    """13d: the port's ablation CLI on configs/base.yaml at full width on the
    card: every variant PASS, its file in the JAX runner's format."""
    path = tmp / "ablation_results.txt"
    pf.pointnet_fused.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = ablation.main(["--config", "configs/base.yaml", "--out", str(path), "--device", "cuda"])
    seconds = time.perf_counter() - t
    launches = pf.pointnet_fused.launches
    failed = [r[:3] for r in rows if r[2] != "PASS"]
    lines = path.read_text().splitlines()
    if len(rows) != 21 or failed:
        raise AssertionError(f"ablation: {len(rows)} variants, failed {failed}")
    if lines[:2] != ["===== Ablation Study =====",
                     f"{'modality':22s} {'fusion':10s} {'status':6s} {'params':>14s}  outputs"] \
            or len(lines) != 23 or not all(ABLATION_LINE.match(ln) for ln in lines[2:]):
        raise AssertionError("ablation: the result file is not in the JAX runner's format")
    # each variant's forward runs B1 once per point encoder (PointNet LiDAR, radar)
    want = sum(sum(parse_modalities(r[0])[1:]) for r in rows)
    if launches != want:
        raise AssertionError(f"ablation: B1 launched {launches} times (want {want})")
    return {"variants": len(rows), "seconds": seconds, "launches": launches,
            "params": {f"{r[0]}/{r[1]}": r[3] for r in rows}, "variant_s": {f"{r[0]}/{r[1]}": r[5] for r in rows}}


def engine_late_fusion(config) -> dict:
    """13e: `InferenceEngine` with late fusion and the MLP head, seeded
    weights, one synthetic full-width sample, card against the CPU; then
    latency_s over 5 runs after one."""
    cfg = variant_config(config, "late_mlp")
    spec = DetectorSpec.from_config(cfg)
    sample = SyntheticNuScenesDataset(num_samples=1, image_size=spec.camera.image_size,
                                      max_points=spec.lidar.max_points,
                                      max_radar_points=spec.radar.max_points_per_sensor, seed=21)[0]
    with contextlib.redirect_stdout(io.StringIO()):
        gpu = InferenceEngine(config=cfg)
        gpu.init_random()
        cpu = InferenceEngine(config=cfg, device="cpu")
        cpu.init_random()
    pf.pointnet_fused.launches = 0
    preds_g, _ = gpu._forward(sample)
    torch.cuda.synchronize()
    forward_launches = pf.pointnet_fused.launches
    preds_c, _ = cpu._forward(sample)
    del cpu
    errs = output_errors(preds_g, preds_c, "engine late fusion")
    label_g, label_c = int(preds_g["cls"][0].argmax()), int(preds_c["cls"][0].argmax())
    if label_g != label_c:
        raise AssertionError(f"engine late fusion: label {label_g} on the card, {label_c} on the CPU")
    pf.pointnet_fused.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        runs = [gpu.run_inference(sample, visualize=False) for _ in range(6)]
    launches = forward_launches + pf.pointnet_fused.launches
    if forward_launches != 2 or launches != 14:
        raise AssertionError(f"engine late fusion: B1 launches {forward_launches}, {launches} (want 2, 14)")
    det = runs[-1]["detections"]
    if det["boxes"].shape != (1, 7) or int(det["labels"][0]) != label_g:
        raise AssertionError(f"engine late fusion: detections {det}")
    latency = [r["latency_s"] for r in runs[1:]]
    del gpu
    torch.cuda.empty_cache()
    return {"card_vs_cpu": errs, "label": label_g, "launches": launches, "latency_s": latency,
            "latency_s_median": float(np.median(latency))}


def b1_f32_yardstick(encoder, rng) -> dict:
    """13f: B1's f32 path against the cuBLAS chain in f32 (TF32 off) at the
    engine's 1x35000x4 and the eval step's 4x35000x4, real points in every
    sample."""
    out = {}
    for b in (1, 4):
        t = time_kernel(encoder, lidar_points(rng, b + 1, 35000)[:b], torch.float32)
        out[f"lidar_{b}x35000"] = t
    return out


def variants(config, encoders, rng, tmp: Path) -> dict:
    """Phase 13."""
    where = card()
    out = {"small": check_small_variants(config)}
    out["small_train"] = check_small_variant_train(config)
    out["full_width"] = variants_full_width(config)
    out["ablation"] = ablation_full_width(tmp)
    log(f"  ablation CLI at full width: {out['ablation']['variants']} variants PASS in "
        f"{out['ablation']['seconds']:.1f} s; B1 launches {out['ablation']['launches']} [{where}]")
    out["engine"] = engine_late_fusion(config)
    e = out["engine"]
    log(f"  engine, late fusion + MLP head: latency_s median {e['latency_s_median']:.4f} s (runs "
        f"{', '.join(f'{v:.4f}' for v in e['latency_s'])}); card vs CPU cls "
        f"{e['card_vs_cpu']['cls']['max_abs_err']:.3g}, box {e['card_vs_cpu']['box']['max_abs_err']:.3g}; "
        f"label {e['label']}; B1 launches {e['launches']} [{where}]")
    out["b1_f32"] = b1_f32_yardstick(encoders["lidar"], rng)
    for shape, t in out["b1_f32"].items():
        log(f"  B1 f32 {shape}: {t['ms']:.4f} ms median of 3 ({t['ms_min']:.4f}-{t['ms_max']:.4f}), "
            f"{100 * t['bound_share']:.1f}% of the bound ({t['bound_ms']:.4f} ms); device alone "
            f"{t['device_ms']:.4f} ms; cuBLAS chain (TF32 off) {t['library_ms']:.4f} ms; plain "
            f"{t['plain_ms']:.4f} ms [{where}]")
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
    t = time.perf_counter()
    native.build()
    log(f"  built the loader's native point prep ({native.SOURCE.name}, g++) in {time.perf_counter() - t:.1f} s")

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

    log("phase 9: small train step on the card against the CPU (float64; f32 with TF32 off)")
    torch.backends.cudnn.allow_tf32 = False
    small_train = check_small_train(config)

    log("phase 10: train steps at full width (batch 4; f32 with TF32 off, then bf16 mixed precision)")
    train = train_full_width(config)
    log("  " + json.dumps({"train_full_width": train}))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        log("phase 11: the training entry point at full width (train_detect.main on a nuScenes tree; f32, TF32 off)")
        entry_point, tree_config = training_entry_point(config, Path(tmp))
        log("  " + json.dumps({"training_entry_point": entry_point}))

        log("phase 12: the eval, inference and serving entry points at full width (phase 11's tree and "
            "best_model.msgpack)")
        entries = entry_points(tree_config, Path(tmp))
        log("  " + json.dumps({"entry_points": entries}))

        log("phase 13: the fusion and head variants (attention and late fusion with the MLP head, bev with "
            "VoxelNet; TF32 off)")
        torch.backends.cudnn.allow_tf32 = False
        t = time.perf_counter()
        var = variants(config, encoders, rng, Path(tmp))
        log(f"  phase 13 took {time.perf_counter() - t:.1f} s")
        log("  " + json.dumps({"variants": var}))

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
             geometric_launches=geo["launches"]["pointnet_fused"],
             training_entry_point_launches=entry_point["b1_launches"],
             eval_cli_launches=entries["eval_launches"], engine_launches=entries["engine_launches"],
             inference_cli_launches=entries["inference_cli_launches"], http_launches=entries["http_launches"],
             engine_f32_ms=entries["engine_b1_ms"], engine_f32_bound_ms=entries["engine_b1_bound_ms"],
             variant_launches={
                 "small_forwards": {k: v["launches"] for k, v in var["small"].items()},
                 "small_train_steps": 0,
                 "eval_steps_3_batches": {k: v["eval_step"]["launches"] for k, v in var["full_width"].items()},
                 "train_steps": {k: v["train"]["f32"]["launches"]["pointnet_fused"]
                                 + v["train"]["bf16_mixed_precision"]["launches"]["pointnet_fused"]
                                 for k, v in var["full_width"].items()},
                 "ablation_cli": var["ablation"]["launches"], "engine_late": var["engine"]["launches"]},
             f32={shape: {k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                  for shape, t in var["b1_f32"].items()}),
        # launches: phase 7, the geometric eval path
        entry("bev_pool_weighted", geo["launches"]["bev_pool_weighted_rows"],
              pool_err["bev_pool_weighted"], pools["bev_pool_weighted"]),
        # no model path calls B3 (as in the JAX package): its count stays 0
        entry("bev_pool_sorted", geo["launches"]["bev_pool_rows"],
              pool_err["bev_pool_sorted"], pools["bev_pool_sorted"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
