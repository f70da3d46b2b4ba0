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
   ragged N = 34,999, 34,945 (1 mod the 128-point bf16 tile), 100, 1 mod
   and 1 under the f32 tile (64 points for the LiDAR chain) and 125 with
   every row a real point, a 4->48->80->144 chain (partial weight slabs, an
   FMA first layer), a 4->32->50->64->96->66 chain (f32 FMA loops around
   a blocked layer, a ragged last layer) and a 4->64->528->264 chain
   (partial f32 N-slabs). The comparison is shown to reject
   the plain version with one bias dropped or with the zero rows of the
   dtype's own tile in the max;
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
   C = 256, 50x50 cells, and B3 on 6 rows x 56,000 points, in f32 and bf16;
   both at 100x100 cells, where windows are empty and the cell count is not
   a multiple of the window, and on rows whose longest cell holds 30,000 of
   ~46,500 entries (B2: 12 rows, f32 and bf16, the cell across many of a
   block's warp segments; B3: 6 rows, f32, across many blocks); B2 also on
   rows of 16,384 pixels, which take B3's sorted kernel; every launch is
   repeated and must give the same bits. The comparison is shown to reject
   the plain version with every weight 1, with pads gathering a real row,
   with out-of-range points sent to cell 0, with one chunk shifted a
   window, and with the second half of a row's longest cell dropped;
7. the geometric eval path: base.yaml with camera_to_bev: geometric and
   splat_mode: pallas, `train.loop.make_eval_step` at full width, bf16,
   batch 8, seeded weights, uint8 cameras and ring-calibration chunk plans
   from `data.dataset.chunk_plans`, over 3 batches with the launch counters
   zeroed just before and read just after. Then ms per batch, samples/s,
   peak memory and a per-module device-time breakdown;
8. B2 and B3 timings beside the plain versions, a library yardstick
   (`lift_splat_matmul_rows`; one `index_add_`) and the bound; B2's slice
   width, blocks and blocks per SM, and its time on one sample's 6 rows;
   B3's warps a row, blocks, blocks per SM and scratch, the real entries of
   its busiest warp against its row's mean, its device time alone, and its
   time and bound on phase 6's long-cell plan.
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
   matmul/relu/amax chain (TF32 off) at LiDAR 1x35000x4 and 4x35000x4 and
   radar 5x125x7 and 20x125x7 (the engine's and an eval batch's shapes);
14. the scatter and culled splats and the training-data options: (a) B1 on
   the multi-sweep LiDAR chain (C_in = 5) against its plain version with
   phase 2's comparison, calibration, limits and mutants (8x35000x5 bf16
   and f32, 4x and 1x35000x5 f32, ragged N, dense clusters in f32) and its
   times at 8x35000x5 bf16 and 4x35000x5 f32 as phase 5 gives them;
   (b) card against CPU in f32 (TF32 off): `GeometricCameraBEV` in scatter
   and culled modes (eval and train, 1e-4 of scale), one culled train step
   and one augmented train step at phase 9's limits (the augmentation's
   draws come from a CPU generator, the same on both); (c) at full width,
   geometric with the culled splat on the ring calibration's pair plans:
   the eval step at batch 8 in bf16 (B1 2 launches a batch, B2 none;
   T_cull and U_cap), train steps at batch 4 in f32 and bf16 with
   augmentation on and the geometry frozen, as phase 10 times them; the
   scatter splat's eval step at the same shapes; (d) `train_detect.main`
   on a phase-11-style tree with LiDAR and radar sweeps (radar .pcd files,
   Q4 off), augmentation on, num_sweeps and radar_num_sweeps 2 and
   camera_encoder.freeze_bn: one epoch and a resume, restored bit for bit,
   B1 twice per validation batch on the 5-wide chain and never in
   training, the camera BatchNorm statistics unchanged;
15. AOT serving, profiling and the compile cache: (a) phase 4's server
   (seeded weights A) exported with `utils.aot.export_serving_artifact`
   (`torch.export`, both wire signatures, B1 as the custom op
   bmod_torch::pointnet_fused); a server built with `aot_path=` serves
   phase 4's 19 mixed requests, B1 launch counter zeroed just before and
   read just after, equal to the live server's at scores 1e-4 and boxes
   1e-3 (bit equality printed), and a server restored with seeded weights B
   on the same artifact equals a live server with weights B (and not A's
   answers); artifact bytes, export and load seconds, steady batch latency
   beside the live server's; (b) `utils.profiling.profile_trace` around 3
   served batches and 3 full-width bf16 mixed-precision train steps: from
   each trace the device idle share (1 - the union of the kernels'
   intervals over the traced window), the top 5 kernels by time and
   `device_memory_stats()`; (c) `debug.profile: true` through
   `train_detect.main` on phase 11's tree for one epoch leaves a trace under
   log_dir/profile; (d) the serve CLI's --export-aot, then --aot in a
   subprocess: one request answered, SIGTERM drains, exit 0;
16. data parallelism on the one card: (a) a process group of one rank over
   NCCL on cuda:0: three data-parallel train steps of base.yaml at batch 4
   (synced BatchNorm, global loss normalizers, the gradient all-reduce),
   each from the plain step's state before it, held to the plain step in
   float64 at phase 9's limits; then three f32 (TF32 off) and three bf16
   mixed-precision steps of each, the losses held at 1e-5 and 2^-7 and
   phase 9's other shares reported (two f32 runs that differ only in
   rounding do not meet those limits against each other), and their step
   times side by side;
   (b) two rank processes (this script with --dp-rank) on cuda:0 over gloo
   (NCCL on two cards where there are two) at 2 rows each against one
   process at 4, three float64 steps at the same limits (f32 rounding
   crosses kinks differently at 2 rows than at 4), the per-rank BatchNorm
   statistics and per-rank focal-loss positives mutants shown to exceed
   them, ZeRO-1's first float64 step against plain data parallelism's
   (where the backend's all-gathers of CUDA tensors give the right values)
   and its moment bytes, the f32 step time through the host-copied
   collectives (no scaling figure); (c)
   `InferenceServer(devices=[cuda:0, cuda:0])` at batch 8, bf16, on phase
   4's 19 requests, B1 counted (2 a replica a batch) and the answers held to
   one device's at the replicas' part of 4 rows (bf16 results follow the
   batch shape through cuDNN's algorithms) at scores 1e-4 and boxes 1e-3,
   batch latency beside one device's at 8, and `serve --data-parallel`
   beyond the cards exiting with the device-count message; (d) the training CLI under `python -m
   torch.distributed.run --standalone --nproc_per_node 1` with multi_host on
   phase 11's tree for one epoch (one checkpoint, one report), then resumed
   in this process bit for bit against that checkpoint.
17. the camera-view axis and BEV-spatial partitioning: (a) two rank
   processes (this script with --view-rank) on cuda:0 over gloo, laid out
   as (data 1, view 2) with bev_spatial: each runs the camera trunk on 3
   of the 6 cameras (the features all-gathered) and the CenterNet head on
   25 of the 50 BEV rows with a halo row each side (the maps all-gathered).
   One float64 train step of base.yaml at 2 rows, from the plain step's
   state, held to the one-process plain step at phase 9's limits, and three
   mutants shown to exceed them (the trunk's BatchNorm statistics of each
   rank's cameras alone, the replicated gradients summed over the world,
   no halo rows); the f32 step time through the host-copied collectives
   (no scaling figure); (b) the f32 eval step (TF32 off, 2 rows, O(1) head
   weights), pseudo and geometric with the pallas splat, on the view
   ranks: B1 (2) and B2 (1 geometric) launches counted from 0 around one
   step on each rank, the maps and the decoded outputs held to the
   unsharded model on one device at 1e-4 of each output's scale, and the
   step times; (c) `InferenceServer(devices=[[cuda:0, cuda:0]])`, one
   replica with its cameras split over a row of two devices, at batch 8,
   bf16, uint8 cameras, on phase 4's 19 requests, B1 counted (2 a batch),
   the answers held to one device's at batch 8 at scores 1e-4 and boxes
   1e-3, and the batch latency beside one device's.
18. the directory checkpoint backends (``train.checkpoint.backend: orbax |
   orbax_async``): (a) two rank processes (this script with --ckpt-rank) on
   cuda:0 over gloo laid out as two nodes, ``multi_host`` and
   ``shard_optimizer``, phase 9's small model without LiDAR in float64:
   one step, an ``orbax`` and an ``orbax_async`` checkpoint (the next step
   run while the latter writes), each committed whole with each rank's
   files only its own part (`ZeroOptimizer.gathered` raising meanwhile);
   an async writer
   that keeps references and a commit that does not wait for every rank
   shown to fail those checks; then in a fresh process group each
   checkpoint restored bit for bit and its next step held to the
   uninterrupted one at phase 9's limits; (b) each restored at world 1 in
   this process (every shard read; parameters and each rank's moment slice
   by sha256), its next step held to one process's second step, and a
   restore that skips the re-cut shown to fail; (c) the training CLI at
   full width on phase 11's tree, one epoch under ``orbax``, resumed under
   ``orbax_async`` (restore bit for bit, keep_last, B1 on the resumed
   validation), the time each save blocked the loop and each snapshot
   beside phase 11's msgpack writes, and `InferenceServer` started from
   ``best_model/`` (B1 counted) against the Trainer's eval step on it.

Prints a `kernels` JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import hashlib
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
    PAIR_KEYS,
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
    precompute_culled_pairs_batch,
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
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.checkpoint import msgpack_restore
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import (
    Trainer,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.aot import export_serving_artifact
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    export_jax_variables,
    opt_state_to_jax,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling import (
    device_memory_stats,
    profile_trace,
    trace_files,
    trace_summary,
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
    with torch.no_grad():  # as the encoder's fold cache makes them
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


def b1_encoders(full, g: torch.Generator) -> tuple:
    """Phase 2's point encoders with calibrated seeded weights: the model's
    LiDAR and radar ones, a chain whose widths are multiples of 16 but not of
    B1's weight slabs, one whose widths are not even multiples of 4, and one
    whose f32 N-slabs of 512 and 256 columns end in a partial one.
    Returns them and the random state that phase 2 goes on with."""
    extra = {"chain": (48, 80, 144), "ragged": (32, 50, 64, 96, 66), "wide": (64, 528, 264)}
    encoders = {"lidar": full.lidar_encoder, "radar": full.radar_encoder.shared_radar}
    rng, rng_extra = np.random.RandomState(0), np.random.RandomState(1)
    for name, widths in extra.items():
        enc = PointNetLiDAREncoder(LidarEncoderSpec(mlp_layers=widths)).eval()
        with torch.no_grad():
            for m in enc.modules():
                if isinstance(m, torch.nn.Linear):
                    m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
        encoders[name] = enc
        if name == "chain":
            calibrate_point_mlp(encoders["lidar"].point_mlp, lidar_points(rng, 2, 4096), g)
            calibrate_point_mlp(encoders["radar"].point_mlp, radar_points(rng, 8, 125), g)
            calibrate_point_mlp(enc.point_mlp, lidar_points(rng, 2, 4096), g)
        else:
            calibrate_point_mlp(enc.point_mlp, lidar_points(rng_extra, 2, 4096), g)
    return encoders, rng


def check_kernel(encoders, rng) -> float:
    """Phase 2: the kernel against its plain version at the serving shapes,
    with O(1) activations and non-zero folded biases, plus ragged LiDAR
    edges of the bf16 tile (N = 1 mod 128, N < 128) and of the f32 tile
    (N = 1 mod 64, N < 64, where the f32 chain takes 64-point tiles), a chain
    whose widths are multiples of 16 but not of the 128-column or the weight
    slabs' rows (4->48->80->144: partial slabs, an FMA first layer), one
    with widths that are not (4->32->50->64->96->66: the FMA loops before,
    between and after a blocked f32 layer) and 4->64->528->264 (blocked f32
    layers of 16 and 8 columns per thread, each ending in a partial
    N-slab). The same comparison must reject
    the plain version with any one layer's bias dropped, and, where every
    row is real, with the zero rows of the dtype's own tile let into the
    max. Returns the largest bf16 error (the serving dtype)."""
    folded = encoders["lidar"].point_mlp.folded()[0]
    lidar = [folded[0].shape[0]] + [w.shape[1] for w in folded]
    tile = pf.kernel_tile_points(torch.bfloat16, lidar)
    tile32 = pf.kernel_tile_points(torch.float32, lidar)
    log(f"  B1 points per tile for the LiDAR chain: bf16 {tile}, f32 {tile32}")
    both, f32 = (torch.float32, torch.bfloat16), (torch.float32,)
    cases = [
        ("lidar", lidar_points(rng, 8, 35000), both),
        ("lidar-dense", dense_points(rng, 2, 34999, 4, 40.0), both),
        ("lidar-dense", dense_points(rng, 2, 273 * tile + 1, 4, 40.0), both),
        # 40 rows, as radar: at a few hundred GEMM rows cuBLAS sums the f32
        # plain version in another order than the kernel, and on this
        # cancelling cluster either order drifts past the f32 limit
        ("lidar-dense", dense_points(rng, 40, tile - 28, 4, 40.0), both),
        ("radar", radar_points(rng, 40, 125), both),
        ("radar-dense", dense_points(rng, 40, 125, 7, 2.0), both),
        ("chain", lidar_points(rng, 3, 3 * tile + 44), both),
        ("chain-dense", dense_points(rng, 2, 2 * tile + 1, 4, 40.0), both),
        # the f32 tile's own edges
        ("lidar-dense", dense_points(rng, 2, (34000 // tile32) * tile32 + 1, 4, 40.0), f32),
        ("lidar-dense", dense_points(rng, 64, tile32 - 1, 4, 40.0), f32),
        ("ragged", lidar_points(rng, 3, 2 * tile + 44), both),
        ("ragged-dense", dense_points(rng, 40, tile32 + 1, 4, 40.0), both),
        ("wide", lidar_points(rng, 3, 2 * tile + 44), both),
        ("wide-dense", dense_points(rng, 40, tile32 + 1, 4, 40.0), both),
    ]
    return check_b1_cases(encoders, cases)


def check_b1_cases(encoders, cases) -> float:
    """Each (encoder name[-dense], points, dtypes) case: B1 against its plain
    version in both mask_padding values, all-masked rows 0, and the
    comparison shown to reject the plain version with one bias dropped and,
    on dense points, with the tile's zero rows in the max. Raises on any
    failure; returns the largest bf16 error."""
    worst = 0.0
    failures = []
    for name, pts, dtypes in cases:
        enc = encoders[name.split("-")[0]]
        for dtype in dtypes:
            x, w, b = chain_args(enc, pts, dtype, "cuda")
            for mask in (False, True):
                got = pf.pointnet_fused(x, w, b, mask)
                want = pf.pointnet_fused_reference(x, w, b, mask)
                s = compare(got, want, dtype)
                log(f"  B1 {name} {tuple(pts.shape)} {dtype} mask={mask}: {fmt(s)}")
                if s["worst"] > 1.0:
                    failures.append(f"B1 disagrees with its plain version: {name} {dtype} mask={mask}")
                if mask and not bool(x[-1].any()) and not torch.all(got[-1] == 0):
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
                own = pf.kernel_tile_points(dtype, [x.shape[2]] + [v.shape[1] for v in w])
                tiled = torch.cat([x, x.new_zeros(x.shape[0], -x.shape[1] % own, x.shape[2])], dim=1)
                mutants[f"tiling rows in the max ({own}-point tile)"] = pf.pointnet_fused_reference(
                    tiled, w, b, False)
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


@torch.inference_mode()  # as the server and the eval step call B1
def time_kernel(encoder, points: np.ndarray, dtype=torch.bfloat16) -> dict:
    """Phase 5 (bf16) and 13f (f32): the kernel (median, min and max of 3
    timings of 20 launches each through the wrapper, which calls the custom
    op; the ctypes launch the op wraps, median of 3; achieved TFLOP/s and
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
    direct = sorted(time_ms(lambda: pf._launch(x, w, b, False)) for _ in range(3))
    return {
        "ms": runs[1], "ms_min": runs[0], "ms_max": runs[2], "ctypes_ms": direct[1],
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
    moved to the next window, and the second half of the entries of row 0's
    longest cell dropped (what losing the part of a cell that later warps
    hold gives)."""
    pi, li, bi = plan
    pads = li < 0
    real = (li[0] >= 0).any(dim=1) & (bi[0] < bi[0].max())
    k = int(torch.nonzero(real)[0])
    shifted = bi.clone()
    shifted[0, k] += 1
    entry_cells = torch.where(li[0] >= 0, bi[0][:, None] * bp.DEFAULT_WINDOW + li[0], -1).reshape(-1)
    longest = int(torch.bincount(entry_cells[entry_cells >= 0]).argmax())
    where = torch.nonzero(entry_cells == longest).reshape(-1)
    halved_pi, halved_li = pi.clone(), li.clone()
    halved_pi[0].view(-1)[where[len(where) // 2:]] = n_points
    halved_li[0].view(-1)[where[len(where) // 2:]] = -1
    return {
        "pads gather a real row": [torch.where(pads, torch.full_like(pi, n_points - 1), pi),
                                   torch.where(pads, torch.zeros_like(li), li), bi],
        "out-of-range points in cell 0": device_plan(np.maximum(cells, 0), num_cells),
        "one chunk shifted a window": [pi, li, shifted],
        "second half of the longest cell dropped": [halved_pi, halved_li, bi],
    }


def has_empty_window(plan: list) -> bool:
    pi, li, bi = (a.cpu().numpy() for a in plan)
    return any(not (li[r][bi[r] == w] >= 0).any() for r in range(len(bi)) for w in np.unique(bi[r]))


def long_cell_cells(rows: int, d: int, hw: int, num_cells: int, seed: int = 12) -> np.ndarray:
    """(rows, d, hw) frustum cells where 30,000 of each row's points fall in
    one cell (1234), beside 500 points in cells just before and after it,
    16,000 spread over the grid and the rest out of range: the cell crosses
    many of a slice block's warp segments."""
    rng = np.random.RandomState(seed)
    ids = np.full((rows, d * hw), -1, np.int32)
    ids[:, :30000] = 1234
    ids[:, 30000:30500] = rng.randint(1200, 1300, (rows, 500))
    ids[:, 40000:] = rng.randint(0, num_cells, (rows, d * hw - 40000))
    return ids.reshape(rows, d, hw)


def check_bev_pools(spec, g: torch.Generator) -> dict:
    """Phase 6: B2 and B3 against their plain versions on ring-calibration
    plans and on plans whose longest cell spans most of a row, and B2 on
    rows too long for the slice kernel's shared memory (B3's sorted kernel);
    every launch is repeated and must give the same bits; the comparison
    must reject each plain-version mutant. Returns the largest error of each
    kernel.

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

    def check_weighted(cells, num_cells, hw, c, dtypes, label):
        rows, d = cells.shape[:2]
        pad = bp.num_cells_padded(num_cells)
        plan = device_plan(cells, num_cells)
        n_points = d * hw
        logits = torch.randn(rows, d, hw, device="cuda", generator=g)
        weights = torch.softmax(logits, dim=1).reshape(rows, -1)
        feats = torch.randn(rows, hw, c, device="cuda", generator=g)
        mutant_plans = plan_mutants(cells, plan, num_cells, n_points)
        for dtype in dtypes:
            f = feats.to(dtype)
            config = bp.weighted_config(f, plan[0].shape[1])
            got = bp.bev_pool_weighted_rows(f, weights, *plan, num_cells, pad)
            if not torch.equal(got, bp.bev_pool_weighted_rows(f, weights, *plan, num_cells, pad)):
                failures.append(f"bev_pool_weighted: two launches differ on {label} {dtype}")
            ref = lambda w=weights, p=plan, x=f: bp.bev_pool_weighted_reference(x, w, *p, num_cells, pad)
            mutants = {"every weight 1": ref(w=torch.ones_like(weights))}
            mutants.update({k: ref(p=v) for k, v in mutant_plans.items()})
            if dtype == torch.bfloat16:
                mutants["weights not rounded to bf16"] = ref(x=f.float())
            kernel = (f"slice kernel, {config['slice_channels']} channels a slice" if config["slice_channels"]
                      else "sorted kernel")
            judge("bev_pool_weighted", f"{rows}x{hw}x{c} {dtype} {label} ({kernel}; bit-identical twice)",
                  got, ref(), ref(x=f.abs()), mutants)
        return cells, plan, n_points

    def check_sorted(cells, plan, num_cells, dtypes, label):
        """B3 on 6 rows of the plans, features per frustum point."""
        pad = bp.num_cells_padded(num_cells)
        plan6, cells6 = [a[:6] for a in plan], cells[:6]
        n_points = cells6[0].size
        pts = torch.randn(6, n_points, c, device="cuda", generator=g)
        mutant_plans = plan_mutants(cells6, plan6, num_cells, n_points)
        for dtype in dtypes:
            x = pts.to(dtype)
            got = bp.bev_pool_rows(x, *plan6, num_cells, pad)
            if not torch.equal(got, bp.bev_pool_rows(x, *plan6, num_cells, pad)):
                failures.append(f"bev_pool_sorted: two launches differ on {label} {dtype}")
            ref = lambda p=plan6, x=x: bp.bev_pool_sorted_reference(x, *p, num_cells, pad)
            mutants = {k: ref(v) for k, v in mutant_plans.items()}
            judge("bev_pool_sorted", f"6x{n_points}x{c} {dtype} {label} (bit-identical twice)", got, ref(),
                  ref(x=x.abs()), mutants)

    for bev, rows in ((50, 48), (100, 6)):
        num_cells = bev * bev
        cells = np.tile(ring_camera_cells(spec.camera.image_size, (bev, bev), d, b.depth_min,
                                          b.depth_max, b.pc_range), (rows // 6, 1, 1, 1))
        dtypes = (torch.float32, torch.bfloat16) if bev == 50 else (torch.float32,)
        cells, plan, n_points = check_weighted(cells, num_cells, hw, c, dtypes, f"{bev}x{bev} cells")
        if bev == 100 and not (num_cells % bp.DEFAULT_WINDOW and has_empty_window(plan)):
            raise AssertionError("the 100x100 case must have an empty window and a ragged last one")
        check_sorted(cells, plan, num_cells, dtypes, f"{bev}x{bev} cells")

    # B2 and B3 where one cell holds most of each row: it spans many warp
    # segments (B2) and many blocks (B3)
    long_cells = long_cell_cells(12, d, hw, 2500)
    real = (long_cells >= 0).sum(axis=(1, 2))
    if not (30000 > real / 4).all():
        raise AssertionError("the long cell must hold over a quarter of each row's entries")
    label = "one cell of 30,000 entries"
    _, long_plan, _ = check_weighted(long_cells, 2500, hw, c, (torch.float32, torch.bfloat16), label)
    check_sorted(long_cells, long_plan, 2500, (torch.float32,), label)
    # B2 on rows of 16,384 pixels: even 16 bytes a pixel exceed a block's
    # shared memory, so the launch takes B3's sorted kernel
    rng = np.random.RandomState(13)
    wide = rng.randint(-1, 900, (2, 2, 16384)).astype(np.int32)
    if bp.weighted_config(torch.empty(2, 16384, 8, device="cuda"), device_plan(wide, 900)[0].shape[1])[
            "slice_channels"]:
        raise AssertionError("rows of 16,384 pixels must take the sorted kernel")
    check_weighted(wide, 900, 16384, 8, (torch.float32, torch.bfloat16), "16,384 pixels")
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
    (f32), and on phase 6's long-cell plans: kernel, plain version, library
    yardstick and the bound, from the bytes and operations this run's plans
    need (plan entries read once, features and weights only where a real
    entry points, output once)."""
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
        # the slice kernel's launch at this shape, and at one sample's 6 rows
        config = bp.weighted_config(rows, plan[0].shape[1])
        rows6, probs6, plan6 = rows[:6], probs[:6], [a[:6] for a in plan]
        config6 = bp.weighted_config(rows6, plan6[0].shape[1])
        out = {"bev_pool_weighted": {
            "ms": time_ms(lambda: bp.bev_pool_weighted_rows(rows, probs, *plan, num_cells, pad)),
            "ms_6_rows": time_ms(lambda: bp.bev_pool_weighted_rows(rows6, probs6, *plan6, num_cells, pad)),
            **config, **{f"{k}_6_rows": v for k, v in config6.items()},
            "plain_ms": time_ms(lambda: bp.bev_pool_weighted_reference(rows, probs, *plan, num_cells, pad), 5),
            "library_ms": time_ms(lambda: lift_splat_matmul_rows(feat, logits, cells, num_cells), 5),
            "shape": f"{x}x{hw}x{c} bf16 features, {x}x{probs.shape[1]} weights, "
                     f"{plan[0].shape[1]}x{plan[0].shape[2]} chunks per row, {num_cells} cells",
            "real_entries": n_real, **plan_stats,
            **bound(plan, n_real * 2, n_pix * c * 2, x * num_cells * c * 4, 2 * n_real * c),
        }}

        # B3: 6 rows of per-point f32 features on the first 6 rows' plans,
        # then on phase 6's long-cell plans (30,000 entries of a row in one cell)
        plan6 = [a[:6] for a in plan]
        n_points = probs.shape[1]
        pts = torch.randn(6, n_points, c, device="cuda", generator=g)
        cells6 = cells[:6].long()
        dest = (torch.where(cells6 < 0, torch.full_like(cells6, num_cells), cells6)
                + torch.arange(6, device="cuda")[:, None] * (num_cells + 1)).reshape(-1)
        src = pts.reshape(-1, c)

        def sorted_run(p):
            """B3's launch, its split (real entries of the busiest warp over
            its row's mean) and its bound on plans `p`."""
            real = p[1] >= 0
            n_real = int(real.sum())
            entries = bp.sorted_segments(pts, *p, num_cells).float()
            return {
                **bp.sorted_config(pts, *p[0].shape[1:]),
                "busiest_warp_share": float((entries.amax(1) / entries.mean(1)).max()),
                "real_entries": n_real,
                **bound(p, 0, n_real * c * 4, 6 * num_cells * c * 4, n_real * c),
            }

        long_plan = device_plan(long_cell_cells(6, spec.bev.depth_bins, hw, num_cells), num_cells)
        long_run = sorted_run(long_plan)
        out["bev_pool_sorted"] = {
            "ms": time_ms(lambda: bp.bev_pool_rows(pts, *plan6, num_cells, pad)),
            "device_ms": graph_ms(lambda: bp.bev_pool_rows(pts, *plan6, num_cells, pad)),
            "plain_ms": time_ms(lambda: bp.bev_pool_sorted_reference(pts, *plan6, num_cells, pad), 5),
            "library_ms": time_ms(lambda: torch.zeros(6 * (num_cells + 1), c, device="cuda").index_add_(
                0, dest, src)),
            "shape": f"6x{n_points}x{c} f32, {num_cells} cells",
            **sorted_run(plan6),
            "long_cell_ms": time_ms(lambda: bp.bev_pool_rows(pts, *long_plan, num_cells, pad)),
            "long_cell_device_ms": graph_ms(lambda: bp.bev_pool_rows(pts, *long_plan, num_cells, pad)),
            "long_cell_bound_ms": long_run["bound_ms"],
            "long_cell_busiest_warp_share": long_run["busiest_warp_share"],
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


def small_train_checks(cfg, name: str, plans=None, n_steps: int = 2, mutant: bool = True) -> dict:
    """Phase 9's check of `n_steps` small train steps of `cfg` on the card
    (float64, then f32 with the CPU's sides of every tie) against the CPU's
    float64 steps, each from the CPU's state before it; `plans` go into
    every batch; with `mutant`, the f32 check must reject a step whose loss
    reads bf16 predictions. Returns the worst ratio to each limit."""
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
    batches = [train_batch(spec, rng, 2, 16, 5, plans) for _ in range(n_steps)]
    # cameras normalized in float64 on the host: the uint8 wire normalized
    # in f32 on each device differs by an ulp here and there
    batches = [dict(b, camera_imgs=(b["camera_imgs"] / 255.0 - IMAGENET_MEAN.astype(np.float64))
                    / IMAGENET_STD.astype(np.float64)) for b in batches]
    cpu_steps = []
    for b in batches:
        start = cpu_steps[-1] if cpu_steps else {"state": state0, "adamw": None}
        cpu_steps.append(TrainRun(spec, compat, ts, start["state"], "cpu", torch.float64, start["adamw"])(b))

    def starts(i):
        return (state0, None, None) if i == 0 else (cpu_steps[i - 1]["state"], cpu_steps[i - 1]["adamw"],
                                                    cpu_steps[i - 1]["mu"])

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
    out = {"float64": worst, "f32": f32_worst, "f32_ties_across": sum(t.flips for t in ties),
           "f32_tie_share": share}
    if mutant:
        # a wrong f32 step: the loss reads bf16-rounded predictions (the
        # forward, and so the sides of its ties, are step 1's)
        bad = TrainRun(spec, compat, ts, state0, "cuda", torch.float32)
        loss = bad.step.loss
        bad.step.loss = lambda preds, batch: loss({k: v.bfloat16() for k, v in preds.items()}, batch)
        got = bad(batches[0])
        # the lambda refers back to the step: without this the cycle would
        # keep the model and its AdamW state on the card into phase 10
        del bad.step.loss
        mutant_worst, failures = step_errors(got, want1, None, lr, f"{name} bf16-loss mutant", 1e-4)
        if not failures:
            raise AssertionError(f"{name}: the f32 check passed a step whose loss read bf16 predictions")
        out["bf16_loss_mutant"] = mutant_worst
    log(f"  small train {name}: worst share of each limit " + json.dumps(out))
    return out


def check_small_train(config) -> dict:
    """Phase 9. Returns the worst ratio to each limit, per camera-to-BEV and
    dtype, the ReLU inputs replayed across 0 and the rejected mutant's worst
    ratio."""
    counters = (pf.pointnet_fused, bp.bev_pool_weighted_rows)
    launches = [k.launches for k in counters]
    out = {}
    for name, base in (("pseudo", config), ("geometric", geometric_config(config))):
        cfg = small_train_config(base)
        plans = camera_plan_inputs(DetectorSpec.from_config(cfg)) if name == "geometric" else None
        out[name] = small_train_checks(cfg, name, plans)
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
        moved, _, _ = train_loop._on_device(step.model, batch, step.device, targets=True)
        preds = step.forward(moved)
        ev[1].record()
        losses = step.loss(preds, moved)
        ev[2].record()
        grads = step.gradients(losses["total_loss"])
        ev[3].record()
        step.update(losses, grads)
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            ms[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v)) for k, v in ms.items()}


def train_full_width(config, label: str = "", extra=None) -> dict:
    """Phase 10 (and 13c for the variants, 14c for the culled splat):
    make_train_step on base.yaml at full width, batch 4, in f32 and with
    mixed_precision (bf16 autocast); `extra` goes into every sample."""
    spec, compat = DetectorSpec.from_config(config), CompatFlags.from_config(config)
    ts = TrainSpec.from_config(config)
    rng = np.random.RandomState(9)
    batch = train_batch(spec, rng, ts.batch_size, ts.max_objects, 40, extra)
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


def matrix_quat(m: np.ndarray) -> list:
    """(3, 3) rotation -> unit quaternion [w, x, y, z] (nuScenes order)."""
    t = np.trace(m)
    if t > 0:
        r = np.sqrt(t + 1.0) * 2
        q = [0.25 * r, (m[2, 1] - m[1, 2]) / r, (m[0, 2] - m[2, 0]) / r, (m[1, 0] - m[0, 1]) / r]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        r = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / r, 0.25 * r, (m[0, 1] + m[1, 0]) / r, (m[0, 2] + m[2, 0]) / r]
    elif m[1, 1] > m[2, 2]:
        r = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / r, (m[0, 1] + m[1, 0]) / r, 0.25 * r, (m[1, 2] + m[2, 1]) / r]
    else:
        r = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / r, (m[0, 2] + m[2, 0]) / r, (m[1, 2] + m[2, 1]) / r, 0.25 * r]
    return [float(v) for v in q]


def _yaw(a: float) -> np.ndarray:
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])


def ring_calibrate_infos(root: Path, splits, seed: int = 0) -> None:
    """Give the infos of `splits` a nuScenes-like calibration: six cameras
    every 60 degrees around the car (f = 1260 at the native 1600x900, yaw
    and mount jittered by at most 0.01 rad and 2 cm per scene), the LiDAR
    0.9 m forward and 1.8 m up. The synthetic infos' identity intrinsics
    put almost no frustum point on the BEV grid."""
    rng = np.random.RandomState(seed)
    base = np.array([[0, 0, 1.0], [-1.0, 0, 0], [0, -1.0, 0]])  # z-forward camera -> x-forward
    scenes = {}
    for split in splits:
        path = root / f"nuscenes_infos_{split}.pkl"
        data = pickle.loads(path.read_bytes())
        for info in data["infos"]:
            if info["scene_token"] not in scenes:
                scenes[info["scene_token"]] = {
                    name: {"camera_intrinsic": [[1260.0, 0, 815.0], [0, 1260.0, 452.0], [0, 0, 1]],
                           "rotation": matrix_quat(_yaw(k * np.pi / 3 + rng.uniform(-0.01, 0.01)) @ base),
                           "translation": (np.array([np.cos(k * np.pi / 3), 0.5 * np.sin(k * np.pi / 3), 1.5])
                                           + rng.uniform(-0.02, 0.02, 3)).tolist()}
                    for k, name in enumerate(info["cams"])}
            for name, cam in info["cams"].items():
                cam["calibrated_sensor"] = dict(scenes[info["scene_token"]][name])
            info["lidar_calibrated_sensor"] = {"rotation": [1.0, 0, 0, 0], "translation": [0.9, 0.0, 1.8]}
        path.write_bytes(pickle.dumps(data))


def write_radar_pcd(path, pts) -> None:
    """A binary nuScenes-style radar .pcd of (N, 6) [x, y, z, vx, vy, rcs]
    points, with an integer field between them as the real files have."""
    n = len(pts)
    fields = [("x", "F", 4), ("y", "F", 4), ("z", "F", 4), ("id", "I", 2), ("rcs", "F", 4),
              ("vx", "F", 4), ("vy", "F", 4)]
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format", "VERSION 0.7",
        "FIELDS " + " ".join(f[0] for f in fields), "SIZE " + " ".join(str(f[2]) for f in fields),
        "TYPE " + " ".join(f[1] for f in fields), "COUNT " + " ".join("1" for _ in fields),
        f"WIDTH {n}", "HEIGHT 1", "VIEWPOINT 0 0 0 1 0 0 0", f"POINTS {n}", "DATA binary",
    ]) + "\n"
    rec = np.zeros(n, np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"), ("id", "i2"), ("rcs", "f4"),
                                ("vx", "f4"), ("vy", "f4")]))
    for i, name in enumerate(("x", "y", "z", "vx", "vy", "rcs")):
        rec[name] = pts[:, i]
    rec["id"] = np.arange(n)
    Path(path).write_bytes(header.encode() + rec.tobytes())


def add_sweeps(root: Path, splits, lidar_points: int, radar_points: int, seed: int = 0) -> None:
    """Give every info of `splits` what multi-sweep loading reads: one prior
    LiDAR sweep (a .bin of `lidar_points` five-float points, 0.05 s older,
    the ego 0.5 m behind and turned 0.02 rad) and, per radar, its key-frame
    .pcd of `radar_points` returns, its pose, and one prior sweep (.pcd,
    0.07 s older, the ego 0.7 m behind and turned 0.03 rad)."""
    rng = np.random.RandomState(seed)
    identity = {"translation": [0.0, 0.0, 0.0], "rotation": [1.0, 0.0, 0.0, 0.0]}

    def pose(back, yaw):
        return {"translation": [-back, 0.1, 0.0], "rotation": matrix_quat(_yaw(yaw))}

    def radar_cloud():
        pts = rng.randn(radar_points, 6).astype(np.float32) * [20, 20, 1, 5, 5, 10]
        pts[:, 0] = np.abs(pts[:, 0]) + 1.0  # in front of the sensor
        return pts.astype(np.float32)

    for split in splits:
        path = root / f"nuscenes_infos_{split}.pkl"
        data = pickle.loads(path.read_bytes())
        for info in data["infos"]:
            sweep = root / f"{info['token']}_lidar_sweep1.bin"
            cloud = np.empty((lidar_points, 5), np.float32)
            cloud[:, :2] = rng.uniform(-50.0, 50.0, (lidar_points, 2))
            cloud[:, 2] = rng.uniform(-4.0, 2.0, lidar_points)
            cloud[:, 3] = rng.uniform(0.0, 1.0, lidar_points)
            cloud[:, 4] = rng.uniform(0.0, 2.9, lidar_points)
            cloud.tofile(sweep)
            info["lidar_pose"] = dict(identity)
            info["sweeps"] = [{"lidar_path": str(sweep), "pose": pose(0.5, 0.02),
                               "calib": info["lidar_calibrated_sensor"], "time_lag_s": 0.05}]
            for name, entry in info["radars"].items():
                write_radar_pcd(root / entry["filename"], radar_cloud())
                prior = root / f"{info['token']}_{name}_sweep1.pcd"
                write_radar_pcd(prior, radar_cloud())
                entry["pose"] = dict(identity)
                entry["sweeps"] = [{"path": str(prior), "pose": pose(0.7, 0.03),
                                    "calib": entry["calibrated_sensor"], "time_lag_s": 0.07}]
        path.write_bytes(pickle.dumps(data))


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
            if name.endswith("checkpoint"):  # a background write may not be there yet
                entry["bytes"] = dir_size(Path(args[0])) if Path(args[0]).exists() else None
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


def serve_cli_drain(tmp: Path, sample: dict, timeout_s: float = 180.0, extra_args=()) -> dict:
    """The serve CLI in a subprocess (seeded weights, batch 2, and
    `extra_args`): a request, then SIGTERM with a second one in its 1 s
    coalescing window; both must be answered and the process must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.serve", "--config", "configs/base.yaml", "--port", "0",
         "--batch-size", "2", "--max-delay-ms", "1000", *extra_args],
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


def b1_f32_yardstick(encoders, rng) -> dict:
    """13f: B1's f32 path against the cuBLAS chain in f32 (TF32 off) at the
    engine's LiDAR 1x35000x4 and radar 5x125x7 and an eval batch's 4x35000x4
    and 20x125x7, real points in every sample."""
    out = {}
    for b in (1, 4):
        out[f"lidar_{b}x35000"] = time_kernel(
            encoders["lidar"], lidar_points(rng, b + 1, 35000)[:b], torch.float32)
    for b in (5, 20):
        out[f"radar_{b}x125"] = time_kernel(
            encoders["radar"], radar_points(rng, b + 1, 125)[:b], torch.float32)
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
    out["b1_f32"] = b1_f32_yardstick(encoders, rng)
    for shape, t in out["b1_f32"].items():
        log(f"  B1 f32 {shape}: {t['ms']:.4f} ms median of 3 ({t['ms_min']:.4f}-{t['ms_max']:.4f}), "
            f"{t['tflops']:.1f} TFLOP/s, {100 * t['bound_share']:.1f}% of the bound ({t['bound_ms']:.4f} ms); device alone "
            f"{t['device_ms']:.4f} ms; cuBLAS chain (TF32 off) {t['library_ms']:.4f} ms; plain "
            f"{t['plain_ms']:.4f} ms [{where}]")
    return out


def sweep_points(rng: np.random.RandomState, b: int, n: int) -> np.ndarray:
    """`lidar_points` with the fifth, time-lag channel of num_sweeps 2:
    0 or 0.05 s on real points, 0 on padding."""
    pts = lidar_points(rng, b, n)
    dt = np.where(pts.any(axis=2) & (rng.rand(b, n) < 0.5), 0.05, 0.0).astype(np.float32)
    return np.concatenate([pts, dt[..., None]], axis=2)


def b1_five_channels(g: torch.Generator, rng: np.random.RandomState) -> tuple:
    """14a: B1 on the multi-sweep LiDAR chain 5->64->...->1024 against its
    plain version (phase 2's comparison, calibration, limits and mutants):
    8x35000x5 in bf16 and f32 (its last sample all padding), 4x and
    1x35000x5 in f32, ragged N = 34,999, and dense clusters (f32) at
    34,999 points and one past a multiple of the f32 tile. On 40 dense
    rows one past the f32 tile, where cuBLAS sums the plain version in
    another order than at the rows above, the kernel must be no further
    from a float64 chain than the plain version is. Then its times at
    8x35000x5 bf16 and 4x35000x5 f32 beside the plain version, the cuBLAS
    chain and the bound. Returns the largest bf16 error, the cancelling
    cluster's errors and the times."""
    enc = PointNetLiDAREncoder(LidarEncoderSpec(input_channels=5)).eval()
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
    calibrate_point_mlp(enc.point_mlp, sweep_points(rng, 2, 4096), g)
    widths = [5, *enc.spec.mlp_layers]
    tile32 = pf.kernel_tile_points(torch.float32, widths)
    log(f"  B1 points per tile for the 5-channel chain: bf16 {pf.kernel_tile_points(torch.bfloat16, widths)}, "
        f"f32 {tile32}")
    both, f32 = (torch.float32, torch.bfloat16), (torch.float32,)
    err = check_b1_cases({"lidar5": enc}, [
        ("lidar5", sweep_points(rng, 8, 35000), both),
        ("lidar5", sweep_points(rng, 5, 35000)[:4], f32),
        ("lidar5", sweep_points(rng, 2, 35000)[:1], f32),
        ("lidar5", sweep_points(rng, 3, 34999), both),
        ("lidar5-dense", dense_points(rng, 2, 34999, 5, 40.0), f32),
        ("lidar5-dense", dense_points(rng, 2, (34000 // tile32) * tile32 + 1, 5, 40.0), f32),
    ])
    x, w, b = chain_args(enc, dense_points(rng, 40, tile32 + 1, 5, 40.0), torch.float32, "cuda")
    exact = x.double()
    for wi, bi in zip(w, b):
        exact = torch.relu(exact @ wi.double() + bi.double())
    exact = exact.amax(dim=1)
    cluster = {"kernel_vs_float64": float((pf.pointnet_fused(x, w, b) - exact).abs().max()),
               "plain_vs_float64": float((pf.pointnet_fused_reference(x, w, b) - exact).abs().max()),
               "kernel_vs_plain": compare(pf.pointnet_fused(x, w, b), pf.pointnet_fused_reference(x, w, b),
                                          torch.float32)["worst"]}
    log(f"  B1 lidar5-dense {tuple(x.shape)} f32 against a float64 chain: kernel {cluster['kernel_vs_float64']:.3g}, "
        f"plain version {cluster['plain_vs_float64']:.3g} (kernel against plain: {cluster['kernel_vs_plain']:.3g} "
        f"of the limit)")
    if not cluster["kernel_vs_float64"] <= cluster["plain_vs_float64"]:
        raise AssertionError(f"B1 on a cancelling cluster is further from float64 than its plain version: {cluster}")
    times = {"lidar_8x35000x5_bf16": time_kernel(enc, sweep_points(rng, 8, 35000)),
             "lidar_4x35000x5_f32": time_kernel(enc, sweep_points(rng, 5, 35000)[:4], torch.float32)}
    for what, t in times.items():
        log(f"  B1 {what}: {t['ms']:.4f} ms median of 3 ({t['ms_min']:.4f}-{t['ms_max']:.4f}), device alone "
            f"{t['device_ms']:.4f}, {t['tflops']:.1f} TFLOP/s, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"plain {t['plain_ms']:.4f}, cuBLAS chain {t['library_ms']:.4f} ms [{card()}]")
    return err, cluster, times


def splat_config(config, mode: str) -> dict:
    cfg = copy.deepcopy(config)
    cfg["model"]["bev_fusion"].update(camera_to_bev="geometric", splat_mode=mode)
    return cfg


def culled_plan_inputs(spec) -> tuple:
    """One sample's culled pair plans on the ring calibration, under the
    dataset's keys (capacities 5 % over the largest camera's counts, as the
    dataset sizes them), and (T_cull, U_cap)."""
    b = spec.bev
    cells = ring_camera_cells(spec.camera.image_size, (b.bev_h, b.bev_w), b.depth_bins,
                              b.depth_min, b.depth_max, b.pc_range)
    hw = cells.shape[-2] * cells.shape[-1]
    plans, caps = precompute_culled_pairs_batch(cells, hw, b.bev_h * b.bev_w, headroom=1.05)
    return {f"camera_{k}": plans[k] for k in PAIR_KEYS}, caps


def splat_plans(spec) -> dict:
    """What the dataset ships for the spec's splat mode: pair plans under
    culled, else the frustum cells."""
    if spec.bev.splat_mode == "culled":
        return culled_plan_inputs(spec)[0]
    return {"camera_cells": camera_plan_inputs(spec)["camera_cells"]}


def small_splat_checks(config) -> dict:
    """14b: GeometricCameraBEV in scatter and culled modes (culled on pair
    plans alone), seeded weights with random BatchNorm statistics, card
    against CPU in f32 (TF32 off), eval and train mode, within 1e-4 of each
    output's scale; two launches of the culled splat give the same result
    within 1e-5 (its scatter adds each (cell, pixel) once)."""
    out = {}
    for mode in ("scatter", "culled"):
        spec = DetectorSpec.from_config(small_train_config(splat_config(config, mode)))
        g = torch.Generator().manual_seed(14)
        cpu = randomize_stats(port_fusion.GeometricCameraBEV(spec.bev, spec.camera.out_channels), g)
        with torch.no_grad():
            for m in cpu.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
        gpu = copy.deepcopy(cpu).cuda()
        h, w = spec.camera.image_size
        feats = torch.randn(2, 6, spec.camera.out_channels, h // 16, w // 16, generator=g)
        plans = {k: torch.from_numpy(np.stack([v] * 2)) for k, v in splat_plans(spec).items()}

        def run(module, device):
            kw = {k: v.to(device) for k, v in plans.items()}
            pairs = tuple(kw[f"camera_{k}"] for k in PAIR_KEYS) if mode == "culled" else None
            with torch.no_grad():
                return module(feats.to(device), kw.get("camera_cells"), None, pairs)

        for train in (False, True):
            want = run(cpu.train(train), "cpu")
            got = run(gpu.train(train), "cuda")
            again = run(gpu.train(train), "cuda")
            scale = float(want.abs().max())
            err = float((got.cpu() - want).abs().max())
            repeat = float((got - again).abs().max())
            key = f"{mode}_{'train' if train else 'eval'}"
            out[key] = {"max_abs_err": err, "scale": scale, "repeat_err": repeat}
            log(f"  GeometricCameraBEV {key}: max_abs_err {err:.3g} (scale {scale:.3g}); two launches "
                f"differ by {repeat:.3g}")
            if not (err <= 1e-4 * scale and repeat <= 1e-5 * scale):
                raise AssertionError(f"GeometricCameraBEV {key}: card and CPU disagree")
    return out


def splat_eval_step(config, mode: str, pallas_ms: float) -> dict:
    """14c: make_eval_step on base.yaml with the geometric camera-to-BEV and
    `mode`'s splat at full width, bf16, batch 8, uint8 cameras, 3 batches
    after a warm-up, launch counters zeroed just before and read after;
    logged beside phase 7's pallas step (`pallas_ms`)."""
    cfg = splat_config(config, mode)
    spec, compat = DetectorSpec.from_config(cfg), CompatFlags.from_config(cfg)
    g = torch.Generator().manual_seed(4)
    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding)
    model = model.init_weights(g).to("cuda", torch.bfloat16)
    step = make_eval_step(model, compat, max_detections=spec.centernet.max_detections, eval_path_decode=True)
    rng = np.random.RandomState(5)
    plans = splat_plans(spec)
    h, w = spec.camera.image_size
    batches = [collate_fn([{
        "camera_imgs": rng.randint(0, 256, (6, h, w, 3), np.uint8),
        "lidar_points": lidar_points(rng, 2, spec.lidar.max_points)[0],
        "radar_points": radar_points(rng, spec.radar.num_radars, spec.radar.max_points_per_sensor),
        **plans,
    } for _ in range(8)]) for _ in range(3)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step(batches[0])
    torch.cuda.synchronize()
    counters = (pf.pointnet_fused, bp.bev_pool_weighted_rows, bp.bev_pool_rows)
    for k in counters:
        k.launches = 0
    times = []
    for batch in batches:
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if out["boxes"].shape != (8, spec.centernet.max_detections, 7) or not all(
                torch.isfinite(out[n]).all() for n in ("boxes", "scores", "velocities")):
            raise AssertionError(f"{mode} eval step: bad output")
    launches = {k.__name__: k.launches for k in counters}
    if launches != {"pointnet_fused": 2 * len(batches), "bev_pool_weighted_rows": 0, "bev_pool_rows": 0}:
        raise AssertionError(f"{mode} eval step launches {launches}: want B1 2 per batch, B2 and B3 none")
    ms = float(np.median(times))
    res = {"batch_ms": times, "batch_ms_p50": ms, "samples_per_s": 8 / ms * 1e3, "launches": launches,
           "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "phase7_pallas_ms": pallas_ms}
    if mode == "culled":
        _, (res["t_cull"], res["u_cap"]) = culled_plan_inputs(spec)
        b = spec.bev
        res["frustum_points"] = b.depth_bins * (h // 16) * (w // 16)
    log(f"  {mode} eval step: {ms:.2f} ms per batch of 8 (p50 of 3; phase 7's pallas step {pallas_ms:.2f}), "
        f"{res['samples_per_s']:.1f} samples/s, "
        f"{res['max_memory_gib']:.2f} GiB peak; launches {launches}"
        + (f"; T_cull {res['t_cull']}, U_cap {res['u_cap']} of {res['frustum_points']} frustum points a camera"
           if mode == "culled" else "") + f" [{card()}]")
    del model, step
    torch.cuda.empty_cache()
    return res


def camera_bn_stats(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.camera_encoder.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def training_data_options(config, tmp: Path) -> dict:
    """14d: `train_detect.main` at full width on a phase-11-style tree (8
    train and 4 val samples of six 1600x900 JPEGs and a 60,000-point LiDAR
    bin) whose infos carry one prior LiDAR sweep and, per radar, a key-frame
    .pcd and one prior sweep, with compat.skip_augmentation false,
    num_sweeps 2, radar_num_sweeps 2, compat.random_radar_points false and
    camera_encoder.freeze_bn true: one epoch, then a resume into a second.
    The restore must be bit for bit, validation must launch B1 on the
    5-wide LiDAR chain twice per batch and train epochs never, the camera
    BatchNorm statistics must keep their init."""
    data = tmp / "sweeps"
    out = {"data": write_nuscenes_tree(data, config, train=8, val=4, n_points=60_000)}
    t = time.perf_counter()
    add_sweeps(data, ("train", "val"), lidar_points=60_000, radar_points=125, seed=12)
    out["sweeps_write_s"] = time.perf_counter() - t
    cfg = copy.deepcopy(config)
    cfg["dataset"].update(data_root=str(data), num_sweeps=2, radar_num_sweeps=2)
    cfg["compat"].update(skip_augmentation=False, random_radar_points=False)
    cfg["model"]["camera_encoder"]["freeze_bn"] = True
    cfg["train"]["checkpoint"].update(save_dir=str(tmp / "sweep_checkpoints"), save_interval=1)
    cfg["train"]["logging"]["log_dir"] = str(tmp / "sweep_logs")
    cfg["train"]["num_epochs"] = 1
    ts = TrainSpec.from_config(cfg)

    train_ds = NuScenesDataset(split="train", config=cfg, seed=ts.seed, emit_uint8=True)
    sample = train_ds[0]
    if sample["lidar_points"].shape != (35000, 5) or set(np.unique(sample["lidar_points"][:, 4])) != {
            0.0, np.float32(0.05)}:
        raise AssertionError("the LiDAR points are not both sweeps with their time lags")
    if set(np.unique(sample["radar_points"][..., 6])) != {0.0, np.float32(0.07)}:
        raise AssertionError("the radar points are not both sweeps with their time lags")
    loader_ms = []
    t = time.perf_counter()
    for _ in DataLoader(train_ds, batch_size=ts.batch_size, prefetch=0):
        loader_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        record = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with traced_trainer(record):
            first = train_detect.main(config=cfg, device="cuda")
            saved = trainer_state(first)
            width = first.model.lidar_encoder.point_mlp.mlp1.in_features
            stats = [camera_bn_stats(first.model)]
            del first
            torch.cuda.empty_cache()
            cfg2 = copy.deepcopy(cfg)
            cfg2["train"]["num_epochs"] = 2
            cfg2["train"]["resume"]["enable"] = True
            second = train_detect.main(config=cfg2, device="cuda")
            stats.append(camera_bn_stats(second.model))
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del second
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    if width != 5:
        raise AssertionError(f"the LiDAR encoder takes {width} channels, not the data's 5")
    for st in stats:
        for k, v in st.items():
            if not bool((v == (0.0 if k.endswith("mean") else 1.0)).all()):
                raise AssertionError(f"freeze_bn: camera statistic {k} moved in training")
    restored = record["load_checkpoint"]
    if len(restored) != 1 or restored[0]["epoch"] != 0:
        raise AssertionError(f"the resumed run did not restore epoch 0: {restored}")
    n_arrays = assert_states_equal(restored[0]["state"], saved)
    epochs, evals = record["train_one_epoch"], record["evaluate"]
    val_batches = (4 + ts.batch_size - 1) // ts.batch_size
    if any(e["b1_launches"] for e in epochs) or any(e["b1_launches"] != 2 * val_batches for e in evals):
        raise AssertionError(f"B1 launches: train epochs {[e['b1_launches'] for e in epochs]}, "
                             f"validations {[e['b1_launches'] for e in evals]} (want 0 and {2 * val_batches})")
    log_lines = [json.loads(x) for x in (tmp / "sweep_logs" / "train_log.jsonl").read_text().splitlines()]
    losses = [ln["total_loss"] for ln in log_lines]
    steps_per_epoch = 8 // ts.batch_size
    if len(losses) != 2 * steps_per_epoch or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    step_s = [sum(ln["step_seconds"] for ln in log_lines[i * steps_per_epoch:(i + 1) * steps_per_epoch])
              for i in range(2)]
    out.update({
        "epoch_s": [e["s"] for e in epochs], "step_s_per_epoch": step_s,
        "loader_ms_per_batch": loader_ms, "validation_s": [e["s"] for e in evals],
        "b1_launches_per_validation": [e["b1_launches"] for e in evals], "lidar_width": width,
        "restored_arrays_bit_exact": n_arrays, "losses": losses,
    })
    log(f"  epochs {', '.join(f'{x:.2f}' for x in out['epoch_s'])} s, of which train steps "
        f"{', '.join(f'{x:.2f}' for x in step_s)} s; loader {', '.join(f'{x:.0f}' for x in loader_ms)} ms per "
        f"batch of {ts.batch_size} (one thread); validation {', '.join(f'{x:.2f}' for x in out['validation_s'])} s "
        f"with B1 {out['b1_launches_per_validation']} launches on the 5-wide chain; restore bit-exact over "
        f"{n_arrays} arrays; camera BN statistics unchanged; peak {out['max_memory_gib']:.2f} GiB [{card()}]")
    return out


def training_options(config, g: torch.Generator, rng: np.random.RandomState, tmp: Path,
                     pallas_ms: float) -> dict:
    """Phase 14; `pallas_ms` is phase 7's eval step, logged beside 14c's."""
    out = {}
    log("  14a: B1 at C_in = 5 (multi-sweep LiDAR) against its plain version (TF32 off)")
    torch.backends.cudnn.allow_tf32 = False
    out["b1_c_in5_max_err"], out["b1_c_in5_cluster"], out["b1_c_in5"] = b1_five_channels(g, rng)

    log("  14b: the scatter and culled splats, a culled train step and an augmented one, card vs CPU")
    out["small_splats"] = small_splat_checks(config)
    counters = (pf.pointnet_fused, bp.bev_pool_weighted_rows)
    launches = [k.launches for k in counters]
    culled = small_train_config(splat_config(config, "culled"))
    out["small_train_culled"] = small_train_checks(
        culled, "culled", splat_plans(DetectorSpec.from_config(culled)), n_steps=1, mutant=False)
    augmented = small_train_config(config)
    augmented["compat"]["skip_augmentation"] = False
    out["small_train_augmented"] = small_train_checks(augmented, "augmented", n_steps=1, mutant=False)
    if [k.launches for k in counters] != launches:
        raise AssertionError("a train step launched B1 or B2")

    log("  14c: full width, geometric culled and scatter splats (bf16 eval at batch 8; train at batch 4 "
        "with augmentation, geometry frozen)")
    torch.backends.cudnn.allow_tf32 = True  # the eval steps run in bf16 regardless
    out["culled_eval"] = splat_eval_step(config, "culled", pallas_ms)
    torch.backends.cudnn.allow_tf32 = False
    culled_train = splat_config(config, "culled")
    culled_train["compat"]["skip_augmentation"] = False
    out["culled_train"] = train_full_width(culled_train, "culled, augmented: ",
                                           splat_plans(DetectorSpec.from_config(culled_train)))
    torch.backends.cudnn.allow_tf32 = True
    out["scatter_eval"] = splat_eval_step(config, "scatter", pallas_ms)

    log("  14d: train_detect.main with the training-data options (f32, TF32 off)")
    torch.backends.cudnn.allow_tf32 = False
    out["training_data_options"] = training_data_options(config, tmp)
    return out


# ---------------------------------------------------------------------------
# Phase 15: AOT serving artifacts, profiling and the compile cache
# ---------------------------------------------------------------------------


def served_requests(server, samples) -> tuple:
    """Phase 4's 19 requests (16, then a partial batch of 3) on a started
    server, the B1 launch counter zeroed just before and read just after."""
    pf.pointnet_fused.launches = 0
    futures = [server.submit(samples[i % 4]) for i in range(16)]
    results = [f.result(timeout=300) for f in futures]
    futures = [server.submit(samples[i % 4]) for i in range(3)]
    results += [f.result(timeout=300) for f in futures]
    launches = pf.pointnet_fused.launches
    check_results(results, 19)
    return results, launches


def detections_agree(got: list, want: list, what: str) -> bool:
    """Each result within the serving tolerances (scores 1e-4, boxes 1e-3,
    labels equal, matched by position); returns whether all bits agree."""
    bit_equal = True
    for i, (g, w) in enumerate(zip(got, want)):
        bit_equal &= all(np.array_equal(g[k], w[k]) for k in w)
        g, w = by_position(g), by_position(w)
        if len(g["scores"]) != len(w["scores"]) or not np.array_equal(g["labels"], w["labels"]) \
                or np.abs(g["scores"] - w["scores"]).max() > 1e-4 \
                or np.abs(g["boxes"] - w["boxes"]).max() > 1e-3:
            raise AssertionError(f"{what}: request {i} differs")
    return bit_equal


def batch_latency_ms(servers: dict, batch, reps: int = 8) -> dict:
    """Median ms of `_run_batch` on each server, the servers in turns."""
    times = {k: [] for k in servers}
    for _ in range(reps):
        for k, server in servers.items():
            t = time.perf_counter()
            server._run_batch(batch)
            times[k].append((time.perf_counter() - t) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def aot_serving(config, tmp: Path) -> tuple:
    """15a; returns the measurements and the live server of weights A
    (stopped, still usable through `_run_batch`) with a uint8 batch."""
    kw = dict(config=config, batch_size=8, max_delay_ms=20.0, score_threshold=0.0, use_bf16=True, fold_bn=True)
    out = {}
    t = time.perf_counter()
    live = InferenceServer(**kw)
    out["live_init_s"] = time.perf_counter() - t
    path = tmp / "serving.aot.npz"
    t = time.perf_counter()
    meta = export_serving_artifact(live, path)
    out["export_s"] = time.perf_counter() - t
    out["artifact_bytes"] = path.stat().st_size
    if meta["signatures"] != ["f32", "u8"] or meta["platforms"] != ["cuda"]:
        raise AssertionError(f"artifact meta {meta}")
    t = time.perf_counter()
    aot = InferenceServer(aot_path=str(path), **kw)
    out["load_s"] = time.perf_counter() - t

    samples = make_samples(live.spec, np.random.RandomState(3), 4)
    answers = {}
    for name, server in (("live", live), ("aot", aot)):
        with server:  # start() warms both wires
            answers[name], launches = served_requests(server, samples)
        out[f"{name}_launches"] = launches
    if out["aot_launches"] <= 0:
        raise AssertionError("the AOT server never launched the B1 kernel")
    out["bit_equal"] = detections_agree(answers["aot"], answers["live"], "AOT server vs live server (weights A)")
    u8_batch = [samples[0]] * 8
    out["batch_latency_ms"] = batch_latency_ms({"live": live, "aot": aot}, u8_batch)

    # weights B on the same artifact: served as a live server with B serves
    model_b = MultiModal3DDetector(live.spec).init_weights(torch.Generator().manual_seed(15))
    variables_b = export_jax_variables(randomize_stats(model_b, torch.Generator().manual_seed(16)))
    del model_b
    live_b = InferenceServer(variables=variables_b, **kw)
    aot_b = InferenceServer(variables=variables_b, aot_path=str(path), **kw)
    mixed = samples[:3]  # uint8, float and uint8 rows: the host normalizes the uint8 ones
    for batch, label in ((u8_batch, "uint8"), (mixed, "mixed")):
        want_b, got_b = live_b._run_batch(batch), aot_b._run_batch(batch)
        out[f"weights_b_bit_equal_{label}"] = detections_agree(got_b, want_b, f"AOT vs live server (weights B, {label})")
        want_a = live._run_batch(batch)
        if all(np.array_equal(g["scores"], w["scores"]) for g, w in zip(got_b, want_a)):
            raise AssertionError("the artifact served weights A's answers on a server restored with weights B")
    del live_b, aot_b, aot
    torch.cuda.empty_cache()
    log(f"  AOT artifact: {out['artifact_bytes']} bytes (no weights), export {out['export_s']:.2f} s, load "
        f"{out['load_s']:.2f} s (live server init {out['live_init_s']:.2f} s); 19 requests: B1 launches "
        f"{out['aot_launches']} (live {out['live_launches']}), bit-equal {out['bit_equal']}; weights B bit-equal "
        f"{out['weights_b_bit_equal_uint8']} (uint8) {out['weights_b_bit_equal_mixed']} (mixed); batch latency "
        f"uint8 AOT {out['batch_latency_ms']['aot']:.2f} ms, live {out['batch_latency_ms']['live']:.2f} ms "
        f"(median of 8, in turns) [{card()}]")
    return out, live, u8_batch


def traced(logdir: Path, fn, reps: int = 3) -> dict:
    """`fn` run `reps` times inside `profile_trace(logdir)`, then a
    synchronize; the trace's summary and `device_memory_stats()`."""
    with profile_trace(str(logdir)):
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    files = trace_files(logdir)
    if not files:
        raise AssertionError(f"profile_trace wrote no trace under {logdir}")
    summary = trace_summary(files[-1])
    if summary["kernels"] <= 0:
        raise AssertionError(f"the trace under {logdir} holds no device kernel")
    return dict(summary, trace_bytes=files[-1].stat().st_size, memory=device_memory_stats())


def profiling(config, server, batch, tmp: Path) -> dict:
    """15b: 3 served batches (the server of 15a) and 3 full-width bf16
    mixed-precision train steps (phase 10's) under the profiler."""
    out = {"serve_3_batches": traced(tmp / "profile_serve", lambda: server._run_batch(batch))}
    spec, compat = DetectorSpec.from_config(config), CompatFlags.from_config(config)
    ts = dataclasses.replace(TrainSpec.from_config(config), mixed_precision=True)
    train = train_batch(spec, np.random.RandomState(9), ts.batch_size, ts.max_objects, 40)
    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding).init_weights(
        torch.Generator().manual_seed(10))
    step = make_train_step(model, make_optimizer(ts, compat), ts, compat)
    for _ in range(2):  # warm up as phase 10 does
        step(train)
    torch.cuda.synchronize()
    out["train_3_steps_bf16"] = traced(tmp / "profile_train", lambda: step(train))
    del model, step
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"  {name}: device idle share {r['idle_share']:.4f} of a {r['window_ms']:.2f} ms window "
            f"({r['busy_ms']:.2f} ms under kernels, {r['kernels']} kernels); top 5: "
            + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in r["top"]) + f" [{card()}]")
    log(f"  device_memory_stats: {json.dumps(device_memory_stats())}")
    return out


def profiled_training(tree_config: dict, tmp: Path) -> dict:
    """15c: `debug.profile: true` through `train_detect.main` on phase 11's
    tree, one epoch."""
    cfg = copy.deepcopy(tree_config)
    cfg.setdefault("debug", {})["profile"] = True
    cfg["train"]["num_epochs"] = 1
    cfg["train"]["resume"]["enable"] = False
    cfg["train"]["checkpoint"]["save_dir"] = str(tmp / "profile_checkpoints")
    cfg["train"]["logging"]["log_dir"] = str(tmp / "profile_logs")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t = time.perf_counter()
        train_detect.main(config=cfg, device="cuda")
        seconds = time.perf_counter() - t
    finally:
        os.chdir(cwd)
    files = trace_files(tmp / "profile_logs" / "profile")
    if len(files) != 1:
        raise AssertionError(f"debug.profile left {len(files)} traces under log_dir/profile")
    summary = trace_summary(files[0])
    log(f"  debug.profile: train_detect.main one epoch in {seconds:.1f} s, trace {files[0].name} "
        f"({files[0].stat().st_size} bytes): device idle share {summary['idle_share']:.4f} of the epoch's "
        f"{summary['window_ms']:.1f} ms [{card()}]")
    return {"seconds": seconds, "trace_bytes": files[0].stat().st_size,
            **{k: summary[k] for k in ("window_ms", "busy_ms", "idle_share", "kernels")}}


def aot_cli(tmp: Path, sample: dict) -> dict:
    """15d: the serve CLI exports an artifact (batch 2), then serves from it
    in a subprocess and drains."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    path = tmp / "cli.aot.npz"
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.serve", "--config", "configs/base.yaml", "--batch-size", "2",
         "--export-aot", str(path)],
        capture_output=True, text=True, cwd=str(tmp), env=env, timeout=300,
    )
    export_s = time.perf_counter() - t
    if proc.returncode != 0 or "AOT artifact written to" not in proc.stdout or not path.exists():
        raise AssertionError(f"serve --export-aot failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    drain = serve_cli_drain(tmp, sample, extra_args=("--aot", str(path)))
    log(f"  serve CLI: --export-aot in {export_s:.1f} s; --aot listening after {drain['start_s']:.1f} s, "
        f"SIGTERM with a request in flight: both answered, exit {drain['exit_code']}")
    return {"export_s": export_s, "drain": drain}


def aot_profiling_cache(config, tree_config: dict, tmp: Path) -> dict:
    """Phase 15."""
    out = {}
    torch.backends.cudnn.allow_tf32 = True  # serving and mixed precision, as phases 4 and 10
    out["aot"], server, batch = aot_serving(config, tmp)
    out["profiling"] = profiling(config, server, batch, tmp)
    del server
    torch.cuda.empty_cache()
    out["debug_profile"] = profiled_training(tree_config, tmp)
    out["cli"] = aot_cli(tmp, make_samples(DetectorSpec.from_config(config), np.random.RandomState(4), 1)[0])
    return out


# ---------------------------------------------------------------------------
# phase 16: data parallelism
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def step_record(step, model, losses) -> dict:
    """A step's losses, state and AdamW first moments (host, float64), as
    `TrainRun` records them."""
    copy64 = lambda t: t.detach().to("cpu", torch.float64, copy=True)
    opt = step.optimizer
    if hasattr(opt, "gathered"):  # ZeRO-1: every rank's moments
        opt = opt.gathered()
    return {"losses": {k: float(v) for k, v in losses.items()},
            "state": {k: copy64(v) for k, v in model.state_dict().items()},
            "mu": {n: copy64(opt.adamw.state[p]["exp_avg"]) for n, p in model.named_parameters()}}


def dp_train_step(config, run_spec, group=None, mutant=None, optimizer=None, device=None,
                  dtype=torch.float32, bev_spatial=False):
    """A train step of base.yaml's model (seed 10) in `dtype`, data-parallel
    over `group` when given (its head on BEV row blocks with `bev_spatial`
    and a view axis); `mutant` "bn" takes each rank's BatchNorm statistics
    alone ("num_pos": `mutated_losses`)."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.batch_norm import global_statistics

    spec, compat = DetectorSpec.from_config(config), CompatFlags.from_config(config)
    g = torch.Generator().manual_seed(10)
    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding,
                                 bev_spatial=bev_spatial).init_weights(g).to(dtype)
    step = make_train_step(model, optimizer or make_optimizer(run_spec, compat), run_spec, compat,
                           check_gradients=True, device=device, process_group=group)
    if mutant == "bn":
        global_statistics(model, None)
    return step


@contextlib.contextmanager
def mutated_losses(mutant):
    """Under "num_pos", the focal loss counts each rank's positives alone."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import losses as port_losses

    focal = port_losses.focal_loss
    if mutant == "num_pos":
        port_losses.focal_loss = lambda *a, group=None, **k: focal(*a, **k)
    try:
        yield
    finally:
        port_losses.focal_loss = focal


def snapshot(step) -> dict:
    """A step's model state, AdamW state and counts."""
    return {"model": {k: v.detach().clone() for k, v in step.model.state_dict().items()},
            "adamw": copy.deepcopy(step.optimizer.adamw.state_dict()),
            "updates": step.optimizer.updates, "step": step.step}


def restore(step, snap: dict) -> None:
    step.model.load_state_dict(snap["model"])
    step.optimizer.adamw.load_state_dict(copy.deepcopy(snap["adamw"]))
    step.optimizer.updates, step.step = snap["updates"], snap["step"]


def share_from_rank0(step, updates: int) -> None:
    """Every rank's model and AdamW moments set to rank 0's (broadcast)."""
    tensors = list(step.model.state_dict().values())
    if updates:
        opt = step.optimizer
        for p in opt.params:
            if p not in opt.adamw.state:  # a rank that has not stepped yet
                opt.adamw.state[p] = {"step": torch.tensor(float(updates)), "exp_avg": torch.zeros_like(p),
                                      "exp_avg_sq": torch.zeros_like(p)}
            st = opt.adamw.state[p]
            st["step"].fill_(float(updates))
            tensors += [st["exp_avg"], st["exp_avg_sq"]]
        opt.updates = step.step = updates
    for t in tensors:
        torch.distributed.broadcast(t, src=0)


def lockstep(config, run_spec, batch, n: int, group, device=None, rank: int = 0, dtype=torch.float32,
             bev_spatial=False) -> tuple:
    """`n` steps of the data-parallel step and the plain step (rank 0 only),
    each data-parallel step from the plain step's state before it (phase 9's
    scheme: the runs do not drift apart on rounding). Returns the two runs'
    records (rank 0) and the data-parallel step."""
    plain = dp_train_step(config, run_spec, device=device, dtype=dtype) if rank == 0 else None
    dp = dp_train_step(config, run_spec, group, device=device, dtype=dtype, bev_spatial=bev_spatial)
    got, want = [], []
    for _ in range(n):
        updates = 0
        if plain is not None:
            snap = snapshot(plain)
            restore(dp, snap)
            updates = snap["updates"]
        share_from_rank0(dp, updates if rank == 0 else len(got))
        got.append(step_record(dp, dp.model, dp(batch)))
        if plain is not None:
            want.append(step_record(plain, plain.model, plain(batch)))
    del plain
    return got, want, dp


def steps_agree(got: list, want: list, lr: float, what: str, check: bool = True) -> dict:
    """Phase 9's f32 limits (`step_errors`) on each step of two runs,
    raising on a failure when `check`; returns the worst ratio to each limit
    and, under ``first_moments_top``, the three tensors whose first moments
    come nearest theirs."""
    worst, near = {}, {}
    for i, (g, w) in enumerate(zip(got, want)):
        prev = want[i - 1]["mu"] if i else None
        r, failures = step_errors(g, w, prev, lr, f"{what} step {i + 1}", 1e-4)
        if check and failures:
            raise AssertionError("; ".join(failures))
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in r.items()}
        largest = max(float(v.abs().max()) for v in w["mu"].values())
        for name, m in g["mu"].items():
            top = float(w["mu"][name].abs().max())
            if top >= 1e-9 * largest:  # not a zero-gradient tensor (`step_errors`)
                near[name] = max(near.get(name, 0.0), float((m - w["mu"][name]).abs().max()) / (1e-4 * top))
    return dict(worst, first_moments_top=sorted(near.items(), key=lambda kv: -kv[1])[:3])


def timed_steps(steps: dict, batch, reps: int = 5) -> dict:
    """Median host ms of a step (up to a synchronize) of each of `steps`,
    in turns."""
    times = {k: [] for k in steps}
    for _ in range(reps):
        for k, step in steps.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def dp_world_one(config) -> dict:
    """16a: the process group of one rank over NCCL on cuda:0 and base.yaml
    at batch 4. Three float64 data-parallel steps, each from the plain
    step's state before it, held to the plain step at phase 9's limits;
    then three f32 (TF32 off) and three bf16 mixed-precision steps of each,
    the losses held at 1e-5 (f32) and 2^-7 (bf16) relative and the other
    shares of phase 9's limits reported (two f32 runs differ by both their
    roundings: at full width cuDNN's f32 weight gradients sum ~540,000 terms
    a weight in the trunk, and a data-parallel f32 step came 1.44 of the
    first moments' limit from the float64 step); and the step times side
    by side."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import make_data_group, maybe_initialize

    maybe_initialize(True, coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
                     backend="nccl", device="cuda:0")
    group = make_data_group(n_data=1)
    spec, ts = DetectorSpec.from_config(config), TrainSpec.from_config(config)
    batch = train_batch(spec, np.random.RandomState(9), ts.batch_size, ts.max_objects, 40)
    dp, plain, step = lockstep(config, ts, batch, 3, group, dtype=torch.float64)
    out = {"float64": steps_agree(dp, plain, ts.learning_rate, "world-1 NCCL vs plain float64")}
    log(f"  16a float64: world-1 data-parallel step (NCCL) vs plain, 3 steps: worst share of each limit "
        f"{json.dumps(out['float64'])}")
    del dp, plain, step
    torch.cuda.empty_cache()
    for name, mixed, rtol in (("f32", False, 1e-5), ("bf16_mixed_precision", True, 2 ** -7)):
        run_spec = dataclasses.replace(ts, mixed_precision=mixed)
        torch.cuda.reset_peak_memory_stats()
        dp, plain, dp_step = lockstep(config, run_spec, batch, 3, group)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        shares = steps_agree(dp, plain, ts.learning_rate, f"world-1 {name}", check=False)
        losses = max(abs(d["losses"][k] - p["losses"][k]) / (rtol * abs(p["losses"][k]))
                     for d, p in zip(dp, plain) for k in p["losses"]
                     if k not in ("grad_norm", "grads_finite") and p["losses"][k])
        if not losses <= 1.0 or not all(np.isfinite(d["losses"]["total_loss"]) for d in dp):
            raise AssertionError(f"world-1 {name} losses {[d['losses'] for d in dp]} vs plain "
                                 f"{[p['losses'] for p in plain]}")
        plain_step = dp_train_step(config, run_spec)
        ms = timed_steps({"plain": plain_step, "data_parallel": dp_step}, batch)
        out[name] = {"losses_share_of_limit": losses, "phase9_shares": shares, "step_ms": ms,
                     "peak_memory_gib_both_runs": peak, "losses": [d["losses"]["total_loss"] for d in dp]}
        log(f"  16a {name}: world-1 data-parallel step (NCCL) vs plain, 3 steps: losses at {losses:.4f} of "
            f"{rtol:.3g}; phase 9's shares {json.dumps(shares)}; step {ms['data_parallel']:.2f} ms vs "
            f"{ms['plain']:.2f} ms plain (median of 5, in turns), peak {peak:.2f} GiB with both runs [{card()}]")
        del dp, plain, plain_step, dp_step
        torch.cuda.empty_cache()
    return out


def all_gather_probe(device) -> dict:
    """Whether the process group's all-gathers of CUDA tensors (into one
    tensor and into a list; small and 64 MB) give every rank's values."""
    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    out = {}
    for n in (5, 1 << 24):
        x = torch.arange(n, device=device, dtype=torch.float32) + 1e6 * rank
        want = torch.cat([torch.arange(n, device=device, dtype=torch.float32) + 1e6 * r for r in range(world)])
        full = torch.empty(world * n, device=device)
        torch.distributed.all_gather_into_tensor(full, x)
        parts = [torch.empty(n, device=device) for _ in range(world)]
        torch.distributed.all_gather(parts, x)
        out[f"into_tensor_{n}"] = bool(torch.equal(full, want))
        out[f"list_{n}"] = bool(torch.equal(torch.cat(parts), want))
    return out


def dp_rank(job_path: str) -> int:
    """16b's rank: the node batch of 4 over the process group of
    ``RANK`` / ``WORLD_SIZE`` (gloo on cuda:0, or NCCL on cuda:RANK where
    the job says so): three data-parallel f32 steps in lockstep with rank
    0's single-process steps at batch 4 (`lockstep`), the step time, each
    mutant's first step, the f32 step time, ZeRO-1's three steps (its
    first against plain data parallelism's); all but the timing in float64.
    Rank 0 compares. Writes a JSON result."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import barrier, make_data_group, maybe_initialize
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel.zero import ZeroOptimizer

    job = json.loads(Path(job_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    device = f"cuda:{rank}" if job["backend"] == "nccl" else "cuda:0"
    torch.cuda.set_device(device)
    maybe_initialize(True, backend=job["backend"], device=device, timeout_s=300)
    group = make_data_group(n_data=2)
    config = load_config("configs/base.yaml")
    spec, compat, ts = DetectorSpec.from_config(config), CompatFlags.from_config(config), TrainSpec.from_config(config)
    batch = train_batch(spec, np.random.RandomState(9), ts.batch_size, ts.max_objects, 40)
    out = {"backend": job["backend"], "device": device}
    with torch.cuda.device(device):
        # float64: f32 rounding puts some ReLU inputs and max-pool windows on
        # the other side of their kink in a batch of 2 rows than of 4, and
        # phase 9's replay of the sides cannot map one onto the other
        f64 = dict(device=device, dtype=torch.float64)
        dp, plain, step = lockstep(config, ts, batch, 3, group, rank=rank, **f64)
        del step
        # each mutant's first step, from the same initial state
        mutants = {}
        for m in ("bn", "num_pos"):
            with mutated_losses(m):
                mstep = dp_train_step(config, ts, group, mutant=m, **f64)
                mutants[m] = step_record(mstep, mstep.model, mstep(batch))
            del mstep
        torch.cuda.empty_cache()
        step = dp_train_step(config, ts, group, device=device)
        step(batch)  # warm-up
        out["step_ms"] = timed_steps({"data_parallel": step}, batch)["data_parallel"]
        del step
        out["all_gather"] = all_gather_probe(device)
        if all(out["all_gather"].values()):
            zstep = dp_train_step(config, ts, group, optimizer=ZeroOptimizer(ts, compat, 1, group.group), **f64)
            zero = [step_record(zstep, zstep.model, zstep(batch)) for _ in range(3)]
            out["zero_moment_bytes"] = zstep.optimizer.moment_bytes()
            out["zero_moment_share"] = out["zero_moment_bytes"] / sum(2 * p.numel() * 8 for p in zstep.model.parameters())
            del zstep
            dstep = dp_train_step(config, ts, group, **f64)
            first = step_record(dstep, dstep.model, dstep(batch))
            del dstep
            # ZeRO-1's first step against plain data parallelism's, from the
            # same state, at phase 9's limits, in float64: in f32 a parameter
            # whose gradient is rounding noise (a bias right before a
            # BatchNorm) moves by up to lr either way, as the noise falls
            out["zero_vs_dp"] = steps_agree([zero[0]], [first], ts.learning_rate, "ZeRO-1 vs plain DP")
        else:
            out["zero"] = f"not run: this backend's all-gather of CUDA tensors gave {out['all_gather']}"
        barrier()
        if rank == 0:
            out["worst_share_of_limits"] = steps_agree(dp, plain, ts.learning_rate, "2 ranks vs 1")
            for m, rec in mutants.items():
                worst, failures = step_errors(rec, plain[0], None, ts.learning_rate, f"{m} mutant", 1e-4)
                if not failures:
                    raise AssertionError(f"the per-rank {m} mutant passed the limits: {worst}")
                out[f"{m}_mutant_worst"] = worst
    Path(job["out"]).with_name(f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def rank_processes(flag: str, job: dict, tmp: Path, what: str, timeout_s: float = 420.0, nodes: int = 1) -> list:
    """Two processes of this script (``flag`` JOB) laid out by torchrun's
    environment on a free port (as `nodes` nodes), each writing
    ``rank{r}.json`` beside ``job["out"]``; their results, rank by rank."""
    job_path = tmp / f"{flag.strip('-')}_job.json"
    job_path.write_text(json.dumps(job))
    port = free_port()
    procs = []
    per_node = 2 // nodes
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank % per_node),
                   LOCAL_WORLD_SIZE=str(per_node), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=str(Path(__file__).resolve().parent))
        if nodes > 1:
            env["GROUP_RANK"] = str(rank // per_node)
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag, str(job_path)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    try:
        outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what} rank {rank} exited {p.returncode}:\n{o[-6000:]}")
    return [json.loads(Path(job["out"]).with_name(f"rank{r}.json").read_text()) for r in range(2)]


def dp_two_ranks(tmp: Path) -> dict:
    """16b: two rank processes at 2 rows each (gloo on cuda:0; NCCL on two
    cards where there are two) against one process at 4."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    t = time.perf_counter()
    res = rank_processes("--dp-rank", {"backend": backend, "out": str(tmp / "dp_out.json")}, tmp, "16b")
    out = dict(res[0], wall_s=time.perf_counter() - t, rank1_step_ms=res[1]["step_ms"])
    zero = (f"ZeRO-1's first step vs plain DP's: worst share of each limit {json.dumps(out['zero_vs_dp'])}, "
            f"{out['zero_moment_bytes'] / 2 ** 20:.1f} MiB of float64 moments a rank, "
            f"{out['zero_moment_share']:.4f} of the full moments" if "zero_vs_dp" in out else out["zero"])
    log(f"  16b two ranks ({backend}, {res[0]['device']}) at 2 rows vs one process at 4, 3 float64 steps: worst share "
        f"of each limit {json.dumps(out['worst_share_of_limits'])}; "
        f"mutants over the limits: BN {max(out['bn_mutant_worst'].values()):.3g}, num_pos "
        f"{max(out['num_pos_mutant_worst'].values()):.3g}; {zero}; f32 step {out['step_ms']:.1f} ms "
        f"({'host-copied gloo collectives, no scaling figure' if backend == 'gloo' else 'NCCL'}) [{card()}]")
    return out


def serving_replicas(config) -> dict:
    """16c: two replicas on cuda:0 at batch 8 (parts of 4 rows) on phase 4's
    requests, held to one device serving at the replicas' part of 4 rows
    (the same shapes, so the same cuDNN algorithms: bf16 results depend on
    them); one device at batch 8 for the latency and, reported, its
    answers' distance; the serve CLI's --data-parallel beyond the cards."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch import serve as serve_cli

    kw = dict(config=config, batch_size=8, max_delay_ms=20.0, score_threshold=0.0, use_bf16=True, fold_bn=True)
    servers = {"one": InferenceServer(**kw), "one_at_4": InferenceServer(**dict(kw, batch_size=4)),
               "two": InferenceServer(devices=["cuda:0", "cuda:0"], **kw)}
    samples = make_samples(servers["one"].spec, np.random.RandomState(3), 4)
    answers, out = {}, {}
    for name, server in servers.items():
        with server:
            batches = server.stats["batches"]
            answers[name], out[f"{name}_launches"] = served_requests(server, samples)
            out[f"{name}_batches"] = server.stats["batches"] - batches
    # B1 on the LiDAR and the radar points of each replica's part of each batch
    if out["two_launches"] != 2 * 2 * out["two_batches"]:
        raise AssertionError(f"two replicas launched B1 {out['two_launches']} times in {out['two_batches']} batches")
    out["bit_equal"] = detections_agree(answers["two"], answers["one_at_4"], "two replicas vs one device at 4 rows")
    out["batch_8_max_score_diff"] = max(
        float(np.abs(by_position(g)["scores"] - by_position(w)["scores"]).max())
        for g, w in zip(answers["two"], answers["one"]) if len(g["scores"]) == len(w["scores"]))
    out["batch_latency_ms"] = batch_latency_ms({k: servers[k] for k in ("one", "two")}, [samples[0]] * 8)
    n = torch.cuda.device_count() + 1
    try:
        serve_cli.main(["--data-parallel", str(n)])
        raise AssertionError(f"serve --data-parallel {n} did not exit")
    except SystemExit as e:
        if "needs that many devices" not in str(e):
            raise
        out["cli_exit"] = str(e)
    del servers
    torch.cuda.empty_cache()
    log(f"  16c two replicas on cuda:0: 19 requests in {out['two_batches']} batches, B1 {out['two_launches']} "
        f"launches (one device: {out['one_launches']} in {out['one_batches']}); bit-equal to one device at 4 rows "
        f"{out['bit_equal']}; against one device at batch 8 (other cuDNN algorithms) scores differ by up to "
        f"{out['batch_8_max_score_diff']:.3g}; batch latency {out['batch_latency_ms']['two']:.2f} ms vs "
        f"{out['batch_latency_ms']['one']:.2f} ms on one replica (uint8, median of 8, in turns); serve "
        f"--data-parallel {n}: '{out['cli_exit']}' [{card()}]")
    return out


def torchrun_training(tree_config: dict, tmp: Path) -> dict:
    """16d: the training CLI under torchrun (one process, multi_host on) on
    phase 11's tree for one epoch, then resumed in this process."""
    work = tmp / "torchrun"
    work.mkdir()
    cfg = copy.deepcopy(tree_config)
    cfg["parallel"]["multi_host"] = {"enable": True}
    cfg["train"]["checkpoint"]["save_dir"] = str(work / "checkpoints")
    cfg["train"]["logging"]["log_dir"] = str(work / "logs")
    cfg["train"]["num_epochs"] = 1
    cfg["train"]["resume"]["enable"] = False
    (work / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", "-m",
         f"{PORT}.train_detect", "train", str(work / "cfg.yaml")],
        cwd=str(work), env=env, capture_output=True, text=True, timeout=420)
    out = {"torchrun_s": time.perf_counter() - t}
    if proc.returncode != 0 or "Data parallel: rank 0 of 1, node 0 of 1" not in proc.stdout:
        raise AssertionError(f"torchrun training exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    files = sorted(p.name for p in (work / "checkpoints").iterdir())
    if files != ["best_model.msgpack", "checkpoint_epoch_0.msgpack"] or proc.stdout.count("Metrics saved to") != 1:
        raise AssertionError(f"torchrun training wrote {files} and {proc.stdout.count('Metrics saved to')} reports")
    saved = msgpack_restore((work / "checkpoints" / "checkpoint_epoch_0.msgpack").read_bytes())
    cfg["train"]["num_epochs"] = 2
    cfg["train"]["resume"]["enable"] = True
    record, cwd = {}, os.getcwd()
    os.chdir(work)
    try:
        with traced_trainer(record):
            t = time.perf_counter()
            trainer = train_detect.main(config=cfg, device="cuda:0")
            out["resume_s"] = time.perf_counter() - t
    finally:
        os.chdir(cwd)
    restored = record["load_checkpoint"][0]["state"]
    got = {"params": restored["variables"]["params"], "batch_stats": restored["variables"]["batch_stats"],
           "opt_state": restored["opt_state"]}
    n = 0
    for part in ("params", "batch_stats", "opt_state"):
        g, w = dict(tree_leaves(got[part])), dict(tree_leaves(saved[part]))
        if set(g) != set(w):
            raise AssertionError(f"restored {part} keys differ from the torchrun checkpoint's")
        for k, a in w.items():
            if a is not None and not np.array_equal(np.asarray(g[k]), np.asarray(a)):
                raise AssertionError(f"restored {part}/{'/'.join(k)} differs from the torchrun checkpoint's")
            n += a is not None
    if record["load_checkpoint"][0]["epoch"] != 0 or trainer.step != 4 or int(saved["step"]) != 2:
        raise AssertionError(f"resume: epoch {record['load_checkpoint'][0]['epoch']}, step {trainer.step}")
    out.update(restored_arrays_bit_exact=n, steps=trainer.step,
               validation_b1_launches=[e["b1_launches"] for e in record["evaluate"]])
    del trainer
    torch.cuda.empty_cache()
    log(f"  16d torchrun --standalone --nproc_per_node 1 (multi_host): one epoch in {out['torchrun_s']:.1f} s "
        f"(process start and build included), one checkpoint and one report written; resumed in this process "
        f"bit for bit over {n} arrays into epoch 1 ({out['resume_s']:.1f} s), B1 "
        f"{out['validation_b1_launches']} in its validation")
    return out


def data_parallelism(config, tree_config: dict, tmp: Path) -> dict:
    """Phase 16."""
    out = {"world_one_nccl": dp_world_one(config)}
    out["two_ranks"] = dp_two_ranks(tmp)
    out["serving_replicas"] = serving_replicas(config)
    out["torchrun"] = torchrun_training(tree_config, tmp)
    torch.distributed.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# phase 17: the camera-view axis and BEV-spatial partitioning
# ---------------------------------------------------------------------------

VIEW_MUTANTS = ("view_bn", "replicated_world", "halo")


@contextlib.contextmanager
def view_mutant(name):
    """A view-parallel step gone wrong in one way: "view_bn" takes the
    camera trunk's BatchNorm statistics of each view rank's cameras alone,
    "replicated_world" sums every gradient over the world (the replicated
    ones counted once a view rank), "halo" gives the row-block head zero
    rows where its neighbours' boundary rows belong. None: as it is."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import view as port_view

    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "view_bn":
        stats = train_loop.global_statistics
        patch(train_loop, "global_statistics", lambda module, group, camera_group=None: stats(module, group))
    elif name == "replicated_world":
        patch(train_loop, "partial_modules", lambda model, n_cameras: list(model.children()))
    elif name == "halo":
        rows = port_view.ViewShard.rows_with_halo

        def no_halo(self, x):
            y = rows(self, x).clone()
            y[:, :, 0] = 0
            y[:, :, -1] = 0
            return y

        patch(port_view.ViewShard, "rows_with_halo", no_halo)
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)


def view_eval_batch(spec, rng: np.random.RandomState, b: int, plans=None) -> dict:
    """`b` rows of f32 cameras, LiDAR and radar points (and the geometric
    path's plans)."""
    h, w = spec.camera.image_size
    return collate_fn([{
        "camera_imgs": rng.randn(6, h, w, 3).astype(np.float32),
        "lidar_points": lidar_points(rng, 2, spec.lidar.max_points)[0],
        "radar_points": radar_points(rng, spec.radar.num_radars, spec.radar.max_points_per_sensor),
        **(plans or {}),
    } for _ in range(b)])


def view_eval(config, group, rank: int, device) -> dict:
    """17b: the f32 eval step (TF32 off) of a seeded base.yaml model with
    O(1) head weights (as phase 3), pseudo and geometric with the pallas
    splat, on this rank's view shard with the head on BEV row blocks, at 2
    rows; B1 and B2 counted from 0 around one step; rank 0 holds the maps
    and the decoded outputs to the unsharded model on one device at 1e-4
    of each output's scale. Both ranks time the step."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import barrier

    out = {}
    for name, cfg in (("pseudo", config), ("geometric", geometric_config(config))):
        spec, compat = DetectorSpec.from_config(cfg), CompatFlags.from_config(cfg)
        g = torch.Generator().manual_seed(17)
        model = randomize_stats(MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding,
                                                     bev_spatial=True).init_weights(g), g)
        with torch.no_grad():
            for m in model.det_head.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
        model = model.eval().to(device)
        one = copy.deepcopy(model) if rank == 0 else None
        model.shard_views(group.view_shard())
        batch = view_eval_batch(spec, np.random.RandomState(18), 2, camera_plan_inputs(spec) if name == "geometric" else None)
        step = make_eval_step(model, compat, device=device)
        inputs = model.forward_inputs(train_loop._on_device(model, batch, torch.device(device))[0])
        step(batch)  # warm-up
        torch.cuda.synchronize()
        counters = (pf.pointnet_fused, bp.bev_pool_weighted_rows)
        for k in counters:
            k.launches = 0
        got = step(batch)
        torch.cuda.synchronize()
        res = {"launches": {k.__name__: k.launches for k in counters}, "head_on_rows": model.head_on_rows()}
        with torch.inference_mode():
            maps = model(**inputs)
        res["step_ms"] = timed_steps({"eval": step}, batch)["eval"]
        if res["launches"] != {"pointnet_fused": 2, "bev_pool_weighted_rows": int(name == "geometric")}:
            raise AssertionError(f"17b {name}: launches {res['launches']} in one eval step")
        if rank == 0:
            want = make_eval_step(one, compat, device=device)(batch)
            with torch.inference_mode():
                want_maps = one(**inputs)
            res["maps"] = output_errors({k: v.float().cpu() for k, v in maps.items()},
                                        {k: v.float().cpu() for k, v in want_maps.items()}, f"17b {name} maps")
            res["decoded"] = output_errors({k: v.float().cpu() for k, v in got.items()},
                                           {k: v.float().cpu() for k, v in want.items()}, f"17b {name} decoded")
            del one, want, want_maps
        barrier()
        out[name] = res
        del model, step, maps, got
        torch.cuda.empty_cache()
    return out


def view_rank(job_path: str) -> int:
    """17's rank: two processes on cuda:0 over gloo laid out as (data 1,
    view 2), each running the camera trunk on 3 of the 6 cameras and the
    head on 25 of the 50 BEV rows (bev_spatial). (a) one float64 train step
    of base.yaml at 2 rows, from rank 0's plain step's state, held by rank
    0 to that plain step at phase 9's limits, and each of
    `view_mutant`'s three mutants' first step shown to exceed them; the f32
    step time (TF32 off); (b) `view_eval`. Writes a JSON result."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import barrier, make_data_group, maybe_initialize

    job = json.loads(Path(job_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, device = int(os.environ["RANK"]), "cuda:0"
    torch.cuda.set_device(device)
    maybe_initialize(True, backend="gloo", device=device, timeout_s=300)
    group = make_data_group(n_data=1, n_view=2)
    config = load_config("configs/base.yaml")
    spec, ts = DetectorSpec.from_config(config), TrainSpec.from_config(config)
    batch = train_batch(spec, np.random.RandomState(9), 2, ts.max_objects, 40)
    out = {"device": device}
    with torch.cuda.device(device):
        f64 = dict(device=device, dtype=torch.float64, bev_spatial=True)
        got, want, step = lockstep(config, ts, batch, 1, group, rank=rank, **f64)
        out["head_on_rows"] = step.model.head_on_rows()
        out["partial_modules"] = sorted(n for n, m in step.model.named_children() if any(m is p for p in step.partial))
        del step
        mutants = {}
        for m in VIEW_MUTANTS:
            with view_mutant(m):
                mstep = dp_train_step(config, ts, group, **f64)
                mutants[m] = step_record(mstep, mstep.model, mstep(batch))
            del mstep
        torch.cuda.empty_cache()
        step = dp_train_step(config, ts, group, device=device, bev_spatial=True)
        step(batch)  # warm-up
        out["step_ms"] = timed_steps({"view": step}, batch)["view"]
        del step
        torch.cuda.empty_cache()
        out["eval"] = view_eval(config, group, rank, device)
        barrier()
        if rank == 0:
            out["worst_share_of_limits"] = steps_agree(got, want, ts.learning_rate, "view ranks vs one")
            for m, rec in mutants.items():
                worst, failures = step_errors(rec, want[0], None, ts.learning_rate, f"{m} mutant", 1e-4)
                if not failures:
                    raise AssertionError(f"the {m} mutant passed the limits: {worst}")
                out[f"{m}_mutant_worst"] = worst
    Path(job["out"]).with_name(f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def view_serving(config) -> dict:
    """17c: `InferenceServer(devices=[[cuda:0, cuda:0]])` (one replica, its
    cameras split over a row of two devices) at batch 8, bf16, uint8
    cameras, on phase 4's 19 requests, B1 counted (2 a batch) and the
    answers held to one device's at the same batch at scores 1e-4 and
    boxes 1e-3; the batch latency beside one device's."""
    kw = dict(config=config, batch_size=8, max_delay_ms=20.0, score_threshold=0.0, use_bf16=True, fold_bn=True)
    servers = {"one": InferenceServer(**kw), "grid": InferenceServer(devices=[["cuda:0", "cuda:0"]], **kw)}
    rng = np.random.RandomState(3)
    samples = [dict(s, camera_imgs=rng.randint(0, 256, np.shape(s["camera_imgs"]), np.uint8))
               for s in make_samples(servers["one"].spec, rng, 4)]
    answers, out = {}, {}
    for name, server in servers.items():
        with server:
            batches = server.stats["batches"]
            answers[name], out[f"{name}_launches"] = served_requests(server, samples)
            out[f"{name}_batches"] = server.stats["batches"] - batches
    if out["grid_launches"] != 2 * out["grid_batches"]:
        raise AssertionError(f"the grid server launched B1 {out['grid_launches']} times in {out['grid_batches']} batches")
    out["bit_equal"] = detections_agree(answers["grid"], answers["one"], "1x2 grid vs one device")
    out["max_score_diff"] = max(float(np.abs(by_position(g)["scores"] - by_position(w)["scores"]).max())
                                for g, w in zip(answers["grid"], answers["one"]))
    out["batch_latency_ms"] = batch_latency_ms(servers, [samples[0]] * 8)
    del servers
    torch.cuda.empty_cache()
    log(f"  17c 1x2 grid on cuda:0: 19 requests in {out['grid_batches']} batches, B1 {out['grid_launches']} "
        f"launches; against one device at batch 8 scores differ by up to {out['max_score_diff']:.3g} (bit-equal "
        f"{out['bit_equal']}); batch latency {out['batch_latency_ms']['grid']:.2f} ms vs "
        f"{out['batch_latency_ms']['one']:.2f} ms on one device (uint8, median of 8, in turns) [{card()}]")
    return out


def view_parallelism(tmp: Path) -> dict:
    """Phase 17."""
    config = load_config("configs/base.yaml")
    work = tmp / "view"
    work.mkdir(exist_ok=True)
    t = time.perf_counter()
    res = rank_processes("--view-rank", {"out": str(work / "view_out.json")}, work, "17", timeout_s=600)
    out = dict(res[0], wall_s=time.perf_counter() - t, rank1_step_ms=res[1]["step_ms"],
               rank1_eval={k: {"launches": v["launches"], "step_ms": v["step_ms"]} for k, v in res[1]["eval"].items()})
    ev = out["eval"]
    log(f"  17a two view ranks (gloo, cuda:0; 3 cameras and 25 BEV rows a rank; modules of a rank's part "
        f"{out['partial_modules']}) at 2 rows vs one process, a float64 step: worst share of each limit "
        f"{json.dumps(out['worst_share_of_limits'])}; mutants over the limits: "
        + ", ".join(f"{m} {max(out[f'{m}_mutant_worst'].values()):.3g}" for m in VIEW_MUTANTS)
        + f"; f32 step {out['step_ms']:.1f} ms (host-copied gloo collectives, no scaling figure) [{card()}]")
    for name, r in ev.items():
        worst = max(e["max_abs_err"] / e["scale"] for part in ("maps", "decoded") for e in r[part].values())
        log(f"  17b {name} f32 eval step on the view ranks (2 rows): {r['step_ms']:.1f} ms, launches "
            f"{r['launches']} a step; worst error {worst:.3g} of an output's scale vs one device [{card()}]")
    out["serving"] = view_serving(config)
    return out


# ---------------------------------------------------------------------------
# phase 18: the directory checkpoint backends (orbax, orbax_async)
# ---------------------------------------------------------------------------

CKPT_MUTANTS = ("references", "no_recut", "commit_early")


@contextlib.contextmanager
def checkpoint_mutant(name, rank: int = 0):
    """A directory checkpoint gone wrong in one way: "references" snapshots
    references to the live tensors instead of host copies (the writer then
    serializes a later moment's state); "no_recut" restores the moments
    from the one shard file of its slice's index, as if the files had been
    cut for the current world; "commit_early" has global rank 0 commit
    without waiting for the other ranks (rank 1, a slow rank, writing once
    rank 0 has committed, or after 30 s). None: as it is."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train import checkpoint as ckpt

    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "references":
        patch(train_loop.HostBuffers, "copy", lambda self, tensors: dict(tensors))
    elif name == "no_recut":
        def one_file(path, meta, lo, hi):
            n, size = meta["opt_state_files"], meta["moments"]["shard_numel"]
            shard = msgpack_restore((Path(path) / ckpt.opt_state_file(min(lo // size, n - 1), n)).read_bytes())
            out = [np.zeros(hi - lo, np.dtype(meta["moments"]["dtype"])) for _ in range(2)]
            for dst, key in zip(out, ("exp_avg", "exp_avg_sq")):
                m = min(hi - lo, len(shard[key]))
                dst[:m] = shard[key][:m]
            return out[0], out[1]

        patch(ckpt, "read_moments", one_file)
    elif name == "commit_early":
        wait, write = ckpt._await, ckpt._write_files
        patch(ckpt, "_await", lambda store, key, failed, count=0: None if key.endswith("/written")
              else wait(store, key, failed, count))
        def late(directory, files):
            final = directory.with_name(directory.name.rsplit(ckpt.STAGING, 1)[0])
            deadline = time.monotonic() + 30.0
            while not final.exists() and time.monotonic() < deadline:
                time.sleep(0.01)
            return write(directory, files)

        if rank == 1:
            patch(ckpt, "_write_files", late)
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)


@contextlib.contextmanager
def checkpoint_files(hold=None):
    """The names of the files this process writes into directory checkpoints
    in the block, `ZeroOptimizer.gathered` raising meanwhile; with `hold` (a
    `threading.Event`) each write first waits for it."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel.zero import ZeroOptimizer
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train import checkpoint as ckpt

    names, write, gathered = [], ckpt._write_files, ZeroOptimizer.gathered

    def recorded(directory, files):
        if hold is not None:
            hold.wait()
        files = files() if callable(files) else files
        names.extend(files)
        return write(directory, files)

    def no_gather(self):
        raise AssertionError("ZeroOptimizer.gathered called for a directory checkpoint")

    ckpt._write_files, ZeroOptimizer.gathered = recorded, no_gather
    try:
        yield names
    finally:
        if hold is not None:
            hold.set()
            ckpt.wait_for_checkpoints()
        ckpt._write_files, ZeroOptimizer.gathered = write, gathered


def ckpt_config(config) -> dict:
    """Phase 9's small base.yaml model without its LiDAR branch (whose
    512 -> 80,000 dense layer, which no config key narrows, would make each
    float64 checkpoint ~1 GB; the format and the commit do not depend on the
    width, and phase 18c runs the full tri-modal width) with ``multi_host``
    and ``shard_optimizer``."""
    cfg = small_train_config(config)
    cfg["model"]["modality_config"] = "camera+radar"
    cfg["parallel"].update(multi_host=True, shard_optimizer=True)
    return cfg


def ckpt_trainer(config, group=None, device="cuda:0") -> Trainer:
    """A Trainer of `config`'s model in float64 on `device` (seeded
    weights), ZeRO-1 over `group` when given."""
    spec, compat, ts = DetectorSpec.from_config(config), CompatFlags.from_config(config), TrainSpec.from_config(config)
    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding).double()
    return Trainer(model, ts, compat, device=device, process_group=group,
                   shard_optimizer=group is not None).init_state()


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}[a.element_size()]
    return torch.equal(a.contiguous().view(as_int), b.contiguous().view(as_int))


def state_digest(trainer) -> str:
    """sha256 of the model's parameters and BatchNorm statistics, in order."""
    h = hashlib.sha256()
    for k, v in trainer.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def flat_moments(trainer) -> tuple:
    """The flat exp_avg and exp_avg_sq in ZeRO-1's order: the rank's slice
    under ZeRO-1, else the whole vector."""
    opt = trainer.optimizer
    if trainer.shard_optimizer:
        return opt.shard_moments()
    return tuple(torch.cat([opt.adamw.state[p][k].reshape(-1) for p in opt.params]) for k in ("exp_avg", "exp_avg_sq"))


def moment_digest(mu: torch.Tensor, nu: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in (mu, nu):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def committed_whole(path: Path, n: int) -> bool:
    """Whether `path` is a committed directory checkpoint with all `n`
    moment shards and they read back."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train import checkpoint as ckpt

    want = {"COMMITTED", "meta.msgpack", "variables.msgpack", *(ckpt.opt_state_file(i, n) for i in range(n))}
    if not path.is_dir() or {p.name for p in path.iterdir()} != want:
        return False
    meta = ckpt.read_meta(path)
    total = meta["moments"]["numel"]
    mu, nu = ckpt.read_moments(path, meta, 0, total)
    return len(mu) == total and bool(np.isfinite(mu).all() and np.isfinite(nu).all())


def ckpt_rank(job_path: str) -> int:
    """18's rank: two processes on cuda:0 over gloo laid out as two nodes
    (``multi_host``, ZeRO-1 over both), `ckpt_config`'s model in float64, node r
    training on rows [2r, 2r + 2) of a 4-row batch. One step; an ``orbax``
    and an ``orbax_async`` checkpoint of that state (the second step run
    while the async one writes); each must be committed whole, and each
    rank must have written only its part. The "references" and
    "commit_early" mutants. Then, in a fresh process group, each checkpoint
    restored into a fresh trainer (parameters and moment slice equal the
    saved ones bit for bit) and its next step held to the uninterrupted
    second step at phase 9's limits (rank 0). Writes a JSON result."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import make_data_group, maybe_initialize
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train import checkpoint as ckpt

    job = json.loads(Path(job_path).read_text())
    work = Path(job["work"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, device = int(os.environ["RANK"]), "cuda:0"
    torch.cuda.set_device(device)
    maybe_initialize(True, backend="gloo", device=device, timeout_s=300)
    config = ckpt_config(load_config("configs/base.yaml"))
    spec, ts = DetectorSpec.from_config(config), TrainSpec.from_config(config)
    full = train_batch(spec, np.random.RandomState(9), 4, 16, 5)
    batch = {k: v[2 * rank:2 * rank + 2] if isinstance(v, np.ndarray) else v for k, v in full.items()}
    out = {"device": device, "backends": {}, "mutants": {}}
    group = make_data_group(multi_host=True)
    live = ckpt_trainer(config, group)
    live.train_step(batch)
    saved_state = {k: v.detach().clone() for k, v in live.model.state_dict().items()
                   if not k.endswith("num_batches_tracked")}
    saved_mu = [m.clone() for m in live.optimizer.shard_moments()]
    out["saved"] = {"state": state_digest(live), "moments": moment_digest(*saved_mu), "lo": live.optimizer.lo,
                    "hi": live.optimizer.hi}
    for backend in ckpt.DIRECTORY_BACKENDS:
        path = work / backend
        with checkpoint_files() as names:
            torch.cuda.synchronize()
            t = time.perf_counter()
            live.save_checkpoint(str(path), 0, backend=backend)
            blocked = time.perf_counter() - t
            if backend == "orbax_async":  # the next step runs while the writer writes
                losses = live.train_step(batch)
            t = time.perf_counter()
            ckpt.wait_for_checkpoints()
            fence = time.perf_counter() - t
        torch.distributed.barrier()
        out["backends"][backend] = {
            "written": sorted(names), "bytes": sum((path / n).stat().st_size for n in names),
            "blocked_s": blocked, "fence_s": fence, "committed_whole": committed_whole(path, 2)}
    uninterrupted = step_record(live.train_step, live.model, losses)  # (ZeRO-1: gathers, for the comparison)
    # the mutants, each against the check it must fail
    hold = threading.Event()
    with checkpoint_mutant("references"), checkpoint_files(hold):
        before = state_digest(live), moment_digest(*live.optimizer.shard_moments())
        live.save_checkpoint(str(work / "references"), 0, backend="orbax_async")
        live.train_step(batch)  # changes the state in place while the writer waits
        hold.set()
        ckpt.wait_for_checkpoints()
    torch.distributed.barrier(group.group)
    probe = ckpt_trainer(config, group)
    probe.load_checkpoint(str(work / "references"))
    out["mutants"]["references"] = {"fails": (state_digest(probe), moment_digest(*probe.optimizer.shard_moments()))
                                    != before}
    del probe
    try:
        with checkpoint_mutant("commit_early", rank):
            live.save_checkpoint(str(work / "commit_early"), 0, backend="orbax")
        whole = committed_whole(work / "commit_early", 2)
        out["mutants"]["commit_early"] = {"fails": not whole, "raised": None}
    except Exception as e:  # the late rank finds its staging directory gone
        out["mutants"]["commit_early"] = {"fails": True, "raised": repr(e)[:200]}
    del live
    torch.cuda.empty_cache()
    # a fresh process group: the resume
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    maybe_initialize(True, coordinator_address=f"127.0.0.1:{job['port2']}", backend="gloo", device=device,
                     timeout_s=300)
    group = make_data_group(multi_host=True)
    for backend in ckpt.DIRECTORY_BACKENDS:
        resumed = ckpt_trainer(config, group)
        with checkpoint_files():
            torch.cuda.synchronize()
            t = time.perf_counter()
            epoch = resumed.load_checkpoint(str(work / backend))
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t
        res = out["backends"][backend]
        res.update(read_s=read_s, epoch=epoch, updates=resumed.optimizer.updates, step=resumed.step,
                   state_bits_equal=all(bits_equal(v, saved_state[k]) for k, v in resumed.model.state_dict().items()
                                        if k in saved_state),
                   moments_bits_equal=all(bits_equal(a, b) for a, b in zip(resumed.optimizer.shard_moments(), saved_mu)))
        record = step_record(resumed.train_step, resumed.model, resumed.train_step(batch))
        if rank == 0:
            res["next_step"] = compare_step(record, uninterrupted, None, ts.learning_rate,
                                            f"18 {backend} resumed at world 2", 1e-4)
        del resumed, record
        torch.cuda.empty_cache()
    Path(job["out"]).with_name(f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def ckpt_world_one(config, work: Path, ranks: list) -> dict:
    """18b: each two-rank checkpoint restored at world 1 in this process (no
    process group, no ZeRO: every shard read), its parameters and each
    rank's moment slice equal to what the ranks saved (sha256), and its
    next step held at phase 9's limits to one process's uninterrupted second
    step at the global batch of 4; the "no_recut" mutant."""
    config = ckpt_config(config)
    spec, ts = DetectorSpec.from_config(config), TrainSpec.from_config(config)
    batch = train_batch(spec, np.random.RandomState(9), 4, 16, 5)
    single = ckpt_trainer(config)
    first = step_record(single.train_step, single.model, single.train_step(batch))
    second = step_record(single.train_step, single.model, single.train_step(batch))
    del single
    out = {}

    def digests(trainer) -> dict:
        mu, nu = flat_moments(trainer)
        return {"state": state_digest(trainer),
                "moments": [moment_digest(mu[r["saved"]["lo"]:r["saved"]["hi"]], nu[r["saved"]["lo"]:r["saved"]["hi"]])
                            for r in ranks]}

    want = {"state": ranks[0]["saved"]["state"], "moments": [r["saved"]["moments"] for r in ranks]}
    for backend in ("orbax", "orbax_async"):
        resumed = ckpt_trainer(config)
        t = time.perf_counter()
        resumed.load_checkpoint(str(work / backend))
        read_s = time.perf_counter() - t
        got = digests(resumed)
        if got != want or (resumed.optimizer.updates, resumed.step) != (1, 1):
            raise AssertionError(f"18b {backend} at world 1: restored {got} (counts {resumed.optimizer.updates}, "
                                 f"{resumed.step}), saved {want}")
        record = step_record(resumed.train_step, resumed.model, resumed.train_step(batch))
        out[backend] = {"read_s": read_s, "next_step": compare_step(
            record, second, first["mu"], ts.learning_rate, f"18b {backend} resumed at world 1", 1e-4)}
        del resumed, record
        torch.cuda.empty_cache()
    with checkpoint_mutant("no_recut"):
        probe = ckpt_trainer(config)
        probe.load_checkpoint(str(work / "orbax"))
    out["no_recut_fails"] = digests(probe) != want
    del probe
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def timed_snapshots(times: list):
    """Host seconds of each `Trainer._snapshot` (the device-to-host copy a
    directory checkpoint blocks on) in the block."""
    snap = Trainer._snapshot

    def timed(self):
        t = time.perf_counter()
        out = snap(self)
        times.append(time.perf_counter() - t)
        return out

    Trainer._snapshot = timed
    try:
        yield times
    finally:
        Trainer._snapshot = snap


def dir_size(path: Path) -> int:
    return sum(p.stat().st_size for p in path.iterdir()) if path.is_dir() else path.stat().st_size


def directory_training(tree_config: dict, tmp: Path) -> dict:
    """18c: the training CLI at phase 11's full width (f32) on phase 11's
    tree: one epoch under ``orbax`` (its epoch checkpoint and best_model
    directories), then resumed under ``orbax_async`` into epoch 1
    (keep_last 1 after the fence): the restore bit for bit, B1 on every
    validation batch, the committed directories left; the time the loop
    was blocked by each save and each snapshot; then `InferenceServer`
    started from ``best_model/`` (B1 counted) held to the Trainer's f32 eval
    step on that directory at phase 11's 1e-4."""
    work = tmp / "directory_checkpoints"
    work.mkdir()
    cfg = copy.deepcopy(tree_config)
    cfg["train"]["checkpoint"].update(save_dir=str(work / "checkpoints"), backend="orbax")
    cfg["train"]["logging"]["log_dir"] = str(work / "logs")
    cfg["train"]["num_epochs"] = 1
    cfg["train"]["resume"]["enable"] = False
    ts, compat, spec = TrainSpec.from_config(cfg), CompatFlags.from_config(cfg), DetectorSpec.from_config(cfg)
    record, snaps, cwd = {}, [], os.getcwd()
    os.chdir(work)
    try:
        with traced_trainer(record), timed_snapshots(snaps):
            first = train_detect.main(config=cfg, device="cuda")
            saved = trainer_state(first)
            del first
            torch.cuda.empty_cache()
            cfg2 = copy.deepcopy(cfg)
            cfg2["train"]["checkpoint"]["backend"] = "orbax_async"
            cfg2["train"]["num_epochs"] = 2
            cfg2["train"]["resume"]["enable"] = True
            second = train_detect.main(config=cfg2, device="cuda")
            steps = second.step
            del second
            torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    restored = record["load_checkpoint"]
    if len(restored) != 1 or restored[0]["epoch"] != 0 or steps != 4:
        raise AssertionError(f"18c: restored {[r['epoch'] for r in restored]}, {steps} steps")
    n_arrays = assert_states_equal(restored[0]["state"], saved)
    ckpts = work / "checkpoints"
    files = sorted(p.name for p in ckpts.iterdir())
    if files != ["best_model", "checkpoint_epoch_1"] or not all(committed_whole_dir(ckpts / f) for f in files):
        raise AssertionError(f"18c: after keep_last 1 the checkpoints are {files}")
    val_batches = (4 + ts.batch_size - 1) // ts.batch_size
    resumed_b1 = [e["b1_launches"] for e in record["evaluate"][1:]]
    if resumed_b1 != [2 * val_batches]:
        raise AssertionError(f"18c: B1 launches in the resumed validations {resumed_b1}")
    saves = record["save_checkpoint"]  # orbax: epoch 0 and best_model; orbax_async: epoch 1 (and best_model)
    out = {"restored_arrays_bit_exact": n_arrays, "resumed_validation_b1_launches": resumed_b1,
           "orbax_blocked_s": [e["s"] for e in saves[:2]], "orbax_async_blocked_s": [e["s"] for e in saves[2:]],
           "snapshot_s": snaps, "bytes": dir_size(ckpts / "checkpoint_epoch_1"),
           "restore_s": restored[0]["s"]}
    # serve best_model/ in f32 and hold it to the Trainer's eval step on it
    best = str(ckpts / "best_model")
    val_ds = NuScenesDataset(split="val", config=cfg, seed=ts.seed, emit_uint8=True)
    samples = [val_ds[i] for i in range(len(val_ds))]
    server = InferenceServer(config=cfg, model_path=best, batch_size=len(samples), score_threshold=0.0,
                             use_bf16=False, fold_bn=False, device="cuda")
    b1 = pf.pointnet_fused.launches
    got = server._run_batch([{k: s[k] for k in ("camera_imgs", "lidar_points", "radar_points")} for s in samples])
    out["server_b1_launches"] = pf.pointnet_fused.launches - b1
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
    err = max(float(np.abs(g["scores"] - w["scores"]).max()) for g, w in zip(got, want))
    if out["server_b1_launches"] != 2 or any(len(g["scores"]) != len(w["scores"]) for g, w in zip(got, want)) \
            or not err <= 1e-4 * scale:
        raise AssertionError(f"18c: the server from best_model/ launched B1 {out['server_b1_launches']} times, "
                             f"scores within {err} of the eval step's (scale {scale})")
    out["served_score_err"] = err
    return out


def committed_whole_dir(path: Path) -> bool:
    """A committed, unsharded directory checkpoint with its four files."""
    return path.is_dir() and {p.name for p in path.iterdir()} == {
        "COMMITTED", "meta.msgpack", "variables.msgpack", "opt_state.0-of-1.msgpack"}


def directory_checkpoints(config, tree_config: dict, tmp: Path, msgpack_write_s: list) -> dict:
    """Phase 18."""
    work = tmp / "ckpt_ranks"
    work.mkdir()
    t = time.perf_counter()
    ranks = rank_processes("--ckpt-rank", {"out": str(work / "ckpt_out.json"), "work": str(work),
                                           "port2": free_port()}, work, "18", timeout_s=600, nodes=2)
    out = {"two_ranks_s": time.perf_counter() - t}
    for rank, res in enumerate(ranks):
        want = (["meta.msgpack", "opt_state.0-of-2.msgpack", "variables.msgpack"] if rank == 0
                else ["opt_state.1-of-2.msgpack"])
        for backend, b in res["backends"].items():
            if b["written"] != want or not b["committed_whole"]:
                raise AssertionError(f"18a {backend} rank {rank} wrote {b['written']} (committed whole: "
                                     f"{b['committed_whole']})")
            if (b["epoch"], b["updates"], b["step"]) != (0, 1, 1) or not (b["state_bits_equal"]
                                                                          and b["moments_bits_equal"]):
                raise AssertionError(f"18a {backend} rank {rank} resumed at world 2: {b}")
        for m, r in res["mutants"].items():
            if not r["fails"]:
                raise AssertionError(f"18a the {m} mutant passed its check on rank {rank}")
    out["ranks"] = ranks
    t = time.perf_counter()
    out["world_one"] = ckpt_world_one(config, work, ranks)
    out["world_one_s"] = time.perf_counter() - t
    if not out["world_one"]["no_recut_fails"]:
        raise AssertionError("18b the no_recut mutant passed its check")
    t = time.perf_counter()
    out["training_cli"] = cli = directory_training(tree_config, tmp)
    out["training_cli_s"] = time.perf_counter() - t
    r0, r1 = ranks
    for backend in ("orbax", "orbax_async"):
        a, b = r0["backends"][backend], r1["backends"][backend]
        log(f"  18a {backend}, two gloo ranks on cuda:0 as two nodes (multi_host, ZeRO-1), phase 9's small "
            f"camera+radar model in float64: "
            f"rank 0 wrote {a['written']} ({a['bytes'] / 2 ** 20:.1f} MiB), rank 1 {b['written']} "
            f"({b['bytes'] / 2 ** 20:.1f} MiB); blocked {a['blocked_s']:.3f} / {b['blocked_s']:.3f} s, fence "
            f"{a['fence_s']:.3f} / {b['fence_s']:.3f} s; resumed in a fresh group bit for bit (read "
            f"{a['read_s']:.2f} / {b['read_s']:.2f} s), next step at {json.dumps(a['next_step'])} of phase 9's "
            f"limits; at world 1: read {out['world_one'][backend]['read_s']:.2f} s, next step at "
            f"{json.dumps(out['world_one'][backend]['next_step'])} [{card()}]")
    log(f"  18a mutants failing their checks: references {r0['mutants']['references']['fails']}, commit_early "
        f"{r0['mutants']['commit_early']['fails']} (rank 1: {r1['mutants']['commit_early']['raised']}); 18b "
        f"no_recut {out['world_one']['no_recut_fails']}")
    log(f"  18c training CLI at full width (f32), the loop blocked per save: msgpack "
        f"{', '.join(f'{s:.3f}' for s in msgpack_write_s)} s (phase 11), orbax "
        f"{', '.join(f'{s:.3f}' for s in cli['orbax_blocked_s'])} s, orbax_async "
        f"{', '.join(f'{s:.3f}' for s in cli['orbax_async_blocked_s'])} s; snapshots "
        f"{', '.join(f'{s:.3f}' for s in cli['snapshot_s'])} s; {cli['bytes'] / 2 ** 20:.1f} MiB a checkpoint "
        f"(one rank); restore {cli['restore_s']:.2f} s bit for bit over {cli['restored_arrays_bit_exact']} arrays; "
        f"B1 {cli['resumed_validation_b1_launches']} in the resumed validations, {cli['server_b1_launches']} in the "
        f"server from best_model/ (scores within {cli['served_score_err']:.2e}) [{card()}]")
    log(f"  18a took {out['two_ranks_s']:.1f} s (two processes), 18b {out['world_one_s']:.1f} s, 18c "
        f"{out['training_cli_s']:.1f} s")
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
    encoders, rng = b1_encoders(full, g)

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
        log(f"  B1 {what} bf16 through the custom op: {t['ms']:.4f} ms median of 3 ({t['ms_min']:.4f}-"
            f"{t['ms_max']:.4f}; the ctypes launch it wraps {t['ctypes_ms']:.4f}), "
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
    t = pools["bev_pool_weighted"]
    log(f"  B2 {t['shape']}: {t['ms']:.4f} ms ({t['slice_channels']} channels a slice, {t['blocks']} blocks, "
        f"{t['blocks_per_sm']} per SM), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
        f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}; 6 rows {t['ms_6_rows']:.4f} ms "
        f"({t['slice_channels_6_rows']} channels a slice, {t['blocks_6_rows']} blocks)")
    t = pools["bev_pool_sorted"]
    log(f"  B3 {t['shape']}: {t['ms']:.4f} ms, device alone {t['device_ms']:.4f} ({t['warps']} warps a row, "
        f"{t['blocks']} blocks, {t['blocks_per_sm']} per SM, busiest warp {t['busiest_warp_share']:.3f}x its "
        f"row's mean), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain {t['plain_ms']:.4f}, index_add_ "
        f"{t['library_ms']:.4f}; long cell {t['long_cell_ms']:.4f} ms, device alone "
        f"{t['long_cell_device_ms']:.4f}, bound {t['long_cell_bound_ms']:.4f}")

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

        log("phase 14: the scatter and culled splats and the training-data options (augmentation, "
            "multi-sweep LiDAR and radar, camera freeze_bn)")
        t = time.perf_counter()
        opts = training_options(config, g, rng, Path(tmp), geo["batch_ms_p50"])
        log(f"  phase 14 took {time.perf_counter() - t:.1f} s")
        log("  " + json.dumps({"training_options": opts}))

        log("phase 15: AOT serving artifacts (torch.export, B1 as a custom op), profiling and the compile cache")
        t = time.perf_counter()
        aot = aot_profiling_cache(config, tree_config, Path(tmp))
        log(f"  phase 15 took {time.perf_counter() - t:.1f} s")
        log("  " + json.dumps({"aot_profiling": aot}))

        log("phase 16: data parallelism (one NCCL rank, two ranks on one card, two serving replicas, torchrun)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t = time.perf_counter()
        dp = data_parallelism(config, tree_config, Path(tmp))
        log(f"  phase 16 took {time.perf_counter() - t:.1f} s")
        log("  " + json.dumps({"data_parallelism": dp}))

        log("phase 17: the camera-view axis and BEV-spatial partitioning (two view ranks on one card, a 1x2 "
            "serving grid)")
        t = time.perf_counter()
        view = view_parallelism(Path(tmp))
        log(f"  phase 17 took {time.perf_counter() - t:.1f} s")
        log("  " + json.dumps({"view_parallelism": view}))

        log("phase 18: the directory checkpoint backends (orbax, orbax_async: two ranks as two nodes with "
            "ZeRO-1, resumed at world 2 and 1; the training CLI and a server from best_model/)")
        t = time.perf_counter()
        dirs = directory_checkpoints(config, tree_config, Path(tmp), entry_point["checkpoint_write_s"])
        log(f"  phase 18 took {time.perf_counter() - t:.1f} s")
        log("  " + json.dumps({"directory_checkpoints": {k: v for k, v in dirs.items() if k != "ranks"}}))

    def entry(name, launches, err, t):
        source, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": t["shape"]}

    lidar_t["shape"] = "lidar 8x35000x4 bf16, through the custom op"
    kernels = [
        dict(entry("pointnet_fused", serve["launches"], max_err, lidar_t),
             device_ms=lidar_t["device_ms"], radar_device_ms=radar_t["device_ms"],
             ctypes_ms=lidar_t["ctypes_ms"], radar_ctypes_ms=radar_t["ctypes_ms"],
             aot_launches=aot["aot"]["aot_launches"],
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
                  for shape, t in var["b1_f32"].items()},
             c_in5={shape: {k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                    for shape, t in opts["b1_c_in5"].items()},
             c_in5_max_abs_err=opts["b1_c_in5_max_err"],
             culled_eval_launches=opts["culled_eval"]["launches"]["pointnet_fused"],
             scatter_eval_launches=opts["scatter_eval"]["launches"]["pointnet_fused"],
             training_data_options_validation_launches=opts["training_data_options"]["b1_launches_per_validation"],
             data_parallel_serving_launches=dp["serving_replicas"]["two_launches"],
             torchrun_resume_validation_launches=dp["torchrun"]["validation_b1_launches"],
             view_parallel_launches={"eval_step_" + k: [v["launches"]["pointnet_fused"],
                                                        view["rank1_eval"][k]["launches"]["pointnet_fused"]]
                                     for k, v in view["eval"].items()} | {
                 "serving_grid": view["serving"]["grid_launches"]},
             directory_checkpoint_launches={
                 "resumed_validations": dirs["training_cli"]["resumed_validation_b1_launches"],
                 "server_best_model_dir": dirs["training_cli"]["server_b1_launches"]}),
        # launches: phase 7, the geometric eval path
        dict(entry("bev_pool_weighted", geo["launches"]["bev_pool_weighted_rows"],
                   pool_err["bev_pool_weighted"], pools["bev_pool_weighted"]),
             view_parallel_launches=[view["eval"]["geometric"]["launches"]["bev_pool_weighted_rows"],
                                     view["rank1_eval"]["geometric"]["launches"]["bev_pool_weighted_rows"]],
             **{k: pools["bev_pool_weighted"][k] for k in (
                 "slice_channels", "blocks", "blocks_per_sm", "ms_6_rows", "slice_channels_6_rows", "blocks_6_rows")}),
        # no model path calls B3 (as in the JAX package): its count stays 0
        dict(entry("bev_pool_sorted", geo["launches"]["bev_pool_rows"],
                   pool_err["bev_pool_sorted"], pools["bev_pool_sorted"]),
             **{k: pools["bev_pool_sorted"][k] for k in (
                 "device_ms", "warps", "blocks", "blocks_per_sm", "scratch_bytes", "busiest_warp_share",
                 "long_cell_ms", "long_cell_device_ms", "long_cell_bound_ms", "long_cell_busiest_warp_share")}),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":  # a rank process of phase 16b
        sys.exit(dp_rank(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--view-rank":  # a rank process of phase 17
        sys.exit(view_rank(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ckpt-rank":  # a rank process of phase 18
        sys.exit(ckpt_rank(sys.argv[2]))
    sys.exit(main())
