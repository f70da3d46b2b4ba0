#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

from the repository root, on a machine with one CUDA card, `nvcc` and
PyTorch built for CUDA. The fused PointNet kernel is built from
``bevfusion_multimodal_3d_object_detection_tpu_torch/csrc/`` into ``build/``.
Phases (any failure raises and the script exits non-zero):

1. build the kernel with nvcc (sm_90a);
2. hold the kernel against its plain PyTorch version at the serving
   shapes: LiDAR 8x35000x4 -> ...1024 and radar 40x125x7 -> ...256, in
   f32 (TF32 off) and bf16, both mask_padding values, with BatchNorm
   statistics calibrated on the points and random non-zero biases, plus
   ragged N = 34,999 and 125 with every row a real point. The comparison
   is shown to reject the plain version with one bias dropped or with
   zero tiling rows in the max;
3. a small f32 forward + decode of the detector on the card against the
   same weights on the CPU (plain PyTorch path), with random non-zero
   biases and BatchNorm statistics;
4. the main path: `InferenceServer` at the full width of configs/base.yaml
   (6x448x800 cameras, 35,000 LiDAR points, 5x125 radar points), batch 8,
   bf16, BN folded, seeded weights; 19 concurrent requests mixing uint8 and
   float cameras, including a partial batch. Launch counters are zeroed
   just before and read just after. Then the steady-state batch latency,
   samples/s and a per-module device-time breakdown;
5. kernel timings at the LiDAR and radar shapes beside the plain version,
   a cuBLAS matmul/relu/amax chain as yardstick, and the bound.

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

from bevfusion_multimodal_3d_object_detection_tpu_torch.config import DetectorSpec, load_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import pointnet_fused as pf
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.decode import (
    decode_centernet_predictions,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer

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
TILE = 64  # the kernel's bf16 tile; its f32 tile (32) divides it
KERNEL_SOURCE = "bevfusion_multimodal_3d_object_detection_tpu_torch/csrc/pointnet_fused.cu"
KERNEL_REPLACES = "bevfusion_multimodal_3d_object_detection_tpu/ops/pointnet_pallas.py:116"


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


def compare(got: torch.Tensor, want: torch.Tensor, dtype) -> dict:
    """Per-element error of `got` against `want`, in units of the limit
    (`worst` <= 1 agrees), plus max abs error, max bf16 ulps and the share
    of elements that differ at all."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    mag = want.abs()
    limit = TOL[dtype] * (mag + FLOOR * mag.mean())
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
    with O(1) activations and non-zero folded biases. The same comparison
    must reject the plain version with any one layer's bias dropped, and,
    where every row is real, with zero tiling rows let into the max.
    Returns the largest bf16 error (the serving dtype)."""
    worst = 0.0
    failures = []
    cases = [
        ("lidar", lidar_points(rng, 8, 35000)),
        ("lidar-dense", dense_points(rng, 2, 34999, 4, 40.0)),
        ("radar", radar_points(rng, 40, 125)),
        ("radar-dense", dense_points(rng, 40, 125, 7, 2.0)),
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
                tiled = torch.cat([x, x.new_zeros(x.shape[0], -x.shape[1] % TILE, x.shape[2])], dim=1)
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


def check_small_model(config) -> None:
    """Phase 3: f32 forward + decode on the card == the CPU plain path."""
    cfg = copy.deepcopy(config)
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
    with torch.no_grad():
        want = cpu(*(torch.from_numpy(a) for a in inputs))
        got = gpu(*(torch.from_numpy(a).cuda() for a in inputs))
        dec_w = decode_centernet_predictions(want, voxel_size=0.512)
        dec_g = decode_centernet_predictions(got, voxel_size=0.512)
    for k, v in want.items():
        err = (got[k].cpu() - v).abs().max().item()
        scale = max(1.0, v.abs().max().item())
        log(f"  small model {k}: max_abs_err {err:.3g} (scale {scale:.3g})")
        if not err <= 1e-4 * scale:
            raise AssertionError(f"card and CPU disagree on {k}")
    err = (dec_g["scores"].cpu() - dec_w["scores"]).abs().max().item()
    log(f"  small model decoded scores: max_abs_err {err:.3g}")
    if not err <= 1e-4:
        raise AssertionError("decoded scores disagree")


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
        from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.preprocess import normalize_images

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
    """Phase 5: bf16 kernel, plain version, cuBLAS chain, and the bound."""
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
    return {
        "ms": time_ms(lambda: pf.pointnet_fused(x, w, b)),
        "plain_ms": time_ms(lambda: pf.pointnet_fused_reference(x, w, b)),
        "library_ms": time_ms(library),
        "bound_ms": bound,
        "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES else "bytes",
        "gflop": flops / 1e9,
    }


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
    pf.build_library()
    log(f"  built in {time.perf_counter() - t:.1f} s")

    config = load_config("configs/base.yaml")
    spec = DetectorSpec.from_config(config)
    g = torch.Generator().manual_seed(0)
    full = MultiModal3DDetector(spec).init_weights(g).eval()
    encoders = {"lidar": full.lidar_encoder, "radar": full.radar_encoder.shared_radar}
    rng = np.random.RandomState(0)
    calibrate_point_mlp(encoders["lidar"].point_mlp, lidar_points(rng, 2, 4096), g)
    calibrate_point_mlp(encoders["radar"].point_mlp, radar_points(rng, 8, 125), g)

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

    kernels = [{
        "name": "pointnet_fused", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": serve["launches"], "max_abs_err": max_err,
        "ms": lidar_t["ms"], "plain_ms": lidar_t["plain_ms"], "bound_ms": lidar_t["bound_ms"],
        "bound_by": lidar_t["bound_by"], "library_ms": lidar_t["library_ms"],
        "shape": "lidar 8x35000x4 bf16",
        "radar_ms": radar_t["ms"], "radar_plain_ms": radar_t["plain_ms"],
        "radar_bound_ms": radar_t["bound_ms"], "radar_library_ms": radar_t["library_ms"],
    }]
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
