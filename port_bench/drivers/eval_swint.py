"""The port's eval step on `bevfusion_swint_lss` (Swin-T, the LSS-FPN neck,
a 118-bin lift onto a 360x360 camera grid, its 2x downsample to 180x180),
as the eval CLI drives it: `make_eval_step` with the standalone decode
(voxel 0.512, quirk Q3), each batch's outputs taken to the host by
`decode_to_host`, batch after batch.

Traffic parameters, as the ``eval`` driver's: ``batches`` collated batches
of ``batch_size`` distinct seeded samples (``lidar_real``, ``radar_real``),
cycled; ``score_threshold``; ``dtype`` (``f32``, as the CLI runs it); the
frustum cells and chunk plans from the program's own functions on the
six-camera ring, at the encoder's stride and with the camera's z range,
once, at set-up; ``trace_steps``; ``check_samples``. A sample of a batch
that comes back without its detections counts as failed.

Set-up first checks that the program built what the configuration asks
for (a Swin trunk and an 80-channel camera map): a program that ignores
the camera stream's keys fails here, before it is timed.

Faults besides the ``eval`` driver's (``control``: the program's own bf16
path; ``half_batch``; ``answer_altered``): ``no_shift_mask``, the shifted
blocks' attention without the shift's mask, and ``no_rel_bias``, the
relative-position bias left out (the tables zeroed).

End-to-end: ``eval_samples_per_s``, samples evaluated over the window.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from core import common, compare, counts, counts_swint, inputs
from core.harness import Outcome, jax_tree
from reference import model as ref
from reference import swint_lss


def ring_calibration(spec) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """`core.inputs.ring_calibration`'s six cameras with their 1600x900
    intrinsics (f = 1200, c = (800, 450)) taken to the input as BEVFusion
    takes nuScenes images to 256x704: resized by 0.48 x W / 704 and cropped
    to H x W, all of the crop from the top, the columns' evenly."""
    h, w = spec.image_hw
    r = 0.48 * w / 704
    new_h, new_w = int(900 * r), int(1600 * r)
    crop_top, crop_left = new_h - h, int(max(0, new_w - w) / 2)
    intr = np.array([[1200.0 * r, 0, 800 * r - crop_left], [0, 1200.0 * r, 450 * r - crop_top], [0, 0, 1]])
    return [(intr, rot, trans) for _, rot, trans in inputs.ring_calibration(spec)]


def check_program(model, spec) -> None:
    """Raise unless the program built a Swin trunk and a camera map of the
    configuration's width (80 channels), before anything is timed."""
    trunk = getattr(getattr(model, "camera_encoder", None), "trunk", None)
    lift = getattr(getattr(model, "fusion", None), "geometric_camera_bev", None)
    width = getattr(getattr(lift, "feat_proj", None), "out_channels", None)
    if type(trunk).__name__ != "SwinTransformer" or width != spec.cam_c:
        raise RuntimeError(f"the program built a {type(trunk).__name__} trunk and a {width}-channel camera map "
                           f"where the configuration asks for Swin and {spec.cam_c} channels")


def program_plans(pspec, calibration) -> Dict[str, np.ndarray]:
    """The per-sample camera inputs the program makes from a calibration:
    ``camera_cells`` at the encoder's stride on the camera grid, and their
    chunk plans."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import chunk_plans
    from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.bev_splat import precompute_frustum_cells

    h, w = pspec.camera.image_size
    stride, b = pspec.camera.total_stride, pspec.bev
    depths = np.linspace(b.depth_min, b.depth_max, b.depth_bins)
    cells = np.stack([precompute_frustum_cells(intr, rot, trans, (h // stride, w // stride), (h, w), depths,
                                               b.camera_grid, b.pc_range, b.camera_zbound)
                      for intr, rot, trans in calibration])
    plans = chunk_plans(cells, b.camera_grid[0] * b.camera_grid[1])
    return {"camera_cells": cells, **{f"camera_{k}": v for k, v in plans.items()}}


def make_weights(ctx, spec, calibration_samples, cells: torch.Tensor) -> Dict[str, torch.Tensor]:
    """`core.common.make_weights` for this configuration's variables."""
    dev = ctx.device
    variables = swint_lss.make_variables(spec, inputs.generator(ctx.seed, 0, dev), dev)
    cams, lidar, radar = common.sample_tensors(calibration_samples, dev)
    swint_lss.calibrate_statistics(spec, variables, ref.normalize_uint8(cams), lidar, radar, cells)
    del cams, lidar, radar
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return variables


def reference_maps(spec, variables, samples: Sequence[Dict[str, np.ndarray]], device, cells: torch.Tensor,
                   block: int = 4) -> List[Dict[str, torch.Tensor]]:
    """The reference's f32 maps of each sample, in blocks of `block`."""
    out = []
    with torch.no_grad(), ref.exact_float32():
        for i in range(0, len(samples), block):
            cams, lidar, radar = common.sample_tensors(samples[i:i + block], device)
            maps = swint_lss.Forward(spec, variables)(ref.normalize_uint8(cams), lidar, radar, cells)
            out.extend({k: v[j].float() for k, v in maps.items()} for j in range(cams.shape[0]))
    return out


def break_mechanism(model, faults) -> None:
    """The camera stream's faults, put into the program's model."""
    if "no_shift_mask" in faults:
        for m in model.modules():
            if hasattr(m, "attention_mask"):
                m.attention_mask = lambda h, w, device: None
    if "no_rel_bias" in faults:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("relative_position_bias_table"):
                    p.zero_()


def run(ctx) -> Outcome:
    from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, DetectorSpec
    from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import collate_fn
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
    from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.decode import decode_to_host
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import make_eval_step
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.cache import enable_compilation_cache
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables

    spec = swint_lss.Spec(ctx.config)
    pspec, compat = DetectorSpec.from_config(ctx.config), CompatFlags.from_config(ctx.config)
    model = MultiModal3DDetector(pspec, mask_padding=not compat.unmasked_point_padding)
    check_program(model, spec)

    t, dev = ctx.traffic, ctx.device
    enable_compilation_cache()
    bs, nb = t["batch_size"], t["batches"]
    pool = inputs.samples(spec, bs * nb, ctx.seed, dev, t["lidar_real"], t["radar_real"])
    calibration = ring_calibration(spec)
    ref_cells = torch.from_numpy(swint_lss.frustum_cells(spec, calibration)).to(dev)
    variables = make_weights(ctx, spec, pool[:bs], ref_cells)
    extra = program_plans(pspec, calibration)
    batches = [collate_fn([dict(s, **extra) for s in pool[i * bs:(i + 1) * bs]]) for i in range(nb)]

    load_jax_variables(model, jax_tree(variables))
    break_mechanism(model, ctx.faults)
    dtype = torch.bfloat16 if ("control" in ctx.faults or t["dtype"] == "bf16") else torch.float32
    model = model.to(dtype)
    step = make_eval_step(model, compat, eval_path_decode=True, device=dev)
    if "half_batch" in ctx.faults:  # the second half of each batch left out
        whole = step

        def step(batch):
            return whole({k: (v[: bs // 2] if isinstance(v, np.ndarray) and v.shape[:1] == (bs,) else v)
                          for k, v in batch.items()})
    thr = t["score_threshold"]
    for _ in range(2):  # warm-up: cuDNN's plans, the kernels, the allocator
        decode_to_host(step(batches[0]), score_thresh=thr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    results: List = []  # (batch index, detections)
    missing = 0  # samples of a batch that came back without their detections
    sub = common.SubWindow(ctx.trace)
    t0 = ctx.window_opens()
    end = t0 + ctx.seconds
    i = sub_steps = 0
    sub_from = None
    while time.perf_counter() < end:
        if sub_from is None and time.perf_counter() >= t0 + ctx.seconds / 3:
            sub_from = i
            sub.begin()
        dets = decode_to_host(step(batches[i % nb]), score_thresh=thr)
        if "answer_altered" in ctx.faults and dets and len(dets[0]["scores"]):
            dets[0]["boxes"][0, 0] += 0.5
        missing += bs - len(dets)
        results.append((i % nb, dets))
        i += 1
        if sub_from is not None and sub.t1 is None and i - sub_from >= t["trace_steps"]:
            sub.end()
            sub_steps = i - sub_from
    elapsed = time.perf_counter() - t0
    if sub.t0 is not None and sub.t1 is None:
        sub.end()
        sub_steps = i - sub_from
    memory = ctx.memory_peak()
    del step, model
    ctx.free()

    e2e = {"eval_samples_per_s": (i * bs - missing) / elapsed}
    layer_data = {
        "model_flops": counts_swint.model_flops(spec) * sub_steps * bs,
        "sub_window_s": sub.seconds if sub.t0 is not None else None,
        "b2_bytes": counts_swint.b2_bytes(spec, bs, 2 if dtype == torch.bfloat16 else 4) * sub_steps,
        "b1_launch_flops": counts.b1_flops(spec, bs),
        "b1_dtype": "bf16" if dtype == torch.bfloat16 else "f32",
    }
    trace = sub.summary()

    def check() -> Dict[str, float]:
        flat = [(b, j, det) for b, dets in results for j, det in enumerate(dets)]
        chosen = [flat[k] for k in compare.sample_indices(len(flat), t["check_samples"], inputs.host_rng(ctx.seed, 9))]
        uniq = sorted({b * bs + j for b, j, _ in chosen})
        maps = dict(zip(uniq, reference_maps(spec, variables, [pool[k] for k in uniq], dev, ref_cells)))
        return compare.detection_gaps([det for _, _, det in chosen], [maps[b * bs + j] for b, j, _ in chosen],
                                      common.decode_voxel(ctx.config), spec.pc_range, spec.max_detections, thr)

    return Outcome(e2e, i * bs, missing, memory, layer_data, check, trace)
