"""The port's eval step as the eval CLI drives it: `make_eval_step` with the
standalone decode (voxel 0.512, quirk Q3), each batch's outputs taken to
the host by `decode_to_host`, batch after batch.

Traffic parameters: ``batches`` collated batches of ``batch_size``
distinct seeded samples (``lidar_real``, ``radar_real`` as in the serve
driver), cycled; ``score_threshold`` of `decode_to_host`; ``dtype`` of the
model (``f32``, as the CLI runs it); the geometric path's frustum cells and
chunk plans come from the program's own functions on the ring calibration,
once, at set-up; ``trace_steps`` batches in the profiled sub-window;
``check_samples`` evaluated samples the check compares. A sample of a
batch that comes back without its detections counts as failed.

End-to-end: ``eval_samples_per_s``, samples evaluated over the window.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from core import common, compare, counts, inputs
from core.harness import Outcome, jax_tree
from reference.geometry import frustum_cells


def program_plans(ctx) -> Dict[str, np.ndarray]:
    """The geometric path's per-sample inputs, made by the program from the
    ring calibration: ``camera_cells`` and its chunk plans."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import chunk_plans
    from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.bev_splat import precompute_frustum_cells

    spec = ctx.spec
    h, w = spec.image_hw
    depths = np.linspace(spec.depth_min, spec.depth_max, spec.depth_bins)
    cells = np.stack([precompute_frustum_cells(intr, rot, trans, (h // 16, w // 16), (h, w), depths,
                                               (spec.bev_h, spec.bev_w), spec.pc_range)
                      for intr, rot, trans in inputs.ring_calibration(spec)])
    plans = chunk_plans(cells, spec.bev_h * spec.bev_w)
    return {"camera_cells": cells, **{f"camera_{k}": v for k, v in plans.items()}}


def run(ctx) -> Outcome:
    from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, DetectorSpec
    from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import collate_fn
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
    from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.decode import decode_to_host
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import make_eval_step
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.cache import enable_compilation_cache
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables

    t, spec, dev = ctx.traffic, ctx.spec, ctx.device
    enable_compilation_cache()
    bs, nb = t["batch_size"], t["batches"]
    pool = inputs.samples(spec, bs * nb, ctx.seed, dev, t["lidar_real"], t["radar_real"])
    geometric = spec.camera_to_bev == "geometric"
    ref_cells = (torch.from_numpy(frustum_cells(spec, inputs.ring_calibration(spec))).to(dev)
                 if geometric else None)
    variables = common.make_weights(ctx, pool[:bs], ref_cells)
    extra = program_plans(ctx) if geometric else {}
    batches = [collate_fn([dict(s, **extra) for s in pool[i * bs:(i + 1) * bs]]) for i in range(nb)]

    pspec, compat = DetectorSpec.from_config(ctx.config), CompatFlags.from_config(ctx.config)
    model = MultiModal3DDetector(pspec, mask_padding=not compat.unmasked_point_padding)
    load_jax_variables(model, jax_tree(variables))
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
    feature_bytes = 2 if dtype == torch.bfloat16 else 4
    fh, fw = spec.image_hw[0] // 16, spec.image_hw[1] // 16
    layer_data = {
        "model_flops": counts.model_flops(spec) * sub_steps * bs,
        "sub_window_s": sub.seconds if sub.t0 is not None else None,
        "b1_launch_flops": counts.b1_flops(spec, bs),
        "b1_dtype": "bf16" if dtype == torch.bfloat16 else "f32",
        "b2_bytes": (counts.b2_bytes(bs * spec.num_cameras, fh * fw, spec.depth_bins, spec.bev_c,
                                     spec.bev_h * spec.bev_w, feature_bytes) * sub_steps if geometric else None),
    }
    trace = sub.summary()

    def check() -> Dict[str, float]:
        flat = [(b, j, det) for b, dets in results for j, det in enumerate(dets)]
        chosen = [flat[k] for k in compare.sample_indices(len(flat), t["check_samples"], inputs.host_rng(ctx.seed, 9))]
        uniq = sorted({b * bs + j for b, j, _ in chosen})
        maps = dict(zip(uniq, common.reference_maps(spec, variables, [pool[k] for k in uniq], dev, cells=ref_cells)))
        return compare.detection_gaps([det for _, _, det in chosen], [maps[b * bs + j] for b, j, _ in chosen],
                                      common.decode_voxel(ctx.config), spec.pc_range, spec.max_detections, thr)

    return Outcome(e2e, i * bs, missing, memory, layer_data, check, trace)
