"""The port's train step as the training CLI drives it: `make_train_step`
over `make_optimizer` from the configuration (compat defaults: f32,
AdamW, the global-norm clip, a constant rate), its loss read each step as
`Trainer._epoch_inner` reads it.

Traffic parameters: ``batches`` collated batches of ``batch_size``
distinct seeded samples (``lidar_real``, ``radar_real`` as in the serve
driver), each sample with U[``boxes``] real ground-truth boxes, cycled;
``checked_steps`` steps run at set-up to warm up, after which the same
model and optimizer go back to the seeded state, and the window's own first
``checked_steps`` steps are the ones the reference follows; ``trace_steps``
steps in the profiled sub-window.

End-to-end: ``train_samples_per_s``, samples trained over the window.
"""

from __future__ import annotations

import copy
import time
from typing import Dict

import numpy as np
import torch

from core import common, compare, counts, inputs
from core.harness import Outcome, jax_tree
from reference import train as rtrain


def _norms_by_leaf(model, tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per-parameter norms of `tensors` (keyed by the model's parameter
    names) under the variables' flat names: the module path is the flax
    path, and a BatchNorm's weight is its ``scale``, any other weight a
    ``kernel``."""
    out = {}
    for name, t in tensors.items():
        path, _, leaf = name.rpartition(".")
        if leaf == "weight":
            is_bn = isinstance(model.get_submodule(path), torch.nn.modules.batchnorm._BatchNorm)
            leaf = "scale" if is_bn else "kernel"
        out["params/" + "/".join(path.split(".") + [leaf])] = float(torch.linalg.vector_norm(t.double()))
    return out


def reset_optimizer(train_step) -> None:
    """The optimizer as before its first update, in place: AdamW's moments
    and step counts zeroed (its next step is then a first step) and the
    update and step counts back to 0."""
    for state in train_step.optimizer.adamw.state.values():
        for value in state.values():
            if torch.is_tensor(value):
                value.zero_()
    train_step.optimizer.updates = 0
    train_step.step = 0


def run(ctx) -> Outcome:
    from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, DetectorSpec, TrainSpec
    from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import collate_fn
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import make_optimizer, make_train_step
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables

    t, spec, dev = ctx.traffic, ctx.spec, ctx.device
    cfg = copy.deepcopy(ctx.config)
    if "control" in ctx.faults:  # the program's own bf16 mixed precision
        cfg.setdefault("compat", {})["ignore_mixed_precision"] = False
        cfg.setdefault("train", {}).setdefault("mixed_precision", {})["enable"] = True
    bs, nb = t["batch_size"], t["batches"]
    pool = inputs.samples(spec, bs * nb, ctx.seed, dev, t["lidar_real"], t["radar_real"])
    boxes, labels = inputs.gt_boxes(spec, bs * nb, t["max_objects"], t["boxes"], ctx.seed)
    variables = common.make_weights(ctx, pool[:bs])
    batches = []
    for i in range(nb):
        b = collate_fn(pool[i * bs:(i + 1) * bs])
        b["gt_boxes"], b["gt_labels"] = boxes[i * bs:(i + 1) * bs], labels[i * bs:(i + 1) * bs]
        batches.append(b)

    pspec, compat, train_spec = DetectorSpec.from_config(cfg), CompatFlags.from_config(cfg), TrainSpec.from_config(cfg)
    model = MultiModal3DDetector(pspec, mask_padding=not compat.unmasked_point_padding)
    tree = jax_tree(variables)
    load_jax_variables(model, tree)
    train_step = step = make_train_step(model, make_optimizer(train_spec, compat, nb), train_spec, compat, device=dev)
    if "unchanged" in ctx.faults:
        train_step.optimizer.update = lambda grads: True
    if "half_batch" in ctx.faults:
        run_step = step.__call__

        def halved(batch):
            half = {k: (v[: bs // 2] if isinstance(v, np.ndarray) and v.shape[:1] == (bs,) else v)
                    for k, v in batch.items()}
            return run_step(half)
        step = halved
    names = dict(model.named_parameters())

    def call(batch) -> float:
        loss = float(step(batch)["total_loss"])
        return loss * 1.5 if "answer_altered" in ctx.faults else loss

    checked = t["checked_steps"]
    for i in range(checked):  # warm-up: cuDNN's plans, the allocator, the optimizer's state
        call(batches[i])
    # Back to the seeded state on the same objects, so that the window's own
    # first steps are the ones the reference follows.
    load_jax_variables(model, tree)
    reset_optimizer(train_step)
    del tree
    start = {k: p.detach().clone() for k, p in names.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    losses, first_moment, change = [], None, None
    sub = common.SubWindow(ctx.trace)
    t0 = ctx.window_opens()
    end = t0 + ctx.seconds
    i, sub_from, sub_steps = 0, None, 0
    while time.perf_counter() < end or i < checked:
        if sub_from is None and time.perf_counter() >= t0 + ctx.seconds / 3:
            sub_from = i
            sub.begin()
        loss = call(batches[i % nb])
        i += 1
        if i <= checked:
            losses.append(loss)
            if i == 1:
                adamw = train_step.optimizer.adamw
                first_moment = {k: adamw.state[p]["exp_avg"].clone() if p in adamw.state else torch.zeros_like(p)
                                for k, p in names.items()}
            if i == checked:
                change = {k: p.detach() - start[k] for k, p in names.items()}
                del start
        if sub_from is not None and sub.t1 is None and i - sub_from >= t["trace_steps"]:
            sub.end()
            sub_steps = i - sub_from
    elapsed = time.perf_counter() - t0
    if sub.t0 is not None and sub.t1 is None:
        sub.end()
        sub_steps = i - sub_from
    memory = ctx.memory_peak()
    got = {"losses": losses, "first_moment": _norms_by_leaf(model, first_moment),
           "change": _norms_by_leaf(model, change)}
    del step, train_step, model, names, first_moment, change
    ctx.free()

    e2e = {"train_samples_per_s": i * bs / elapsed}
    layer_data = {
        "model_flops": 3 * counts.model_flops(spec) * sub_steps * bs,
        "sub_window_s": sub.seconds if sub.t0 is not None else None,
    }
    trace = sub.summary()

    def check() -> Dict[str, float]:
        ref_batches = []
        for b in batches[: t["checked_steps"]]:
            cams, lidar, radar = (torch.from_numpy(b[k]).to(dev) for k in ("camera_imgs", "lidar_points", "radar_points"))
            ref_batches.append({"cams": cams, "lidar": lidar, "radar": radar,
                                "boxes": torch.from_numpy(b["gt_boxes"]).to(dev),
                                "labels": torch.from_numpy(b["gt_labels"]).to(dev)})
        want = rtrain.train_steps(spec, variables, ref_batches, train_spec.learning_rate, train_spec.betas,
                                  train_spec.eps, train_spec.weight_decay, train_spec.grad_clip_norm)
        want = {"losses": want["losses"], "first_grad": rtrain.leaf_norms(want["first_grad"]),
                "change": rtrain.leaf_norms(want["change"])}
        return compare.train_gaps(got, want, train_spec.betas[0])

    return Outcome(e2e, i, 0, memory, layer_data, check, trace)

