"""Evaluation CLI of the port: the surface of the root ``eval.py``
(``:26-205``), on one GPU:

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.eval <anything> <config.yaml>

Quirk Q10 as in the reference: argv[2] is the config and argv[1] is
ignored; the MODEL is always built from ``configs/base.yaml`` in the working
directory, and the config (when given) only sets the loader, the
post-processing and the metrics options. The LiDAR encoder's input width
is the loader's (5 with ``dataset.num_sweeps`` > 1), as the JAX CLI's init
traced from the first val sample gives it.

Pipeline: the val split (float cameras, f32 forward) -> restore of
``./checkpoints/best_model.msgpack`` or, where there is none, of the
committed directory ``./checkpoints/best_model`` that the ``orbax``
backends write (the JAX eval CLI reads the ``.msgpack`` alone; exit 1 when
neither is there, unless ``BMOD_ALLOW_RANDOM_INIT=1``) -> forward + the eval-path decode (voxel
0.512, Q3) at score 0.0 (Q16), or the resurrected ``val.post_processing``
when the config's ``compat.ignore_post_processing_config`` is off ->
mAP/NDS in ``eval_results/eval_metrics_output.txt``, with
``metrics.use_official`` the official-style metrics in
``eval_results/eval_metrics_official.txt``, and with
``metrics.save_submission: <path>`` a nuScenes ``submission.json``.

`main(config_path, device=None)` runs the same from Python
(`device="cpu"` for the CPU). A model config with the MLP head (attention
or late fusion) raises at the start: this pipeline decodes CenterNet maps,
and the JAX eval CLI fails on the MLP head's outputs at its decode.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def main(config_path: Optional[str] = None, device=None) -> Dict:
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from .config import CompatFlags, DetectorSpec, PostProcessSpec, TrainSpec, load_config
    from .data.dataset import DataLoader, NuScenesDataset, collate_fn
    from .models.detector import MultiModal3DDetector
    from .ops.decode import decode_to_host
    from .train.checkpoint import is_committed_checkpoint
    from .train.loop import Trainer, make_eval_step, with_data_widths
    from .utils.metrics import compute_metrics, save_and_print_metrics

    # Q10: without a config the loader takes defaults, but the model is
    # built from configs/base.yaml all the same
    model_config = load_config("configs/base.yaml")
    loader_config = load_config(config_path) if config_path else None

    spec = DetectorSpec.from_config(model_config)
    if not spec.head_is_centernet:
        # JAX's eval.py gets that far and fails in decode_to_host on {'cls', 'box'}
        raise ValueError(
            f"the eval CLI decodes CenterNet maps only; fusion_type={spec.fusion_type!r} builds the MLP "
            "head (the JAX eval CLI fails on it as well); Trainer.evaluate scores such a model"
        )
    compat = CompatFlags.from_config(model_config)
    train_spec = TrainSpec.from_config(loader_config or model_config)

    data_root = "./data/nuscenes"
    if loader_config:
        data_root = (loader_config.get("dataset", {}) or {}).get("data_root", data_root)
    val_ds = NuScenesDataset(data_root=data_root, split="val", config=loader_config or model_config, seed=42)
    val_loader = DataLoader(val_ds, batch_size=train_spec.batch_size)

    sample = collate_fn([val_ds[0]])
    model = MultiModal3DDetector(with_data_widths(spec, sample), mask_padding=not compat.unmasked_point_padding)
    trainer = Trainer(model, train_spec, compat, device=device).init_state(sample)

    ckpt = Path("./checkpoints/best_model.msgpack")
    if not ckpt.exists() and is_committed_checkpoint(Path("./checkpoints/best_model")):
        ckpt = Path("./checkpoints/best_model")  # a directory backend's
    if ckpt.exists():
        trainer.load_checkpoint(str(ckpt))
        print(f"Loaded checkpoint {ckpt}")
    else:
        # no metric files from random weights unless asked for
        if os.environ.get("BMOD_ALLOW_RANDOM_INIT") != "1":
            print(f"Error: {ckpt} not found — refusing to evaluate random init "
                  f"(set BMOD_ALLOW_RANDOM_INIT=1 to override)")
            sys.exit(1)
        print(f"Warning: {ckpt} not found — evaluating random init")

    eval_step = make_eval_step(model, compat, eval_path_decode=True, device=trainer.device)

    # the post-processing gate and its values come from the user's config;
    # the Q10 model config only builds the model; score 0.0 is Q16's
    pp_compat = CompatFlags.from_config(loader_config) if loader_config else compat
    pp = PostProcessSpec.resolve(loader_config or model_config, pp_compat, "val", 0.0)

    predictions, ground_truths = [], []
    for batch in val_loader:
        dets = decode_to_host(eval_step(batch), score_thresh=pp.score_threshold, nms_thresh=pp.nms_threshold,
                              max_detections=pp.max_detections)
        predictions.extend(dets)
        for bi in range(len(dets)):
            ground_truths.append({"boxes": np.asarray(batch["gt_boxes"][bi]),
                                  "labels": np.asarray(batch["gt_labels"][bi])})

    metrics = compute_metrics(
        predictions, ground_truths, num_classes=spec.num_classes,
        report_class_order="reference" if compat.metric_report_class_order else "dataset",
    )
    out_dir = Path("eval_results")
    out_dir.mkdir(exist_ok=True)
    save_and_print_metrics(metrics, str(out_dir / "eval_metrics_output.txt"))

    metrics_cfg = (loader_config or model_config).get("metrics", {}) or {}
    if metrics_cfg.get("use_official", False):
        from .utils.metrics import compute_metrics_official

        official = compute_metrics_official(
            predictions, ground_truths, num_classes=spec.num_classes,
            dist_ths=tuple((metrics_cfg.get("nuscenes", {}) or {}).get("dist_ths", (0.5, 1.0, 2.0, 4.0))),
        )
        save_and_print_metrics(official, str(out_dir / "eval_metrics_official.txt"))

    # LiDAR-frame detections to the global frame through the infos' poses
    sub_path = metrics_cfg.get("save_submission")
    if sub_path:
        from .utils.submission import export_nuscenes_submission

        export_nuscenes_submission(
            predictions, val_ds.infos[: len(predictions)], str(sub_path), classes=tuple(val_ds.classes),
            use_camera=spec.use_camera, use_lidar=spec.use_lidar, use_radar=spec.use_radar,
        )
        print(f"Submission written to {sub_path}")
    return metrics


if __name__ == "__main__":
    # argv[2] is the config (quirk Q10)
    main(sys.argv[2] if len(sys.argv) > 2 else None)
