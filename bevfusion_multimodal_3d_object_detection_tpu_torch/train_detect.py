"""Training CLI of the port: the surface of the root ``train_detect.py``
(``:22-351``), on one GPU:

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect train [config.yaml]
  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect infer [checkpoint]

Loads the nuScenes infos of ``dataset.data_root`` (uint8 camera wire),
trains ``train.num_epochs`` epochs with a per-step JSONL log in
``train.logging.log_dir``, validates after each epoch (mAP/NDS, written to
``metrics_output.txt``), saves ``checkpoint_epoch_{e}.msgpack`` every
``save_interval`` epochs and at the last one (pruned to ``keep_last``) and
``best_model.msgpack`` on a new best mAP, and resumes from
``train.resume.checkpoint_path`` or, with ``auto``, the newest epoch
checkpoint. The checkpoints are the JAX package's format both ways.

`main(config_path, device=None, config=None)` runs the same from Python
(`device="cpu"` for the CPU). ``infer`` runs `inference`: the first val
sample of ``./data/nuscenes`` through the `InferenceEngine` on
``configs/base.yaml``, without the figure. Not ported: ``debug.profile``
(ROADMAP A12) and ``parallel.*`` (A13); each raises.
"""

from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from .config import CompatFlags, DataSpec, DetectorSpec, PostProcessSpec, TrainSpec, load_config
from .data.dataset import DataLoader, NuScenesDataset
from .models.detector import MultiModal3DDetector
from .train.checkpoint import is_committed_checkpoint, latest_checkpoint
from .train.loop import Trainer
from .utils.metrics import save_and_print_metrics


def _refuse_unported(config: Dict) -> None:
    debug = config.get("debug", {}) or {}
    if debug.get("profile", False):
        raise NotImplementedError("debug.profile is not ported yet (ROADMAP A12)")
    par = config.get("parallel", {}) or {}
    multi_host = par.get("multi_host", {})
    if isinstance(multi_host, dict):
        multi_host = multi_host.get("enable", False)
    if (par.get("data_parallel", 1) > 1 or par.get("view_parallel", 1) > 1 or multi_host
            or par.get("shard_optimizer", False) or par.get("bev_spatial", False)):
        raise NotImplementedError(
            "parallel.* (data/view parallelism, ZeRO, BEV spatial, multi-host) "
            "is not ported yet (ROADMAP A13)"
        )
    backend = TrainSpec.from_config(config).ckpt_backend
    if backend != "msgpack":
        raise NotImplementedError(
            f"train.checkpoint.backend: {backend} needs orbax, which stays with the JAX package"
        )


def _epoch_of(p: Path) -> Optional[int]:
    try:
        return int(p.stem.replace("checkpoint_epoch_", "").split(".")[0])
    except ValueError:
        return None


def _prune(save_dir: Path, keep_last: int) -> None:
    """Delete all but the newest `keep_last` committed epoch checkpoints."""
    ckpts = sorted(
        (p for p in save_dir.glob("checkpoint_epoch_*")
         if is_committed_checkpoint(p) and _epoch_of(p) is not None),
        key=_epoch_of,
    )
    for old in ckpts[:-keep_last]:
        if old.is_dir():
            shutil.rmtree(old)
        else:
            old.unlink()


def main(config_path: Optional[str] = None, device=None, config: Optional[Dict] = None) -> Trainer:
    """Train as the CLI does, from `config_path` (or an already loaded
    `config` dict); returns the Trainer."""
    if config is None:
        config = load_config(config_path or "configs/base.yaml")
    _refuse_unported(config)
    spec = DetectorSpec.from_config(config)
    train_spec = TrainSpec.from_config(config)
    data_spec = DataSpec.from_config(config)
    compat = CompatFlags.from_config(config)
    print(f"Model: {spec.modality_string()} / {spec.fusion_type} / {spec.detection_head}")

    # uint8 wire: images ship as raw bytes and are normalized on the device
    train_ds = NuScenesDataset(data_root=data_spec.data_root, split="train", config=config,
                               seed=train_spec.seed, emit_uint8=True)
    val_ds = NuScenesDataset(data_root=data_spec.data_root, split="val", config=config,
                             seed=train_spec.seed, emit_uint8=True)
    train_loader = DataLoader(train_ds, batch_size=train_spec.batch_size, shuffle=True,
                              drop_last=True, seed=train_spec.seed)
    val_loader = DataLoader(val_ds, batch_size=train_spec.batch_size)
    if len(train_loader) == 0:
        raise SystemExit(
            f"train loader produced no batches: {len(train_ds)} samples < batch_size "
            f"{train_spec.batch_size} with drop_last — reduce train.batch_size or add data"
        )

    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding)
    trainer = Trainer(
        model, train_spec, compat, steps_per_epoch=len(train_loader),
        check_gradients=(config.get("debug", {}) or {}).get("check_gradients", False),
        device=device,
    )
    trainer.init_state()
    print(f"Device: {trainer.device}")

    start_epoch = 0
    if train_spec.resume_enable:
        resume_path = train_spec.resume_path
        if not resume_path and train_spec.resume_auto:
            resume_path, _ = latest_checkpoint(train_spec.save_dir)
        if resume_path:
            start_epoch = trainer.load_checkpoint(resume_path) + 1
            print(f"Resumed from {resume_path} at epoch {start_epoch}")

    save_dir = Path(train_spec.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    log_dir = Path(((config.get("train", {}) or {}).get("logging", {}) or {}).get("log_dir", "./logs"))
    log_dir.mkdir(parents=True, exist_ok=True)
    log_file = str(log_dir / "train_log.jsonl")
    keep_last = ((config.get("train", {}) or {}).get("checkpoint", {}) or {}).get("keep_last", 0)
    pp = None if compat.ignore_post_processing_config else PostProcessSpec.from_config(config, "val")

    for epoch in range(start_epoch, train_spec.num_epochs):
        t0 = time.time()
        avg_loss = trainer.train_one_epoch(train_loader, log_file=log_file)
        print(f"Epoch {epoch}: loss={avg_loss:.4f} ({time.time() - t0:.1f}s)")
        if (epoch + 1) % train_spec.save_interval == 0 or epoch + 1 == train_spec.num_epochs:
            trainer.save_checkpoint(str(save_dir / f"checkpoint_epoch_{epoch}.msgpack"), epoch)
            if keep_last and keep_last > 0:
                _prune(save_dir, keep_last)
        metrics = trainer.evaluate(val_loader, post_process=pp)
        save_and_print_metrics(metrics, "metrics_output.txt")
        if train_spec.save_best and metrics["mAP"] > trainer.best_map:
            trainer.best_map = metrics["mAP"]
            trainer.save_checkpoint(str(save_dir / "best_model.msgpack"), epoch)
            print(f"New best mAP {trainer.best_map:.4f} — saved best_model")
    return trainer


def inference(model_path: str, data_root: str = "./data/nuscenes", device=None) -> Dict:
    """Quick single-sample inference; returns `run_inference`'s result."""
    from .inference_engine import InferenceEngine

    engine = InferenceEngine(model_path=model_path, device=device)
    ds = NuScenesDataset(data_root=data_root, split="val")
    return engine.run_inference(ds[0], visualize=False)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "train":
        main(sys.argv[2] if len(sys.argv) > 2 else None)
    elif len(sys.argv) > 1 and sys.argv[1] == "infer":
        inference(sys.argv[2] if len(sys.argv) > 2 else "./checkpoints/best_model.msgpack")
    else:
        print("Usage:")
        print("  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect train [config.yaml]")
        print("  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect infer [checkpoint]")
