"""Training CLI of the port: the surface of the root ``train_detect.py``
(``:22-351``), on one GPU or, data-parallel, one GPU per process:

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect train [config.yaml]
  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect infer [checkpoint]
  python -m torch.distributed.run --nproc_per_node N \
      -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect train config.yaml

Loads the nuScenes infos of ``dataset.data_root`` (uint8 camera wire),
trains ``train.num_epochs`` epochs with a per-step JSONL log in
``train.logging.log_dir``, validates after each epoch (mAP/NDS, written to
``metrics_output.txt``), saves ``checkpoint_epoch_{e}.msgpack`` every
``save_interval`` epochs and at the last one (pruned to ``keep_last``) and
``best_model.msgpack`` on a new best mAP, and resumes from
``train.resume.checkpoint_path`` or, with ``auto``, the newest epoch
checkpoint. The msgpack checkpoints are the JAX package's format both ways.
``train.checkpoint.backend: orbax | orbax_async`` writes directory
checkpoints instead (``checkpoint_epoch_{e}``, ``best_model``; the port's
layout, `train.checkpoint`): every rank writes its part, ZeRO-1's moments
without a gather, and ``orbax_async`` writes behind the next steps, fenced
before ``keep_last`` prunes and at the end, as in the JAX CLI. The
LiDAR encoder's input width follows the data (a fifth, time-lag channel with
``dataset.num_sweeps`` > 1), as the JAX CLI's init traced from a batch gives
it. As in the JAX CLI, the Trainer gets no ``AugmentSpec``: with
``compat.skip_augmentation: false`` the step augments with `AugmentSpec`'s
defaults, not the yaml's ``dataset.augmentation`` values (a followed quirk).

`main(config_path, device=None, config=None)` runs the same from Python
(`device="cpu"` for the CPU). ``infer`` runs `inference`: the first val
sample of ``./data/nuscenes`` through the `InferenceEngine` on
``configs/base.yaml``, without the figure. ``debug.profile: true`` traces
the first epoch with `torch.profiler` into ``<log_dir>/profile``
(`utils.profiling.profile_trace`).

Data parallelism (``parallel:``, root ``train_detect.py:58-170, 229, 246,
298-312``): ``data_parallel: N`` trains on the N processes of one torchrun
node (``WORLD_SIZE`` must be N), the global batch ``train.batch_size``
split into equal row blocks; ``multi_host`` trains on every process of every
node, each node reading its strided share of the epoch, the global batch
``nnodes x batch_size``; ``shard_optimizer`` shards the AdamW moments
(ZeRO-1). The process group is NCCL on CUDA and gloo on the CPU. Only the
global rank 0 writes the per-step log, ``metrics_output.txt`` and the
checkpoints; with several nodes the scalar metrics are averaged over them.
``view_parallel: V`` adds the camera-view axis: ``data_parallel x V``
processes a node (with ``multi_host``, ``world / V`` data indices), the
cameras of a data index's rows split over its V ranks, and with
``bev_spatial`` the head's BEV rows too (`parallel.view`); as in the JAX
CLI, ``bev_spatial`` acts only with V > 1, and where ``bev_h`` does not
divide by V it warns and is skipped. ``multi_host`` with
``shard_optimizer`` needs a directory backend: msgpack is refused, with
the JAX CLI's words.
"""

from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from .config import CompatFlags, DataSpec, DetectorSpec, ParallelSpec, PostProcessSpec, TrainSpec, load_config
from .data.dataset import DataLoader, NuScenesDataset, collate_fn
from .models.detector import MultiModal3DDetector
from .parallel import all_processes_mean, make_data_group, maybe_initialize, rank_layout
from .train.checkpoint import is_committed_checkpoint, latest_checkpoint, wait_for_checkpoints
from .train.loop import Trainer, with_data_widths
from .utils.cache import enable_compilation_cache
from .utils.metrics import save_and_print_metrics
from .utils.profiling import profile_trace


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
    enable_compilation_cache()
    if config is None:
        config = load_config(config_path or "configs/base.yaml")
    par = ParallelSpec.from_config(config)
    spec = DetectorSpec.from_config(config)
    train_spec = TrainSpec.from_config(config)
    data_spec = DataSpec.from_config(config)
    compat = CompatFlags.from_config(config)
    if par.multi_host and par.shard_optimizer and train_spec.ckpt_backend == "msgpack":
        # the JAX CLI's refusal (its msgpack gathers host-locally)
        raise SystemExit(
            "parallel.shard_optimizer with multi_host requires an orbax checkpoint backend "
            "(train.checkpoint.backend: orbax|orbax_async): msgpack gathers host-locally and cannot "
            "serialize cross-host optimizer shards"
        )
    group = None
    if maybe_initialize(par.multi_host or par.data_parallel > 1 or par.view_parallel > 1, par.coordinator_address,
                        par.num_processes, par.process_id, device=device):
        group = make_data_group(par.data_parallel, par.view_parallel, multi_host=par.multi_host)
    elif rank_layout().world_size > 1:
        raise ValueError(
            f"{rank_layout().world_size} processes run, but parallel.data_parallel and view_parallel are 1 and "
            "parallel.multi_host is off: each would train alone and write the same files"
        )
    bev_spatial = False
    if group is not None and par.bev_spatial and group.n_view > 1:
        # root train_detect.py:121-137: the BEV rows over the view axis
        if spec.bev.bev_h % group.n_view == 0:
            bev_spatial = True
        else:
            print(
                f"Warning: parallel.bev_spatial needs bev_h ({spec.bev.bev_h}) divisible by view_parallel "
                f"({group.n_view}); skipping the spatial constraint"
            )
    is_main = group is None or group.rank == 0
    node, nodes = (0, 1) if group is None else (group.layout.node, group.layout.num_nodes)
    print(f"Model: {spec.modality_string()} / {spec.fusion_type} / {spec.detection_head}")
    if group is not None:
        print(f"Data parallel: rank {group.rank} of {group.size}, node {node} of {nodes}")
        if group.n_view > 1:
            print(f"View parallel: data index {group.data_index} of {group.n_data}, view {group.view_index} of "
                  f"{group.n_view}{', BEV rows split' if bev_spatial else ''}")

    # uint8 wire: images ship as raw bytes and are normalized on the device
    train_ds = NuScenesDataset(data_root=data_spec.data_root, split="train", config=config,
                               seed=train_spec.seed, emit_uint8=True)
    val_ds = NuScenesDataset(data_root=data_spec.data_root, split="val", config=config,
                             seed=train_spec.seed, emit_uint8=True)
    # each node reads its strided share of the epoch
    train_loader = DataLoader(train_ds, batch_size=train_spec.batch_size, shuffle=True,
                              drop_last=True, seed=train_spec.seed, process_index=node, process_count=nodes)
    val_loader = DataLoader(val_ds, batch_size=train_spec.batch_size, process_index=node, process_count=nodes)
    if len(train_loader) == 0:
        raise SystemExit(
            f"train loader produced no batches: {len(train_ds)} samples (per-process) < batch_size "
            f"{train_spec.batch_size} with drop_last — reduce train.batch_size or add data"
        )

    # the JAX CLI traces its init from a batch: the LiDAR width is the data's
    sample = collate_fn([train_ds[0]])
    model = MultiModal3DDetector(with_data_widths(spec, sample), mask_padding=not compat.unmasked_point_padding,
                                 bev_spatial=bev_spatial)
    trainer = Trainer(
        model, train_spec, compat, steps_per_epoch=len(train_loader),
        check_gradients=(config.get("debug", {}) or {}).get("check_gradients", False),
        device=device, process_group=group, shard_optimizer=par.shard_optimizer,
    )
    trainer.init_state(sample)
    print(f"Device: {trainer.device}")

    start_epoch = 0
    if train_spec.resume_enable:
        resume_path = train_spec.resume_path
        if not resume_path and train_spec.resume_auto:
            resume_path, _ = latest_checkpoint(train_spec.save_dir)
        if resume_path:
            start_epoch = trainer.load_checkpoint(resume_path) + 1
            if is_main:
                print(f"Resumed from {resume_path} at epoch {start_epoch}")

    save_dir = Path(train_spec.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    log_dir = Path(((config.get("train", {}) or {}).get("logging", {}) or {}).get("log_dir", "./logs"))
    log_dir.mkdir(parents=True, exist_ok=True)
    log_file = str(log_dir / "train_log.jsonl") if is_main else None
    keep_last = ((config.get("train", {}) or {}).get("checkpoint", {}) or {}).get("keep_last", 0)
    pp = PostProcessSpec.resolve(config, compat, "val", 0.0)
    # debug.profile (dead in the reference, configs/base.yaml:643): trace
    # the first epoch this run trains
    profile = (config.get("debug", {}) or {}).get("profile", False)
    log_every = 10 if is_main else 0
    backend = train_spec.ckpt_backend
    suffix = ".msgpack" if backend == "msgpack" else ""

    for epoch in range(start_epoch, train_spec.num_epochs):
        t0 = time.time()
        if profile and epoch == start_epoch:
            with profile_trace(str(log_dir / "profile")):
                avg_loss = trainer.train_one_epoch(train_loader, log_every=log_every, log_file=log_file)
        else:
            avg_loss = trainer.train_one_epoch(train_loader, log_every=log_every, log_file=log_file)
        if is_main:
            print(f"Epoch {epoch}: loss={avg_loss:.4f} ({time.time() - t0:.1f}s)")
        if (epoch + 1) % train_spec.save_interval == 0 or epoch + 1 == train_spec.num_epochs:
            # every rank enters: under msgpack rank 0 writes (ZeRO gathers
            # the moments) and the others wait until it has; under the
            # directory backends every rank writes its part
            trainer.save_checkpoint(str(save_dir / f"checkpoint_epoch_{epoch}{suffix}"), epoch, backend=backend)
            if keep_last and keep_last > 0 and is_main:
                # the write in flight is committed before an older one goes
                wait_for_checkpoints()
                _prune(save_dir, keep_last)
        metrics = trainer.evaluate(val_loader, post_process=pp)
        if nodes > 1:
            # each node validated its share of the split: average the
            # scalar metrics over the nodes (per-class lists stay the node's)
            scalars = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
            metrics = {**metrics, **all_processes_mean(scalars)}
        if is_main:
            save_and_print_metrics(metrics, "metrics_output.txt")
        if train_spec.save_best and metrics["mAP"] > trainer.best_map:
            trainer.best_map = metrics["mAP"]
            trainer.save_checkpoint(str(save_dir / f"best_model{suffix}"), epoch, backend=backend)
            if is_main:
                print(f"New best mAP {trainer.best_map:.4f} — saved best_model")
    wait_for_checkpoints()  # the background write in flight is committed before returning
    return trainer


def inference(model_path: str, data_root: str = "./data/nuscenes", device=None) -> Dict:
    """Quick single-sample inference; returns `run_inference`'s result."""
    from .inference_engine import InferenceEngine

    enable_compilation_cache()
    engine = InferenceEngine(model_path=model_path, device=device)
    ds = NuScenesDataset(data_root=data_root, split="val")
    return engine.run_inference(ds[0], visualize=False)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "train":
        main(sys.argv[2] if len(sys.argv) > 2 else None)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    elif len(sys.argv) > 1 and sys.argv[1] == "infer":
        inference(sys.argv[2] if len(sys.argv) > 2 else "./checkpoints/best_model.msgpack")
    else:
        print("Usage:")
        print("  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect train [config.yaml]")
        print("  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.train_detect infer [checkpoint]")
