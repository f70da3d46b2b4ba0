"""Processes of the port's data-parallel CPU tests (tests/test_torch_parallel*.py).

`launch(jobs, world)` starts `world` processes of this file over gloo, with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free port),
runs the named functions of this module in each, in order, and returns
each rank's list of results. The process group has a timeout and so has
every process: a hang fails the test, not the suite. `nodes` > 1 lays the
processes out as torchrun does across nodes (``GROUP_RANK``).

The job functions run in the parent too, without a process group, as the
single-process reference.
"""

from __future__ import annotations

import contextlib
import copy
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
INIT_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(jobs: Sequence[Tuple[str, Dict]], world: int = 2, nodes: int = 1, timeout_s: float = 150.0,
           cwd: Optional[Path] = None, during: Optional[Callable] = None):
    """Run `jobs` ((function name, kwargs), in order) in `world` processes
    over gloo; returns each rank's results, and with `during` (called here
    while the processes run) also its result."""
    port = free_port()
    per_node = world // nodes
    with tempfile.TemporaryDirectory(prefix="torch_parallel_") as tmp:
        job_path = Path(tmp) / "jobs.pkl"
        job_path.write_bytes(pickle.dumps(list(jobs)))
        procs, logs = [], []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % per_node),
                       LOCAL_WORLD_SIZE=str(per_node), GROUP_RANK=str(rank // per_node),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                       PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
            log = open(Path(tmp) / f"rank{rank}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(job_path), str(Path(tmp) / f"out{rank}.pkl")],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(cwd or tmp)))
        try:
            mine = during() if during is not None else None
            for p in procs:
                p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"rank {rank} exited {p.returncode}:\n" + outputs[rank][-6000:])
        ranks = [pickle.loads((Path(tmp) / f"out{rank}.pkl").read_bytes()) for rank in range(world)]
        return ranks if during is None else (ranks, mine)


def _worker(job_path: str, out_path: str) -> None:
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import maybe_initialize

    maybe_initialize(True, device="cpu", timeout_s=INIT_TIMEOUT_S)
    jobs = pickle.loads(Path(job_path).read_bytes())
    results = [globals()[name](**kwargs) for name, kwargs in jobs]
    Path(out_path).write_bytes(pickle.dumps(results))
    torch.distributed.destroy_process_group()


def parallel_batches(spec, n_steps: int = 3, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Node batches of 4 rows whose halves differ: rows 0-1 (rank 0 of two)
    hold 1 and 2 boxes and cameras about 0, rows 2-3 (rank 1) 5 and 6 boxes
    and cameras about 1, so each half's positives and BatchNorm statistics
    differ from the whole batch's. Float cameras, 9-column boxes, labels
    -1 on the padded rows."""
    rng = np.random.RandomState(seed)
    h, w = spec.camera.image_size
    out = []
    for _ in range(n_steps):
        cams = rng.randn(4, 6, h, w, 3).astype(np.float32)
        cams[2:] += 1.0
        lidar = rng.randn(4, spec.lidar.max_points, spec.lidar.input_channels).astype(np.float32)
        lidar[:, spec.lidar.max_points // 2:] = 0.0
        radar = rng.randn(4, spec.radar.num_radars, spec.radar.max_points_per_sensor,
                          spec.radar.input_channels).astype(np.float32)
        radar[:, :, spec.radar.max_points_per_sensor // 2:] = 0.0
        boxes = np.zeros((4, 8, 9), np.float32)
        labels = np.full((4, 8), -1, np.int64)
        x0, y0, _, x1, y1, _ = spec.bev.pc_range
        for b, n in enumerate((1, 2, 5, 6)):
            boxes[b, :n, 0] = rng.uniform(0.9 * x0, 0.9 * x1, n)
            boxes[b, :n, 1] = rng.uniform(0.9 * y0, 0.9 * y1, n)
            boxes[b, :n, 2] = rng.uniform(-2, 1, n)
            boxes[b, :n, 3:6] = rng.uniform(1, 6, (n, 3))
            boxes[b, :n, 6] = rng.uniform(-3, 3, n)
            boxes[b, :n, 7:] = rng.randn(n, 2)
            labels[b, :n] = rng.randint(0, 10, n)
        out.append({"camera_imgs": cams, "lidar_points": lidar, "radar_points": radar,
                    "gt_boxes": boxes, "gt_labels": labels})
    return out


def tensor_error(got: dict, want: dict, floor_share: float = 0.0) -> float:
    """The worst of each tensor's error over its own largest, or over
    `floor_share` of the largest of all where that is more."""
    floor = floor_share * max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        top = max(float(w.abs().max()), floor)
        if top > 0:
            worst = max(worst, float((got[name] - w).abs().max()) / top)
    return worst


def relative_errors(got: dict, want: dict) -> dict:
    """Each record part's worst error: losses relative, tensors over their
    own largest. A first moment whose largest is below 1e-9 of the largest
    of all (a bias right before a BatchNorm: its gradient is 0 but for
    rounding) is measured against that floor."""
    return {"losses": max(abs(got["losses"][k] - v) / abs(v) for k, v in want["losses"].items() if v),
            "state": tensor_error(got["state"], want["state"]),
            "mu": tensor_error(got["mu"], want["mu"], 1e-9)}


# -- jobs -------------------------------------------------------------------


_GROUPS: Dict[Tuple[bool, int], object] = {}


def data_group(multi_host: bool = False, n_view: int = 1):
    """The ('data', 'view') layout of the launched processes, made once a
    process for each (multi_host, n_view) and shared by its jobs; None
    without a process group (the reference in the parent)."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import make_data_group

    if not torch.distributed.is_initialized():
        return None
    key = (multi_host, n_view)
    if key not in _GROUPS:
        _GROUPS[key] = make_data_group(n_view=n_view, multi_host=multi_host)
    return _GROUPS[key]


def _record(trainer, losses) -> Dict:
    """Losses, state (float64) and AdamW first moments of a step."""
    opt = trainer._full_optimizer()
    return {
        "losses": {k: float(v) for k, v in losses.items()},
        "state": {k: v.detach().double().clone() for k, v in trainer.model.state_dict().items()},
        "mu": {n: opt.adamw.state[p]["exp_avg"].detach().double().clone()
               for n, p in trainer.model.named_parameters()},
    }


def train_steps(spec, state, batches, dtype=torch.float64, skip_augmentation: bool = True,
                shard_optimizer: bool = False, mutant: Optional[str] = None, multi_host: bool = False,
                checkpoint: Optional[str] = None, n_view: int = 1, bev_spatial: bool = False,
                single: bool = False) -> Dict:
    """A Trainer of `spec` holding `state`, through the batches (each the
    node's batch), with check_gradients: one record a step. `mutant`
    ``"bn"`` takes the BatchNorm statistics of each rank's rows alone,
    ``"num_pos"`` the focal loss's positives of each rank's rows alone, and
    the view axis's (`n_view` > 1) are `chip_smoke.view_mutant`'s. With
    `checkpoint`, saves there after the last step and restores it into a
    fresh Trainer, whose moments end the result. `single` trains this
    process alone, as the reference does."""
    from chip_smoke import VIEW_MUTANTS, view_mutant
    from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, TrainSpec
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.batch_norm import global_statistics
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
    from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import losses as port_losses
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import Trainer

    compat = CompatFlags(skip_augmentation=skip_augmentation)
    group = None if single else data_group(multi_host, n_view)

    def trainer_of(load):
        model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding,
                                     bev_spatial=bev_spatial).to(dtype)
        trainer = Trainer(model, TrainSpec(), compat, check_gradients=True, device="cpu",
                          process_group=group, shard_optimizer=shard_optimizer).init_state()
        model.load_state_dict(load)
        return trainer

    trainer = trainer_of(state)
    focal = port_losses.focal_loss
    if mutant == "bn":
        global_statistics(trainer.model, None)
    elif mutant == "num_pos":
        port_losses.focal_loss = lambda *a, group=None, **k: focal(*a, **k)
    elif mutant is not None and mutant not in VIEW_MUTANTS:
        raise ValueError(mutant)
    try:
        with view_mutant(mutant if mutant in VIEW_MUTANTS else None):
            records = [_record(trainer, trainer.train_step(b)) for b in batches]
    finally:
        port_losses.focal_loss = focal
    out = {"records": records, "moment_bytes": _moment_bytes(trainer.optimizer)}
    if checkpoint:
        trainer.save_checkpoint(checkpoint, epoch=0)
        restored = trainer_of(state)
        restored.load_checkpoint(checkpoint)
        out["restored"] = _record(restored, {})
        out["restored_updates"] = restored.optimizer.updates
    return out


def step_errors_here(spec, state, batches, runs: List[Dict]) -> List[List[Dict]]:
    """Each of `runs` (`train_steps`' keyword arguments but the spec, state
    and batches, which it may cut) against one process's steps on
    `batches`, trained here: `relative_errors` of each step. (Only the
    errors travel back, not the float64 records of every tensor.)"""
    ref = train_steps(spec, state, batches, single=True)["records"]
    out = []
    for run in runs:
        run = dict(run)
        records = train_steps(spec, state, run.pop("batches", batches), **run)["records"]
        out.append([relative_errors(got, want) for got, want in zip(records, ref)])
    return out


def without_counters(record: Dict) -> Dict:
    """A record without torch's ``num_batches_tracked``, which has no place
    in the JAX payload and so starts over in a restored model."""
    return dict(record, state={k: v for k, v in record["state"].items() if not k.endswith("num_batches_tracked")})


def _zero_record(trainer, losses) -> Dict:
    """`_record` with the rank's flat ZeRO-1 slice as the moments (no
    gather), without the counters."""
    return without_counters({"losses": {k: float(v) for k, v in losses.items()},
                             "state": {k: v.detach().double().clone() for k, v in trainer.model.state_dict().items()},
                             "mu": {"shard": trainer.optimizer.shard_moments()[0].double().clone()}})


def checkpoint_dirs(spec, state, batches, root: str, backend: str = "orbax_async", n_view: int = 1) -> Dict:
    """ZeRO-1 in float64 over the launched processes (two nodes under
    `multi_host` with `n_view` 1, each node's half of each batch; else one
    node as (world / n_view, n_view) taking the node's batch), with
    `ZeroOptimizer.gathered` raising: two steps, a directory checkpoint at
    ``root/w2`` (``orbax_async``: the writer held until the third step has
    run), the third step. Fresh trainers restore ``root/w2`` and, where the
    parent wrote it, ``root/w1`` (one process, no ZeRO, the same two steps)
    and take the third step. Returns the files this rank wrote, whether each
    restored state and moment slice equals the saved one bit for bit, and
    `relative_errors` of each resumed third step against the uninterrupted
    one; also what ``root/slow``, an ``orbax`` save whose rank 1 writes
    0.5 s late, holds when the save returns on this rank."""
    import threading
    import time

    from chip_smoke import checkpoint_files
    from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, TrainSpec
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train.checkpoint import wait_for_checkpoints
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import Trainer

    multi_host = n_view == 1
    group = data_group(multi_host, n_view)
    if multi_host:  # each node reads its own half of the global batch
        half = len(batches[0]["gt_boxes"]) // group.layout.num_nodes
        rows = slice(group.layout.node * half, (group.layout.node + 1) * half)
        batches = [{k: v[rows] for k, v in b.items()} for b in batches]

    def trainer(shard_optimizer=True):
        model = MultiModal3DDetector(spec).double()
        t = Trainer(model, TrainSpec(), CompatFlags(), check_gradients=True, device="cpu",
                    process_group=group if shard_optimizer else None, shard_optimizer=shard_optimizer).init_state()
        model.load_state_dict(state)
        return t

    def same(a, b) -> bool:
        return a.dtype == b.dtype and torch.equal(a, b)

    out = {}
    hold = threading.Event()
    with checkpoint_files(hold if backend == "orbax_async" else None) as names:
        live = trainer()
        for b in batches[:2]:
            live.train_step(b)
        saved = {k: v.clone() for k, v in live.model.state_dict().items()}
        saved_mu = [m.clone() for m in live.optimizer.shard_moments()]
        live.save_checkpoint(os.path.join(root, "w2"), epoch=0, backend=backend)
        third = _zero_record(live, live.train_step(batches[2]))  # under orbax_async, while the writer waits
        hold.set()
        wait_for_checkpoints()
        out["written"] = sorted(names)
    # a slow rank 1: a blocking save returns on every rank only once every shard is in
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train import checkpoint

    write = checkpoint._write_files
    if group.rank == 1:
        checkpoint._write_files = lambda directory, files: (time.sleep(0.5), write(directory, files))
    try:
        live.save_checkpoint(os.path.join(root, "slow"), epoch=0, backend="orbax")
    finally:
        checkpoint._write_files = write
    out["slow_on_return"] = sorted(os.listdir(os.path.join(root, "slow")))
    with checkpoint_files():
        checks = {}
        for name in ("w2", "w1"):
            path = os.path.join(root, name)
            if not os.path.isdir(path):
                continue
            resumed = trainer()
            resumed.load_checkpoint(path)
            mu = resumed.optimizer.shard_moments()
            if name == "w2":
                want_state, want_mu = saved, saved_mu
            else:  # the slice of the whole moments that a plain trainer restores
                plain = trainer(shard_optimizer=False)
                plain.load_checkpoint(path)
                want_state = plain.model.state_dict()
                moments = [[plain.optimizer.adamw.state[p][k] for p in plain.optimizer.params]
                           for k in ("exp_avg", "exp_avg_sq")]
                want_mu = [torch.cat([t.reshape(-1) for t in m])[resumed.optimizer.lo:resumed.optimizer.hi]
                           for m in moments]
            checks[name] = {
                "updates": resumed.optimizer.updates, "step": resumed.step,
                "state_equal": all(same(v, want_state[k]) for k, v in resumed.model.state_dict().items()
                                   if not k.endswith("num_batches_tracked")),
                "moments_equal": all(same(a, b) for a, b in zip(mu, want_mu)),
                "next_step": relative_errors(_zero_record(resumed, resumed.train_step(batches[2])), third),
            }
        out["restored"] = checks
    return out


def view_checkpoint(spec, state, batch, root: str, n_view: int = 2) -> Dict:
    """ZeRO-1 over the data axis of (world / n_view, n_view), float64: one
    step, an ``orbax`` directory checkpoint, and a fresh trainer restoring
    it. The files this rank wrote, and whether its restored moment slice
    equals the saved one bit for bit."""
    from chip_smoke import checkpoint_files
    from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, TrainSpec
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import Trainer

    group = data_group(n_view=n_view)

    def trainer():
        model = MultiModal3DDetector(spec).double()
        t = Trainer(model, TrainSpec(), CompatFlags(), device="cpu", process_group=group,
                    shard_optimizer=True).init_state()
        model.load_state_dict(state)
        return t

    with checkpoint_files() as names:
        live = trainer()
        live.train_step(batch)
        live.save_checkpoint(root, epoch=0, backend="orbax")
        resumed = trainer()
        resumed.load_checkpoint(root)
    return {"written": sorted(names), "moments_equal": all(
        torch.equal(a, b) for a, b in zip(resumed.optimizer.shard_moments(), live.optimizer.shard_moments()))}


def _moment_bytes(optimizer) -> int:
    if hasattr(optimizer, "moment_bytes"):
        return optimizer.moment_bytes()
    return sum(s[k].numel() * s[k].element_size() for s in optimizer.adamw.state.values()
               for k in ("exp_avg", "exp_avg_sq"))


def layout_of(n_view: int = 2) -> dict:
    """This rank's place in the ('data', 'view') layout, and what its
    groups hold (a job of the launched processes)."""
    import torch.distributed as dist

    group = data_group(n_view=n_view)
    shard = group.view_shard()
    rank = torch.tensor([float(group.rank)])
    in_view, in_data = [torch.zeros(1) for _ in range(n_view)], [torch.zeros(1) for _ in range(group.n_data)]
    dist.all_gather(in_view, rank, group=group.view_group)
    dist.all_gather(in_data, rank, group=group.data_axis)
    batch = {"rows": torch.arange(8), "tokens": "t"}
    return {"data_index": group.data_index, "view_index": group.view_index, "shard_index": shard.index,
            "view_ranks": [int(t) for t in in_view], "data_ranks": [int(t) for t in in_data],
            "rows": group.local_rows(batch)["rows"].tolist(),
            "gathered": group.gather_node_rows({"r": torch.tensor([group.data_index])})["r"].tolist()}


def view_forward(spec, state, inputs, n_view: int = 2) -> Dict:
    """The eval forward of a `bev_spatial` model holding `state` on this
    rank's view shard (the world's ranks as (world / n_view, n_view)): the
    prediction maps as numpy, and whether the head ran on row blocks."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector

    model = MultiModal3DDetector(spec, bev_spatial=True)
    model.load_state_dict(state)
    model.shard_views(data_group(n_view=n_view).view_shard()).eval()
    with torch.inference_mode():
        preds = model(*(torch.from_numpy(a) for a in inputs))
    return {"preds": {k: v.numpy() for k, v in preds.items()}, "head_on_rows": model.head_on_rows()}


def process_means(values: Dict[str, float]) -> Dict:
    """`all_processes_mean` of this rank's values (times its node + 1), the
    barrier and `is_multi_process`."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import (
        all_processes_mean,
        barrier,
        is_multi_process,
        rank_layout,
    )

    layout = rank_layout()
    mine = {k: v * (layout.node + 1) for k, v in values.items()}
    barrier()
    return {"mean": all_processes_mean(mine), "node": layout.node, "nodes": layout.num_nodes,
            "multi_process": is_multi_process()}


def train_cli(config: Dict, workdir: str, directory_writes: bool = False) -> Dict:
    """`train_detect.main(config=config, device="cpu")` in `workdir`: the
    trainer's final variables and step, the files under `workdir`, how
    many checkpoints and metrics reports this process wrote, and what it
    printed. With `directory_writes`, also the files this process wrote
    into directory checkpoints, `ZeroOptimizer.gathered` raising
    (`chip_smoke.checkpoint_files`)."""
    import io

    from chip_smoke import checkpoint_files
    from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
    from bevfusion_multimodal_3d_object_detection_tpu_torch.train import checkpoint
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import export_jax_variables

    writes = {"checkpoints": 0, "metrics": 0}

    def counted(fn, key):
        def inner(*args, **kwargs):
            writes[key] += 1
            return fn(*args, **kwargs)
        return inner

    with contextlib.ExitStack() as stack:
        for module, name, key in ((checkpoint, "save_checkpoint", "checkpoints"),
                                  (train_detect, "save_and_print_metrics", "metrics")):
            fn = getattr(module, name)
            setattr(module, name, counted(fn, key))
            stack.callback(setattr, module, name, fn)
        cwd = os.getcwd()
        os.chdir(workdir)
        stack.callback(os.chdir, cwd)
        printed = stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        written = stack.enter_context(checkpoint_files()) if directory_writes else None
        trainer = train_detect.main(config=copy.deepcopy(config), device="cpu")
    return {"variables": export_jax_variables(trainer.model), "step": trainer.step, "writes": writes,
            "files": sorted(str(p.relative_to(workdir)) for p in Path(workdir).rglob("*") if p.is_file()),
            "printed": printed.getvalue(), "written": written}


def view_across_nodes() -> str:
    """The refusal of a view group that would span nodes (two nodes of one
    process each, view_parallel 2)."""
    try:
        data_group(multi_host=True, n_view=2)
    except ValueError as e:
        return str(e)
    return "no error"


def serve_batches(config: Dict, samples: List[Dict], devices) -> List:
    """`InferenceServer(devices=devices)` on the samples, f32."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer

    server = InferenceServer(config=config, batch_size=4, score_threshold=0.0, use_bf16=False,
                             devices=devices)
    return [server._run_batch(samples[i:i + 4]) for i in range(0, len(samples), 4)]


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
