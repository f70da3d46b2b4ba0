"""The port's directory checkpoints (``train.checkpoint.backend: orbax |
orbax_async``) on the CPU: the round trip of a seeded payload against the
JAX package's orbax round trip and the port's msgpack one, leaf for leaf and
bit for bit; ``orbax_async`` storing the state of the moment of the save
while the next steps run, and re-raising its writer's error at the fence;
`latest_checkpoint` skipping what a crash mid-save leaves; a JAX orbax
directory refused with the way through msgpack; key and shape mismatches
naming the key; and ZeRO-1 over two gloo ranks laid out as two nodes
(``multi_host``), float64, with `ZeroOptimizer.gathered` raising: each rank
writes only its shard, and a checkpoint resumes at world 2 and at world 1,
and a world-1 checkpoint at world 2, with the moments equal bit for bit and
the next step within test_torch_parallel.py's limits. The model is the
narrow radar-only detector: the format does not depend on the modules, and
its steps take milliseconds."""

import copy
import os
import re
import threading

import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.train import checkpoint as jax_ckpt
from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, TrainSpec
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import checkpoint as port_ckpt
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import Trainer
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.restore import load_serving_variables
from chip_smoke import checkpoint_files, randomize_stats, tree_leaves
from torch_parallel_worker import _record, launch, parallel_batches, relative_errors, without_counters
from torch_port_helpers import narrow_spec, to_port_spec

LIMIT = 1e-6  # test_torch_parallel.py's
SPEC = to_port_spec(narrow_spec("radar"))


def _trainer(dtype=torch.float32, state=None, compat=CompatFlags(), **train):
    model = MultiModal3DDetector(SPEC).to(dtype)
    trainer = Trainer(model, TrainSpec(**train), compat, check_gradients=True, device="cpu").init_state()
    if state is not None:
        model.load_state_dict(state)
    return trainer


def _equal(got: dict, want: dict) -> list:
    """The leaves (paths) where `got` differs from `want` in key, dtype,
    shape or a bit."""
    g, w = dict(tree_leaves(got)), dict(tree_leaves(want))
    bad = sorted(set(g) ^ set(w))
    for k, a in w.items():
        b = g.get(k)
        if a is None or b is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            bad.append(k)
    return bad


@pytest.fixture(scope="module")
def payload_and_jax(tmp_path_factory):
    """A seeded payload in the JAX layout (`Trainer._payload` after three
    steps with warmup + cosine and gradient accumulation over 2, so counts,
    a schedule count and a running mean are in it), and its round trip
    through the JAX package's orbax backend (written in `root/jax_orbax`)."""
    root = tmp_path_factory.mktemp("ckpt_dir")
    trainer = _trainer(compat=CompatFlags(constant_lr=False), grad_accum_steps=2, warmup_epochs=1)
    for b in parallel_batches(SPEC, 3):
        trainer.train_step(b)
    payload = trainer._payload(epoch=4, best_map=0.25)
    assert trainer.optimizer.mini_step == 1 and "acc_grads" in payload["opt_state"]
    jax_ckpt.save_checkpoint(str(root / "jax_orbax"), payload, backend="orbax")
    restored = jax_ckpt.load_checkpoint(str(root / "jax_orbax"), payload)
    return root, payload, {k: v for k, v in restored.items()}


@pytest.mark.parametrize("backend", port_ckpt.DIRECTORY_BACKENDS)
def test_round_trip_equals_jax_orbax(payload_and_jax, backend):
    root, payload, jax_round_trip = payload_and_jax
    path = root / f"port_{backend}"
    port_ckpt.save_checkpoint(str(path), payload, backend=backend)
    port_ckpt.wait_for_checkpoints()
    assert sorted(os.listdir(path)) == ["COMMITTED", "meta.msgpack", "opt_state.0-of-1.msgpack", "variables.msgpack"]
    got = port_ckpt.load_checkpoint(str(path), payload)
    port_ckpt.save_checkpoint(str(root / "port.msgpack"), payload)
    via_msgpack = port_ckpt.load_checkpoint(str(root / "port.msgpack"), payload)
    assert _equal(got, jax_round_trip) == []
    assert _equal(got, via_msgpack) == []
    assert _equal(got, payload) == []


def test_async_save_keeps_the_state_of_its_moment(tmp_path):
    """The writer held until two more steps have changed the parameters and
    moments in place: the checkpoint holds the state at the save."""
    trainer = _trainer()
    batches = parallel_batches(SPEC, 3)
    trainer.train_step(batches[0])
    want = trainer._payload(epoch=0, best_map=trainer.best_map)
    hold = threading.Event()
    with checkpoint_files(hold) as names:
        trainer.save_checkpoint(str(tmp_path / "ckpt"), epoch=0, backend="orbax_async")
        for b in batches[1:]:
            trainer.train_step(b)
        assert names == [] and not (tmp_path / "ckpt").exists()
        hold.set()
        port_ckpt.wait_for_checkpoints()
    assert port_ckpt.is_committed_checkpoint(tmp_path / "ckpt")
    now = trainer._payload(epoch=0, best_map=trainer.best_map)
    assert _equal(now, want) != []  # the steps moved the state
    restored = _trainer()
    restored.load_checkpoint(str(tmp_path / "ckpt"))
    assert _equal(restored._payload(epoch=0, best_map=restored.best_map), want) == []


def test_writer_error_raises_at_the_fence(tmp_path, monkeypatch):
    trainer = _trainer()
    trainer.train_step(parallel_batches(SPEC, 1)[0])

    def fail(directory, files):
        raise OSError("disk full")

    monkeypatch.setattr(port_ckpt, "_write_files", fail)
    trainer.save_checkpoint(str(tmp_path / "checkpoint_epoch_0"), epoch=0, backend="orbax_async")
    with pytest.raises(OSError, match="disk full"):
        port_ckpt.wait_for_checkpoints()
    port_ckpt.wait_for_checkpoints()  # raised once, then clear
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == (None, -1)
    assert not (tmp_path / "checkpoint_epoch_0").exists()


@pytest.mark.parametrize("leftover", ["port_staging", "no_marker", "orbax_staging"])
def test_latest_checkpoint_skips_what_a_crash_leaves(payload_and_jax, tmp_path, leftover):
    _, payload, _ = payload_and_jax
    small = {k: payload[k] for k in ("step", "epoch", "best_map")}
    port_ckpt.save_checkpoint(str(tmp_path / "checkpoint_epoch_1"), small, backend="orbax")
    newer = {"port_staging": "checkpoint_epoch_2.tmp-step9", "no_marker": "checkpoint_epoch_2",
             "orbax_staging": "checkpoint_epoch_2.orbax-checkpoint-tmp-1234"}[leftover]
    port_ckpt.save_checkpoint(str(tmp_path / "scratch"), small, backend="orbax")
    os.replace(tmp_path / "scratch", tmp_path / newer)
    (tmp_path / newer / "COMMITTED").unlink()  # as a save cut before its commit leaves it
    want = (str(tmp_path / "checkpoint_epoch_1"), 1)
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == want
    with pytest.raises(FileNotFoundError, match="not a committed checkpoint"):
        port_ckpt.load_checkpoint(str(tmp_path / newer), small)


def test_jax_orbax_directory_is_refused(payload_and_jax):
    root, payload, _ = payload_and_jax
    path = str(root / "jax_orbax")
    assert port_ckpt.is_committed_checkpoint(root / "jax_orbax")  # found by a resume, then refused
    route = r"load_checkpoint\(path, template\), then save_checkpoint\(out, restored, backend=\"msgpack\"\)"
    with pytest.raises(ValueError, match=route):
        port_ckpt.load_checkpoint(path, payload)
    with pytest.raises(ValueError, match=route):
        load_serving_variables(SPEC, path)


@pytest.mark.parametrize("mismatch", ["missing_key", "extra_key", "shape"])
def test_mismatch_names_the_key(payload_and_jax, tmp_path, mismatch):
    """Stricter than orbax with numpy templates, which returns the file's
    shape on a shape mismatch."""
    _, payload, _ = payload_and_jax
    template = {k: payload[k] for k in ("params", "batch_stats", "step")}
    path, value = next((k, v) for k, v in tree_leaves(template["params"]) if v is not None)
    saved = copy.deepcopy(template)
    node = saved["params"]
    for k in path[:-1]:
        node = node[k]
    where = "/params/" + "/".join(path)
    if mismatch == "missing_key":
        del node[path[-1]]
        match = re.escape(f"checkpoint lacks {where}")
    elif mismatch == "extra_key":
        node["extra"] = np.zeros(3, np.float32)
        match = re.escape(f"checkpoint has {where.rpartition('/')[0]}/extra")
    else:
        node[path[-1]] = np.zeros(np.shape(value) + (2,), np.float32)
        match = "shape mismatch: .* at " + re.escape(where)
    port_ckpt.save_checkpoint(str(tmp_path / "ckpt"), saved, backend="orbax")
    with pytest.raises(ValueError, match=match):
        port_ckpt.load_checkpoint(str(tmp_path / "ckpt"), template)


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    """`torch_parallel_worker.checkpoint_dirs` on two ranks as two nodes
    (``orbax_async``) after one process wrote ``w1``; then here, at world
    1, ``w2`` restored and stepped."""
    root = tmp_path_factory.mktemp("zero_dirs")
    g = torch.Generator().manual_seed(3)
    state = randomize_stats(MultiModal3DDetector(SPEC).init_weights(g), g).double().state_dict()
    batches = parallel_batches(SPEC, 3)
    single = _trainer(torch.float64, state)
    for b in batches[:2]:
        single.train_step(b)
    single.save_checkpoint(str(root / "w1"), epoch=0, backend="orbax")
    third = without_counters(_record(single, single.train_step(batches[2])))
    ranks = launch([("checkpoint_dirs", dict(spec=SPEC, state=state, batches=batches, root=str(root)))], nodes=2)
    resumed = _trainer(torch.float64, state)
    resumed.load_checkpoint(str(root / "w2"))
    meta = port_ckpt.read_meta(root / "w2")
    files = [port_ckpt.msgpack_restore((root / "w2" / port_ckpt.opt_state_file(i, 2)).read_bytes()) for i in range(2)]
    flat = {k: np.concatenate([f[k] for f in files]) for k in ("exp_avg", "exp_avg_sq")}
    opt = resumed.optimizer
    here = {"updates": opt.updates, "step": resumed.step,
            "moments_equal": all(
                torch.equal(torch.cat([opt.adamw.state[p][k].reshape(-1) for p in opt.params]),
                            torch.from_numpy(flat[k]))
                for k in flat),
            "shard_numel": meta["moments"]["shard_numel"],
            "next_step": relative_errors(without_counters(_record(resumed, resumed.train_step(batches[2]))), third)}
    return {"ranks": [r[0] for r in ranks], "world_one": here, "root": root}


def test_each_rank_writes_only_its_shard(zero_runs):
    assert zero_runs["ranks"][0]["written"] == ["meta.msgpack", "opt_state.0-of-2.msgpack", "variables.msgpack"]
    assert zero_runs["ranks"][1]["written"] == ["opt_state.1-of-2.msgpack"]
    root = zero_runs["root"]
    assert sorted(os.listdir(root / "w2")) == ["COMMITTED", "meta.msgpack", "opt_state.0-of-2.msgpack",
                                               "opt_state.1-of-2.msgpack", "variables.msgpack"]
    assert sorted(p.name for p in root.iterdir()) == ["slow", "w1", "w2"]  # no staging left


def test_a_blocking_save_returns_once_every_rank_has_written(zero_runs):
    """Rank 1 writing 0.5 s late: on every rank, ``orbax`` returns only once
    the checkpoint is committed with both shards (rank 0 waits for it)."""
    for rank in zero_runs["ranks"]:
        assert rank["slow_on_return"] == ["COMMITTED", "meta.msgpack", "opt_state.0-of-2.msgpack",
                                          "opt_state.1-of-2.msgpack", "variables.msgpack"]


@pytest.mark.parametrize("case", ["w2_at_world_2", "w1_at_world_2", "w2_at_world_1"])
def test_resume_at_another_world(zero_runs, case):
    """The restored moments equal the saved ones bit for bit (at world 1:
    every shard file, laid end to end), the counts are the saved ones, and
    the next step is the uninterrupted one's within the limits."""
    name, world = case[:2], case[-1]
    results = [zero_runs["world_one"]] if world == "1" else [r["restored"][name] for r in zero_runs["ranks"]]
    for res in results:
        assert res["moments_equal"] and res.get("state_equal", True)
        assert (res["updates"], res["step"]) == (2, 2)
        assert all(v <= LIMIT for v in res["next_step"].values()), res["next_step"]
