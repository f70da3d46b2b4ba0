"""The port's data-parallel entry points on the CPU: the loader's per-node
sharding and `ParallelSpec` against the JAX package's, `all_processes_mean`
and `barrier` across two gloo processes laid out as two nodes, the training
CLI in two processes (``data_parallel: 2``, with ``shard_optimizer``, and
``multi_host`` over two nodes, and ``view_parallel: 2`` with ``bev_spatial``)
against one process at the same global batch, `InferenceServer(devices=[...])`
against one device, and the view-parallel layouts that are refused or
warned about."""

import copy
import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.data.dataset import DataLoader as JaxLoader
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import DataLoader
from bevfusion_multimodal_3d_object_detection_tpu_torch.parallel import make_data_group
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.checkpoint import msgpack_restore, read_directory
from chip_smoke import detections_agree, make_samples, tree_leaves
from torch_parallel_worker import launch
from torch_trainer_helpers import tree_config, write_test_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n, batch, count, shuffle, drop_last", [
    (10, 2, 2, True, True), (11, 3, 2, True, False), (9, 2, 3, False, False), (7, 4, 1, True, True),
    (13, 2, 4, True, False),
])
def test_loader_shards_like_jax(n, batch, count, shuffle, drop_last):
    for index in range(count):
        kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last, seed=3, process_index=index,
                  process_count=count)
        port, ref = DataLoader(list(range(n)), **kw), JaxLoader(list(range(n)), **kw)
        assert len(port) == len(ref)
        for _ in range(2):  # two epochs: the seeded permutation moves on alike
            got, want = port._index_batches(), ref._index_batches()
            assert [list(b) for b in got] == [list(b) for b in want]


def _spec_cases():
    base = port_config.load_config(str(ROOT / "configs" / "base.yaml"))
    dead = {"hardware": {"gpu": {"distributed": {"enable": True, "world_size": 4, "rank": 1}}}}
    return [
        ("base.yaml", base, False),
        ("bev100.yaml", port_config.load_config(str(ROOT / "configs" / "bev100.yaml")), False),
        ("dead block, no coordinator", dead, False),
        ("dead block, coordinator in the environment", dead, True),
        ("multi_host false beats the dead block", {**dead, "parallel": {"multi_host": False}}, True),
        ("coordinator in the config", {**dead, "parallel": {"multi_host": {"coordinator_address": "h:1"}}}, False),
        ("everything", {"parallel": {"data_parallel": 4, "view_parallel": 2, "shard_optimizer": True,
                                     "bev_spatial": True, "multi_host": {"enable": True, "num_processes": 2,
                                                                         "process_id": 1}}}, False),
    ]


@pytest.mark.parametrize("case", range(len(_spec_cases())), ids=[c[0] for c in _spec_cases()])
def test_parallel_spec_parses_as_jax(case, monkeypatch, capsys):
    """The coordinator the dead hardware.gpu.distributed block needs is
    torchrun's MASTER_ADDR in the port where JAX reads
    JAX_COORDINATOR_ADDRESS."""
    _, cfg, env = _spec_cases()[case]
    for name in ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
        if env:
            monkeypatch.setenv(name, "127.0.0.1:9999")
        else:
            monkeypatch.delenv(name, raising=False)
    port = port_config.ParallelSpec.from_config(cfg)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_config.ParallelSpec.from_config(cfg))
    assert ("no coordinator is configured" in capsys.readouterr().out) == (case == 2)


def test_view_and_bev_spatial_raise_naming_a13b(cli_runs, tmp_path):
    """View parallelism (ROADMAP A13b) is ported: what is left refused or
    warned about. A view group that would span two nodes raises with JAX's
    reason; ``bev_spatial`` on a ``bev_h`` of 15 over 2 view ranks prints
    JAX's warning and trains with the cameras split alone; one process
    without torchrun has no coordinator."""
    for rank in cli_runs["nodes"]:
        assert "view axis crossing host boundaries" in rank[2]
    for rank in cli_runs["node"]:
        warned = rank[3]
        assert ("Warning: parallel.bev_spatial needs bev_h (15) divisible by view_parallel (2); skipping the "
                "spatial constraint") in warned["printed"]
        assert warned["step"] == 2
    assert cli_runs["node"][0][3]["writes"] == {"checkpoints": 2, "metrics": 1}
    cfg = tree_config(tmp_path, tmp_path / "data", modality="camera+radar")
    c = copy.deepcopy(cfg)
    c["parallel"]["view_parallel"] = 2
    with pytest.raises(ValueError, match="launch with torchrun"):
        train_detect.main(config=c, device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        make_data_group(n_data=1, n_view=2)
    c = copy.deepcopy(cfg)
    c["parallel"].update(multi_host=True, shard_optimizer=True)
    with pytest.raises(SystemExit, match="requires an orbax checkpoint backend"):
        train_detect.main(config=c, device="cpu")


def test_server_replicas_equal_one_device(tmp_path):
    """Two replicas on the CPU ("cpu" twice), each batch split between them:
    the detections of one device, at the serving tolerances."""
    cfg = tree_config(tmp_path, tmp_path / "data")
    spec = port_config.DetectorSpec.from_config(cfg)
    samples = make_samples(spec, np.random.RandomState(4), 6)  # uint8 and float cameras, a partial batch
    kw = dict(config=cfg, batch_size=4, score_threshold=0.0, use_bf16=False)
    one = InferenceServer(device="cpu", **kw)
    two = InferenceServer(devices=["cpu", "cpu"], **kw)
    assert len(two.replicas) == 2 and two.replicas[1][0] is not two.model
    for part in (samples[:4], samples[4:]):
        detections_agree(two._run_batch(part), one._run_batch(part), "two replicas vs one device")
    with pytest.raises(ValueError, match="must divide by the mesh's data axis"):
        InferenceServer(devices=["cpu"] * 3, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        InferenceServer(devices=["cpu"] * 2, aot_path="a.npz", **kw)


def _checkpoint(workdir, name):
    return msgpack_restore((pathlib.Path(workdir) / "checkpoints" / name).read_bytes())


def _largest_error(got: dict, want: dict) -> float:
    """The worst |got - want| over the largest |want| of each array leaf."""
    g = dict(tree_leaves(got))
    worst = 0.0
    for path, w in tree_leaves(want):
        if w is not None and np.size(w) and np.abs(w).max() > 0:
            worst = max(worst, float(np.abs(np.asarray(g[path], np.float64) - w).max() / np.abs(w).max()))
    return worst


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    data = write_test_tree(tmp / "data", samples_per_split=4, n_points=400)
    dirs = {k: tmp / k for k in ("single", "dp", "zero", "view", "view_warn", "multi_host", "multi_host_zero")}
    cfgs = {k: tree_config(d, data, modality="camera+radar") for k, d in dirs.items()}
    for d in dirs.values():
        d.mkdir()
    cfgs["dp"]["parallel"]["data_parallel"] = 2
    cfgs["zero"]["parallel"].update(data_parallel=2, shard_optimizer=True)
    cfgs["view"]["parallel"].update(view_parallel=2, bev_spatial=True)
    cfgs["view_warn"]["parallel"].update(view_parallel=2, bev_spatial=True)
    cfgs["view_warn"]["model"]["bev_fusion"].update(bev_h=15, bev_w=15)
    cfgs["multi_host"]["parallel"]["multi_host"] = True
    cfgs["multi_host"]["train"]["batch_size"] = 1  # two nodes of one row: the global batch of 2
    cfgs["multi_host_zero"] = copy.deepcopy(cfgs["multi_host"])
    cfgs["multi_host_zero"]["parallel"]["shard_optimizer"] = True
    cfgs["multi_host_zero"]["train"]["checkpoint"].update(backend="orbax", save_dir=str(dirs["multi_host_zero"] / "checkpoints"))
    cfgs["multi_host_zero"]["train"]["logging"]["log_dir"] = str(dirs["multi_host_zero"] / "logs")

    def single():
        cwd = os.getcwd()
        os.chdir(dirs["single"])
        try:
            return train_detect.main(config=cfgs["single"], device="cpu")
        finally:
            os.chdir(cwd)

    node, trainer = launch([("train_cli", dict(config=cfgs[k], workdir=str(dirs[k])))
                            for k in ("dp", "zero", "view", "view_warn")], during=single)
    nodes = launch([("train_cli", dict(config=cfgs["multi_host"], workdir=str(dirs["multi_host"]))),
                    ("process_means", dict(values={"a": 1.0, "b": 3.0})), ("view_across_nodes", {}),
                    ("process_means", dict(values={"c": 0.1, "d": 1 / 3})),
                    ("train_cli", dict(config=cfgs["multi_host_zero"], workdir=str(dirs["multi_host_zero"]),
                                       directory_writes=True))], nodes=2)
    return {"dirs": dirs, "single": trainer, "node": node, "nodes": nodes}


@pytest.mark.parametrize("run", ["dp", "zero", "view", "multi_host"])
def test_train_cli_in_two_processes_equals_one(cli_runs, run):
    """Two processes at the global batch of one: rank 0 alone writes the
    checkpoints, the per-step log and the report; both ranks end with the
    same variables; the logged (global) losses equal the single run's at
    1e-5 and the checkpoint's BatchNorm statistics at 1e-3 of each leaf's
    largest. (The runs are f32: AdamW turns rounding-level gradients, those
    of the biases right before a BatchNorm, into updates of up to lr either
    way, which shift the next step's batch means by ~1e-4 of the running
    statistics; the float64 steps of test_torch_parallel.py hold the
    numerics at 1e-6.)"""
    ranks = cli_runs["nodes"] if run == "multi_host" else cli_runs["node"]
    res = [r[0 if run == "multi_host" else ("dp", "zero", "view").index(run)] for r in ranks]
    dirs = cli_runs["dirs"]
    assert res[0]["writes"] == {"checkpoints": 2, "metrics": 1}  # epoch 0 and best_model
    assert res[1]["writes"] == {"checkpoints": 0, "metrics": 0}
    assert res[0]["files"] == res[1]["files"]
    assert [f for f in res[0]["files"] if "checkpoints" in f] == ["checkpoints/best_model.msgpack",
                                                                 "checkpoints/checkpoint_epoch_0.msgpack"]
    assert (dirs[run] / "metrics_output.txt").exists()
    assert res[0]["step"] == res[1]["step"] == cli_runs["single"].step == 2
    assert _largest_error(res[1]["variables"], res[0]["variables"]) == 0.0
    logs = [[json.loads(ln) for ln in (dirs[k] / "logs" / "train_log.jsonl").read_text().splitlines()]
            for k in (run, "single")]
    assert [ln["step"] for ln in logs[0]] == [ln["step"] for ln in logs[1]] == [1, 2]
    for got, want in zip(*logs):
        for k in ("total_loss", "heatmap_loss", "offset_loss", "size_loss", "rot_loss", "vel_loss"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    got = _checkpoint(dirs[run], "checkpoint_epoch_0.msgpack")
    want = _checkpoint(dirs["single"], "checkpoint_epoch_0.msgpack")
    assert _largest_error(got["batch_stats"], want["batch_stats"]) <= 1e-3
    assert int(got["step"]) == 2 and set(got["opt_state"]) == set(want["opt_state"])


def test_multi_host_zero_trains_with_directory_checkpoints(cli_runs):
    """``multi_host`` with ``shard_optimizer``, which msgpack refuses
    (`test_view_and_bev_spatial_raise_naming_a13b`), trains over two nodes
    under ``orbax``: each checkpoint a committed directory with one moment
    shard a node, each rank writing only its own, no gather of the moments
    and no staging directory left; the epoch checkpoint holds the variables
    the ranks end with, bit for bit."""
    res = [r[4] for r in cli_runs["nodes"]]
    ckpts = cli_runs["dirs"]["multi_host_zero"] / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["best_model", "checkpoint_epoch_0"]
    for name in ("best_model", "checkpoint_epoch_0"):
        assert sorted(p.name for p in (ckpts / name).iterdir()) == [
            "COMMITTED", "meta.msgpack", "opt_state.0-of-2.msgpack", "opt_state.1-of-2.msgpack", "variables.msgpack"]
    assert sorted(res[0]["written"]) == sorted(["meta.msgpack", "opt_state.0-of-2.msgpack", "variables.msgpack"] * 2)
    assert res[1]["written"] == ["opt_state.1-of-2.msgpack"] * 2
    assert res[0]["step"] == res[1]["step"] == 2 and res[0]["writes"] == {"checkpoints": 0, "metrics": 1}
    saved = read_directory(ckpts / "checkpoint_epoch_0", ("params", "batch_stats"))
    saved = {k: saved[k] for k in ("params", "batch_stats")}
    for r in res:
        assert _largest_error(r["variables"], saved) == 0.0 and _largest_error(saved, r["variables"]) == 0.0


def test_processes_mean_and_barrier(cli_runs):
    """Two nodes: each rank holds its node's values (times node + 1); both
    get the mean over the nodes."""
    for rank, result in enumerate(r[1] for r in cli_runs["nodes"]):
        assert (result["node"], result["nodes"], result["multi_process"]) == (rank, 2, True)
        assert result["mean"] == {"a": 1.5, "b": 4.5}


def test_processes_mean_is_jax_float32_mean(cli_runs):
    """C8: as the JAX package averages (`all_processes_mean`), each node's
    values rounded to float32 and ``np.mean`` taken of the float32 rows,
    bit for bit (a float64 mean differs in the last float32 digits)."""
    values = {"c": 0.1, "d": 1 / 3}
    rows = np.asarray([[values[k] * (node + 1) for k in sorted(values)] for node in range(2)], np.float32)
    want = np.mean(rows, axis=0)
    for r in cli_runs["nodes"]:
        got = r[3]["mean"]
        assert [got[k] for k in sorted(values)] == [float(w) for w in want]
    assert got["c"] != 0.15  # the float64 mean of the float64 values
