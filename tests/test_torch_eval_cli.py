"""The port's eval CLI against the root eval.py (the JAX package's) on one
synthetic nuScenes tree and one checkpoint that the port's train_detect
wrote there: the same metrics dict (1e-9: the two forwards differ by f32
rounding, which no reported digit shows), byte-identical reports and
official-metrics reports, and the same submission.json up to that rounding
(100 boxes per sample; those scoring clearly above the 100th, by more than
1e-4 of the top score, compared sorted by position, numbers within 1e-4 of
their largest magnitude; at the cutoff, rounding may pick either of two
near-equal scores). Quirk Q10 as in JAX: argv[2]'s
config sets the loader and metrics options only, and the model comes from
configs/base.yaml in the working directory. A missing checkpoint exits 1
unless BMOD_ALLOW_RANDOM_INIT=1; `train_detect infer` runs."""

import copy
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import yaml

from bevfusion_multimodal_3d_object_detection_tpu_torch import eval as port_eval
from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.checkpoint import msgpack_restore, save_checkpoint
from torch_port_helpers import random_variables
from torch_trainer_helpers import tree_config, write_test_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _root_module(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def in_dir():
    """chdir into a directory for the test, and back afterwards, so that
    other tests on the same worker keep their working directory."""
    cwd = os.getcwd()
    yield os.chdir
    os.chdir(cwd)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """./data/nuscenes, configs/base.yaml (camera+radar at test width) and
    checkpoints/best_model.msgpack from one epoch of the port's trainer,
    its weights then replaced by seeded random ones with a spread of scores
    (one epoch on four samples scores every cell alike)."""
    tmp = tmp_path_factory.mktemp("eval_cli")
    write_test_tree(tmp / "data" / "nuscenes", samples_per_split=4, radar_points=20)
    cfg = tree_config(tmp, "data/nuscenes", modality="camera+radar")
    (tmp / "configs").mkdir()
    (tmp / "configs" / "base.yaml").write_text(yaml.safe_dump(cfg))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        train_detect.main(config=cfg, device="cpu")
    finally:
        os.chdir(cwd)
    best = tmp / "checkpoints" / "best_model.msgpack"
    payload = msgpack_restore(best.read_bytes())
    variables = random_variables({"params": payload["params"], "batch_stats": payload["batch_stats"]}, seed=5)
    head = variables["params"]["det_head"]
    head["heatmap_head"]["conv2"]["kernel"] *= 0.02
    head["heatmap_head"]["conv2"]["bias"][:] = -0.6
    save_checkpoint(str(best), dict(payload, **variables))
    return tmp, cfg


def test_eval_matches_jax(tree, in_dir):
    tmp, cfg = tree
    user = copy.deepcopy(cfg)
    user["train"]["batch_size"] = 3  # a full batch and a partial one
    user["metrics"].update(use_official=True, save_submission="submission.json")
    # Q10: the user config's model block is not read
    user["model"]["modality_config"] = "camera"
    user["model"]["bev_fusion"]["bev_channels"] = 64
    (tmp / "user.yaml").write_text(yaml.safe_dump(user))
    in_dir(tmp)
    outputs = ("eval_results/eval_metrics_output.txt", "eval_results/eval_metrics_official.txt")

    want = _root_module("eval").main("user.yaml")
    want_files = [pathlib.Path(p).read_bytes() for p in outputs]
    want_sub = json.loads(pathlib.Path("submission.json").read_text())
    for p in outputs + ("submission.json",):
        os.remove(p)
    got = port_eval.main("user.yaml", device="cpu")
    assert list(got) == list(want) and list(got["AP_per_class"]) == list(want["AP_per_class"])
    for k, v in want.items():
        if k == "AP_per_class":
            np.testing.assert_allclose(list(got[k].values()), list(v.values()), rtol=0, atol=1e-9)
        else:
            assert abs(got[k] - v) <= 1e-9, k
    for p, w in zip(outputs, want_files):
        assert pathlib.Path(p).read_bytes() == w, p
    sub = json.loads(pathlib.Path("submission.json").read_text())
    assert sub["meta"] == want_sub["meta"]
    assert sub["meta"]["use_camera"] and not sub["meta"]["use_lidar"] and sub["meta"]["use_radar"]
    assert list(sub["results"]) == list(want_sub["results"]) and len(sub["results"]) == 4
    numbers = ("translation", "size", "rotation", "velocity", "detection_score")
    for token, entries in sub["results"].items():
        ref = want_sub["results"][token]
        assert len(entries) == len(ref) == 100
        scores = [e["detection_score"] for e in ref]
        cut = min(scores) + 1e-4 * max(scores)
        a, b = (sorted((d for d in e if d["detection_score"] > cut), key=lambda d: d["translation"][:2])
                for e in (entries, ref))
        assert len(a) == len(b) >= 10
        assert [(e["sample_token"], e["detection_name"], e["attribute_name"]) for e in a] == \
            [(e["sample_token"], e["detection_name"], e["attribute_name"]) for e in b]
        for k in numbers:
            want_k = np.array([e[k] for e in b], np.float64)
            np.testing.assert_allclose([e[k] for e in a], want_k, rtol=0, atol=1e-4 * np.abs(want_k).max(), err_msg=k)

    # without argv[2] the loader takes configs/base.yaml too (batch 2)
    assert port_eval.main(None, device="cpu") == got


def test_missing_checkpoint_exits_1(tree, in_dir, monkeypatch, tmp_path):
    src, _ = tree
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "base.yaml").write_bytes((src / "configs" / "base.yaml").read_bytes())
    (tmp_path / "data").symlink_to(src / "data")
    in_dir(tmp_path)
    monkeypatch.delenv("BMOD_ALLOW_RANDOM_INIT", raising=False)
    with pytest.raises(SystemExit) as exc:
        port_eval.main(None, device="cpu")
    assert exc.value.code == 1
    assert not (tmp_path / "eval_results").exists()
    monkeypatch.setenv("BMOD_ALLOW_RANDOM_INIT", "1")
    metrics = port_eval.main(None, device="cpu")
    assert (tmp_path / "eval_results" / "eval_metrics_output.txt").exists() and 0 <= metrics["mAP"] <= 1


def test_train_detect_infer(tree, in_dir):
    """`train_detect infer`: the first val sample of ./data/nuscenes (the
    dataset's default sizes, as in JAX) through the engine built from
    configs/base.yaml."""
    tmp, _ = tree
    in_dir(tmp)
    res = train_detect.inference("checkpoints/best_model.msgpack", device="cpu")
    assert np.isfinite(res["detections"]["boxes"]).all() and res["latency_s"] > 0
    assert {"precision", "recall", "f1", "tp", "fp", "fn"} <= set(res)
