"""The spans of the port's server, eval step and train step
(`utils.profiling.span`), recorded under a CPU profiler at test size:

- `InferenceServer` (one replica and two): ``serve.stage`` spans whose
  ``requests`` add up to the requests served, with ``queue_wait_s`` >= 0 (their
  sum the server's ``stats["queue_wait_s"]``) and ``h2d_bytes`` the stacked
  arrays' bytes; ``serve.launch`` and ``serve.fetch`` of the same batch numbers,
  all on the dispatch thread;
- the eval step: ``eval.inputs`` (``h2d_bytes``: the bytes of every array it
  reads, of the plans B2's chunk plans and not the frustum cells, which its
  lift does not read; ``plan_hits`` where it reads plans) then
  ``eval.forward``, its outputs bit-identical to the forward fed the whole
  batch, every plan included;
- the train step: ``train.inputs``, ``train.forward``, ``train.backward`` and
  ``train.optimizer`` a step, and losses and parameters bit-identical to the
  step's parts run in turn on the batch's arrays as tensors, with and
  without augmentation.
"""

import copy
import dataclasses
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import CHUNK_KEYS
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.decode import centernet_decoder
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.preprocess import normalize_images
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as port_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling import recorded_spans, span
from torch_port_helpers import narrow_spec, to_port_spec
from torch_train_helpers import make_batches, train_spec_of

SERVE_KEYS = ("camera_imgs", "lidar_points", "radar_points")


def _profiled():
    span("outside")  # found off: the next recording span starts a stretch
    return profile(activities=[ProfilerActivity.CPU])


def _spans(name):
    return [s for s in recorded_spans() if s["name"] == name]


def _model(spec, seed=3):
    return MultiModal3DDetector(spec).init_weights(torch.Generator().manual_seed(seed))


def _tensors(batch):
    """The batch with its numpy arrays as CPU tensors."""
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


@pytest.fixture(scope="module")
def serve_config():
    cfg = port_config.load_config(str(pathlib.Path(__file__).parents[1] / "configs" / "base.yaml"))
    model = cfg["model"]
    model["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    model["lidar_encoder"]["mlp_layers"] = [16, 32, 64]
    model["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    model["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    model["centernet_head"].update(in_channels=32, head_conv=16)
    return cfg


@pytest.mark.parametrize("replicas", [1, 2])
def test_server_stage_spans_count_the_requests(serve_config, replicas):
    spec = port_config.DetectorSpec.from_config(serve_config)
    rng = np.random.RandomState(4)
    h, w = spec.camera.image_size
    samples = [{"camera_imgs": rng.randint(0, 256, (6, h, w, 3)).astype(np.uint8),
                "lidar_points": rng.randn(spec.lidar.max_points, 4).astype(np.float32),
                "radar_points": rng.randn(5, spec.radar.max_points_per_sensor, 7).astype(np.float32)}
               for _ in range(5)]
    server = InferenceServer(config=serve_config, batch_size=2, max_delay_ms=50.0, use_bf16=False,
                             devices=["cpu"] * replicas)
    server.start()
    dispatch = server._thread.name
    try:
        with _profiled():
            futures = [server.submit(s) for s in samples]
            for f in futures:
                f.result(timeout=120)
    finally:
        server.stop()
    stages, launches, fetches = _spans("serve.stage"), _spans("serve.launch"), _spans("serve.fetch")
    assert sum(s["attrs"]["requests"] for s in stages) == len(samples) == server.stats["requests"]
    assert all(s["attrs"]["queue_wait_s"] >= 0 for s in stages)
    assert sum(s["attrs"]["queue_wait_s"] for s in stages) == pytest.approx(server.stats["queue_wait_s"], rel=1e-12)
    per_batch = 2 * sum(samples[0][k].nbytes for k in SERVE_KEYS)  # padded to the batch size
    assert [s["attrs"]["h2d_bytes"] for s in stages] == [per_batch] * len(stages)
    numbers = [s["attrs"]["batch"] for s in stages]
    assert len(set(numbers)) == len(numbers)
    assert [s["attrs"]["batch"] for s in launches] == numbers
    assert sorted(s["attrs"]["batch"] for s in fetches) == numbers
    assert {s["thread"] for s in stages + launches + fetches} == {dispatch}
    assert all(s["parent"] is None for s in stages + launches + fetches)


@pytest.mark.parametrize("mode", ["pseudo", "geometric"])
def test_eval_step_moves_its_inputs_first(mode):
    spec = to_port_spec(train_spec_of(mode))
    batch = make_batches(train_spec_of(mode))[0]
    model = _model(spec)
    step = port_loop.make_eval_step(model, port_config.CompatFlags(), device="cpu")
    with _profiled():
        got = step(batch)
    # pallas in eval with chunk plans: the lift reads them and not the cells
    read = [k for k in batch if k not in ("gt_boxes", "gt_labels", "camera_cells")]
    assert ("camera_point_idx" in read) is ("camera_cells" in batch) is (mode == "geometric")
    inputs, forward = _spans("eval.inputs"), _spans("eval.forward")
    assert len(inputs) == len(forward) == 1 and inputs[0]["end_ns"] <= forward[0]["start_ns"]
    # the batch's plans are plain stacks: copied, none from the device cache
    hits = {"plan_hits": 0.0} if mode == "geometric" else {}
    assert inputs[0]["attrs"] == {"h2d_bytes": sum(batch[k].nbytes for k in read), **hits}
    t = _tensors(batch)
    plans = {}
    if mode == "geometric":  # every plan: the lift picks the chunk plans
        plans = {"camera_cells": t["camera_cells"], "camera_chunks": tuple(t[f"camera_{k}"] for k in CHUNK_KEYS)}
    with torch.inference_mode():
        preds = model(normalize_images(t["camera_imgs"], size=spec.camera.image_size), t["lidar_points"],
                      t["radar_points"], **plans)
    want = centernet_decoder(spec, port_config.CompatFlags(), eval_path=False)(preds)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)


def _parts_in_turn(step, batch):
    """`TrainStep.__call__`'s parts run in turn, on the batch as tensors."""
    batch = step.augmented(_tensors(batch))
    losses = step.loss(step.forward(batch), batch)
    return step.update(losses, step.gradients(losses["total_loss"]))


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_train_step_spans_and_bit_identical_losses(augment):
    spec = to_port_spec(narrow_spec("camera+radar"))
    batches = make_batches(narrow_spec("camera+radar"))
    compat = dataclasses.replace(port_config.CompatFlags(), skip_augmentation=not augment)
    train_spec = port_config.TrainSpec()
    steps = []
    for _ in range(2):
        model = _model(spec)
        steps.append(port_loop.make_train_step(model, port_loop.make_optimizer(train_spec, compat), train_spec,
                                               compat, device="cpu"))
    new, old = steps
    with _profiled():
        got = [new(copy.copy(b)) for b in batches]
    want = [_parts_in_turn(old, b) for b in batches]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in g)
    for p, q in zip(new.model.parameters(), old.model.parameters()):
        assert torch.equal(p, q)
    # the model's camera encoder records its own span inside the forward
    names = ["train.inputs", "train.forward", "camera.encode", "train.backward", "train.optimizer"]
    assert [s["name"] for s in recorded_spans()] == names * len(batches)
    assert all(s["parent"] == "train.forward" for s in _spans("camera.encode"))
    read = ("camera_imgs", "radar_points", "gt_boxes", "gt_labels")
    assert [s["attrs"] for s in _spans("train.inputs")] == [{"h2d_bytes": sum(b[k].nbytes for k in read)}
                                                            for b in batches]
    assert all(s["device_ms"] is None for s in recorded_spans())  # no stream time on the CPU
