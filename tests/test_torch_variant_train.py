"""Training the MLP-head variants in the PyTorch port against the JAX
package: `prepare_mlp_targets` and both branches of `detection_loss`; a
train step of attention and of late fusion against JAX's `make_train_step`;
`Trainer.evaluate`'s MLP branch; msgpack checkpoints of the variants with
their AdamW state, read by each package from the other; the training CLI
with ``fusion_type: late``.

Limits. Targets are equal (labels exactly, boxes bit for bit) and the loss
terms within 1e-6 relative. The train steps are held as
tests/test_torch_train.py holds the CenterNet step (the limits of
tests/torch_train_helpers.py: losses 1e-5, first moments 1e-4 of each
tensor's largest, parameters 1e-6, BatchNorm statistics 1e-5) against JAX's
step computed exactly (float64, un-jitted), in float64 and in f32. Two
things of the JAX step are not exact in float64 and are kept as they are:
its attention scores are f32 (`preferred_element_type`), and its
`detection_loss` casts the predictions to f32; the port does the same.

Dropout: the two packages draw different random streams, so the steps run
with every dropout at 0: the spec's rates through the specs, and late
fusion's fixed Dropout(0.1) (fusion.py:473) by `flax.linen.Dropout.__call__`
patched to the identity for the test's duration and the port module's p set
to 0 (test_torch_fusion_variants.py shows the port's dropout live at JAX's
rates). lidar+radar keeps the un-jitted float64 reference cheap; the camera
branch of both fusions is held in the forward tests.
"""

import dataclasses
import json

import flax.linen as flax_nn
import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector as JaxDetector
from bevfusion_multimodal_3d_object_detection_tpu.ops import losses as jax_losses
from bevfusion_multimodal_3d_object_detection_tpu.train import loop as jax_loop
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import Trainer as JaxTrainer
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import TrainState
from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, TrainSpec
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import SyntheticNuScenesDataset, collate_fn
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import fusion as port_fusion
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import losses as port_losses
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import Trainer
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import metrics as port_metrics
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    export_jax_variables,
    load_jax_variables,
    opt_state_to_jax,
)
from test_torch_checkpoint import (
    STEPS_PER_EPOCH,
    _grads,
    _jax_update,
    _next_update_matches,
    _train_specs,
    assert_trees_equal,
)
from test_torch_variant_models import variant_spec, voxelnet_spec
from torch_port_helpers import detector_inputs, numpy_tree, random_variables, to_port_spec
from torch_train_helpers import check_step, jax_steps, make_batches, make_variables
from torch_trainer_helpers import tree_config, write_test_tree


def _gt(seed=0, b=5, m=6):
    """Boxes (b, m, 9) and labels with padding rows (-1), a label out of
    range (12) before a valid one, and a sample with no valid object."""
    rng = np.random.RandomState(seed)
    boxes = rng.randn(b, m, 9).astype(np.float32)
    labels = rng.randint(0, 10, (b, m)).astype(np.int64)
    labels[0, :2] = -1
    labels[1, 0] = 12
    labels[2] = -1
    labels[3, 3:] = -1
    return boxes, labels


@pytest.mark.parametrize("num_classes", [None, 10])
def test_prepare_mlp_targets(num_classes):
    boxes, labels = _gt()
    want = jax_losses.prepare_mlp_targets(jnp.asarray(boxes), jnp.asarray(labels), num_classes=num_classes)
    got = port_losses.prepare_mlp_targets(torch.from_numpy(boxes), torch.from_numpy(labels),
                                          num_classes=num_classes)
    assert got["labels"].dtype == torch.int32
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(want["boxes"]))
    # the guard: without num_classes the out-of-range label is the target
    assert int(got["labels"][1]) == (12 if num_classes is None else labels[1, 1])
    assert int(got["labels"][2]) == 0 and not got["boxes"][2].any()


@pytest.mark.parametrize("branch", ["cls", "heatmap"])
def test_detection_loss(branch):
    rng = np.random.RandomState(1)
    if branch == "cls":
        boxes, labels = _gt()
        targets = jax_losses.prepare_mlp_targets(jnp.asarray(boxes), jnp.asarray(labels), num_classes=10)
        preds = {"cls": rng.randn(5, 10).astype(np.float32), "box": rng.randn(5, 7).astype(np.float32)}
        targets = {k: np.array(v) for k, v in targets.items()}
    else:
        hm = rng.uniform(0.0, 0.99, (2, 8, 8, 10)).astype(np.float32)
        hm[0, 2, 3, 4] = hm[1, 5, 1, 0] = hm[1, 6, 6, 9] = 1.0
        preds = {"heatmap": rng.uniform(0.01, 0.99, (2, 8, 8, 10)).astype(np.float32)}
        targets = {"heatmap": hm}
        for key, c in (("offset", 2), ("size", 3), ("rot", 2)):
            preds[key] = rng.randn(2, 8, 8, c).astype(np.float32)
            targets[key] = rng.randn(2, 8, 8, c).astype(np.float32)
    want = jax_losses.detection_loss({k: jnp.asarray(v) for k, v in preds.items()},
                                     {k: jnp.asarray(v) for k, v in targets.items()})
    got = port_losses.detection_loss({k: torch.from_numpy(v) for k, v in preds.items()},
                                     {k: torch.from_numpy(v) for k, v in targets.items()})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, err_msg=k)


def _no_dropout_spec(fusion):
    spec = variant_spec("lidar+radar", fusion)
    return dataclasses.replace(
        spec, attention=dataclasses.replace(spec.attention, dropout=0.0),
        late=dataclasses.replace(spec.late, dropout=0.0), mlp=dataclasses.replace(spec.mlp, dropout=0.0))


@pytest.fixture
def no_fixed_dropout(monkeypatch):
    """Late fusion's fixed Dropout(0.1) off in both packages."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, inputs, deterministic=None, rng=None: inputs)
    init = port_fusion.FlexibleLateFusion.__init__

    def no_dropout_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.dropout2.p = 0.0

    monkeypatch.setattr(port_fusion.FlexibleLateFusion, "__init__", no_dropout_init)


@pytest.fixture(scope="module", params=["attention", "late"])
def mlp_runs(request):
    """A batch, seeded variables and JAX's exact step of the lidar+radar
    MLP-head model of each global fusion, dropout off. One step: the
    un-jitted float64 reference compiles each operation on first use, ~40 s
    for the attention model; the second step and the optimizer's moments
    after it are held for the CenterNet model in test_torch_train.py."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, inputs, deterministic=None, rng=None: inputs)
    try:
        spec = _no_dropout_spec(request.param)
        batches = make_batches(spec)[:1]
        variables = make_variables(spec, batches[0])
        exact = jax_steps(spec, variables, batches, exact=True)
    finally:
        mp.undo()
    assert set(exact[0]["losses"]) == {"cls_loss", "box_loss", "total_loss", "grad_norm", "grads_finite"}
    return {"spec": spec, "batches": batches, "variables": variables, "exact": exact}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "f32"])
def test_mlp_train_step_matches_jax(mlp_runs, dtype, no_fixed_dropout):
    """The step from the reference's state (an f32 step that crossed a ReLU
    tie is held to the port's float64 step on its side). No kernel launches
    in training."""
    check_step(mlp_runs, 0, dtype)


def test_evaluate_mlp_branch_matches_jax_trainer(monkeypatch):
    """`Trainer.evaluate` with the MLP head: one detection per sample (the
    softmax's most probable class, its probability, the predicted box; int64
    labels) and the metrics, against JAX's Trainer on the same variables:
    labels equal, scores and boxes within 1e-5, metrics within 1e-5."""
    spec = variant_spec("lidar+radar", "late")
    ds = SyntheticNuScenesDataset(num_samples=4, image_size=spec.camera.image_size,
                                  max_points=spec.lidar.max_points,
                                  max_radar_points=spec.radar.max_points_per_sensor, seed=3)
    batches = [collate_fn([ds[2 * i], ds[2 * i + 1]], max_objects=16) for i in range(2)]
    jax_model = JaxDetector(spec=spec)
    variables = random_variables(jax_model.init(
        {"params": jax.random.PRNGKey(0)}, None,
        *(jnp.asarray(batches[0][k][:1]) for k in ("lidar_points", "radar_points")), train=False), seed=12)
    jtrainer = JaxTrainer(jax_model, jax_config.TrainSpec(batch_size=2), jax_config.CompatFlags())
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=None)
    trainer = Trainer(MultiModal3DDetector(to_port_spec(spec)), TrainSpec(batch_size=2), CompatFlags(),
                      device="cpu").init_state()
    load_jax_variables(trainer.model, variables)

    seen = {}

    def capture(side, compute):
        def wrapped(predictions, *args, **kwargs):
            seen[side] = predictions
            return compute(predictions, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(jax_loop, "compute_metrics", capture("jax", jax_loop.compute_metrics))
    monkeypatch.setattr(port_metrics, "compute_metrics", capture("port", port_metrics.compute_metrics))
    want = jtrainer.evaluate(batches)
    got = trainer.evaluate(batches)
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for g, w in zip(seen["port"], seen["jax"]):
        assert set(g) == set(w) == {"boxes", "scores", "labels"}
        assert g["labels"].dtype == w["labels"].dtype == np.int64
        np.testing.assert_array_equal(g["labels"], w["labels"])
        for k in ("scores", "boxes"):
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
    assert set(got) == set(want)
    for k in ("mAP", "NDS", "mATE", "mASE", "mAOE"):
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


# name: (fusion, LiDAR encoder); attention with VoxelNet carries every new
# leaf type: LayerNorm, positional embeddings, Conv3d and BatchNorm3d
CKPT_VARIANTS = {"attention-voxelnet": ("attention", "VoxelNet"), "late": ("late", "PointNet")}


@pytest.fixture(scope="module", params=list(CKPT_VARIANTS))
def variant_case(request):
    fusion, encoder = CKPT_VARIANTS[request.param]
    spec = variant_spec("lidar+radar", fusion)
    if encoder == "VoxelNet":
        spec = dataclasses.replace(spec, lidar=voxelnet_spec().lidar)
    model = JaxDetector(spec=spec)
    inputs = detector_inputs(spec, batch=1, seed=4)
    inputs = (None, inputs[1] * np.float32(20.0), inputs[2])
    variables = jax.jit(lambda *a: model.init({"params": jax.random.PRNGKey(0)}, *a, train=False))(
        None, *map(jnp.asarray, inputs[1:]))
    return spec, model, random_variables(variables, seed=5), inputs


def _forward(model, params, batch_stats, inputs, port):
    out = model.apply({"params": params, "batch_stats": batch_stats}, None,
                      *map(jnp.asarray, inputs[1:]), train=False)
    port.eval()
    with torch.no_grad():
        got = port(None, *(torch.from_numpy(x) for x in inputs[1:]))
    for k, w in out.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)


def _port_trainer(spec, case="warmup-cosine"):
    ts, compat = _train_specs(case)
    trainer = Trainer(MultiModal3DDetector(to_port_spec(spec)), to_port_spec(ts), to_port_spec(compat),
                      steps_per_epoch=STEPS_PER_EPOCH, device="cpu")
    return trainer.init_state()


def test_variant_checkpoint_from_jax(variant_case, tmp_path):
    """A JAX checkpoint of the variant (two AdamW updates, warmup + cosine)
    restores into the port: variables and optimizer trees equal bit for
    bit, the forward within 1e-5 of scale, the next update within 1e-6."""
    spec, model, variables, inputs = variant_case
    ts, compat = _train_specs("warmup-cosine")
    jtrainer = JaxTrainer(model, ts, compat, steps_per_epoch=STEPS_PER_EPOCH)
    tx, update = _jax_update("warmup-cosine")
    params, opt = variables["params"], tx.init(variables["params"])
    rng = np.random.RandomState(6)
    for _ in range(2):
        params, opt = update(_grads(params, rng), opt, params)
    jtrainer.state = TrainState(step=jnp.asarray(2, jnp.int32), params=params,
                                batch_stats=variables["batch_stats"], opt_state=opt)
    path = str(tmp_path / "jax.msgpack")
    jtrainer.save_checkpoint(path, epoch=1)

    trainer = _port_trainer(spec)
    assert trainer.load_checkpoint(path) == 1 and trainer.step == 2
    assert_trees_equal(export_jax_variables(trainer.model),
                       {"params": numpy_tree(params), "batch_stats": numpy_tree(variables["batch_stats"])},
                       "variables")
    assert_trees_equal(opt_state_to_jax(trainer.optimizer, trainer.model),
                       fser.to_state_dict(jax.tree_util.tree_map(np.asarray, opt)), "opt_state")
    _forward(model, params, variables["batch_stats"], inputs, trainer.model)
    _next_update_matches(trainer, jtrainer.state, "warmup-cosine", seed=7)


def test_variant_checkpoint_into_jax(variant_case, tmp_path):
    """The port's checkpoint of the variant after two train steps restores
    into JAX's Trainer: trees equal bit for bit, the forward within 1e-5 of
    scale, the next update within 1e-6."""
    spec, model, variables, inputs = variant_case
    trainer = _port_trainer(spec)
    load_jax_variables(trainer.model, variables)
    rng = np.random.RandomState(8)
    for _ in range(2):
        boxes = np.zeros((2, 4, 7), np.float32)
        boxes[:, :2, :2] = rng.uniform(-40, 40, (2, 2, 2))
        boxes[:, :2, 3:6] = rng.uniform(1, 4, (2, 2, 3))
        labels = np.full((2, 4), -1, np.int64)
        labels[:, :2] = rng.randint(0, 10, (2, 2))
        trainer.train_step({
            "lidar_points": rng.randn(2, spec.lidar.max_points, 4).astype(np.float32) * 20,
            "radar_points": rng.randn(2, 5, spec.radar.max_points_per_sensor, 7).astype(np.float32),
            "gt_boxes": boxes, "gt_labels": labels,
        })
    path = str(tmp_path / "port.msgpack")
    trainer.save_checkpoint(path, epoch=2)

    ts, compat = _train_specs("warmup-cosine")
    jtrainer = JaxTrainer(model, ts, compat, steps_per_epoch=STEPS_PER_EPOCH)
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                opt_state=jtrainer.tx.init(variables["params"]))
    assert jtrainer.load_checkpoint(path) == 2
    state = jtrainer.state
    assert int(state.step) == 2
    assert_trees_equal({"params": numpy_tree(state.params), "batch_stats": numpy_tree(state.batch_stats)},
                       export_jax_variables(trainer.model), "variables")
    assert_trees_equal(fser.to_state_dict(jax.tree_util.tree_map(np.asarray, state.opt_state)),
                       opt_state_to_jax(trainer.optimizer, trainer.model), "opt_state")
    _forward(model, state.params, state.batch_stats, inputs, trainer.model)
    _next_update_matches(trainer, state, "warmup-cosine", seed=9)


def test_train_cli_with_late_fusion(tmp_path, monkeypatch):
    """`train_detect` on a synthetic nuScenes tree with ``fusion_type:
    late`` (tri-modal, the MLP head): an epoch, validation through the MLP
    branch, the checkpoints, and log lines with the keys of JAX's
    `detection_loss`."""
    monkeypatch.chdir(tmp_path)
    tree = write_test_tree(tmp_path / "data", samples_per_split=4, n_points=400)
    cfg = tree_config(tmp_path, tree)
    cfg["model"]["fusion_type"] = "late"
    cfg["model"]["late_fusion"].update(output_dim=48, hidden_dims=[96])
    trainer = train_detect.main(config=cfg, device="cpu")
    assert type(trainer.model.det_head).__name__ == "MLPDetectionHead"
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "best_model.msgpack", "checkpoint_epoch_0.msgpack"]
    lines = [json.loads(s) for s in (tmp_path / "logs" / "train_log.jsonl").read_text().splitlines()]
    preds = {"cls": jnp.zeros((1, 10)), "box": jnp.zeros((1, 7))}
    targets = jax_losses.prepare_mlp_targets(jnp.zeros((1, 2, 7)), jnp.zeros((1, 2), jnp.int32))
    assert [ln["step"] for ln in lines] == [1, 2]
    assert set(lines[0]) == {"step", "step_seconds", *jax_losses.detection_loss(preds, targets)}
    assert all(np.isfinite(ln["total_loss"]) for ln in lines)
    assert "mAP" in (tmp_path / "metrics_output.txt").read_text()
