"""The port's training entry point against the JAX package's: the CLI's
artifacts on a synthetic nuScenes tree (checkpoints, keep_last, the per-step JSONL,
the metrics report), auto-resume, `Trainer.evaluate` on JAX-converted
variables against JAX's `Trainer.evaluate`, the server restoring the
trainer's checkpoint, and the pretrained camera trunk against JAX's
`load_torch_resnet18_into`."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector as JaxDetector
from bevfusion_multimodal_3d_object_detection_tpu.ops.losses import centernet_loss as jax_centernet_loss
from bevfusion_multimodal_3d_object_detection_tpu.ops.targets import prepare_centernet_targets
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import Trainer as JaxTrainer
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import TrainState
from bevfusion_multimodal_3d_object_detection_tpu.utils import metrics as jax_metrics
from bevfusion_multimodal_3d_object_detection_tpu.utils import torch_convert as jax_torch_convert
from bevfusion_multimodal_3d_object_detection_tpu_torch import eval as port_eval
from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags, DetectorSpec, TrainSpec
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import (
    DataLoader,
    NuScenesDataset,
    SyntheticNuScenesDataset,
    collate_fn,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.inference_engine import InferenceEngine
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.decode import decode_to_host
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.checkpoint import is_committed_checkpoint, read_directory
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import Trainer, make_eval_step
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import torch_convert
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    export_jax_variables,
    load_jax_variables,
)
from chip_smoke import tree_leaves
from torch_port_helpers import narrow_spec, numpy_tree, random_variables, to_port_spec
from torch_trainer_helpers import tree_config, write_test_tree


def _jax_log_keys():
    """The keys of a JAX per-step log line: step, step_seconds and the
    CenterNet loss dict's."""
    preds = {k: jnp.zeros((1, 4, 4, c)) for k, c in
             (("heatmap", 10), ("offset", 2), ("size", 3), ("rot", 2), ("vel", 2))}
    targets = prepare_centernet_targets(jnp.zeros((1, 2, 7)), jnp.full((1, 2), -1), bev_size=(4, 4),
                                        num_classes=10)
    return {"step", "step_seconds", *jax_centernet_loss(preds, targets)}


@pytest.fixture(scope="module")
def nuscenes_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes")
    write_test_tree(root, samples_per_split=4, n_points=400)
    return root


def test_train_cli_writes_the_jax_artifacts_and_resumes(nuscenes_tree, tmp_path, monkeypatch, capsys):
    """Two epochs with keep_last 1, then auto-resume into a third: the
    directory holds what the JAX CLI writes, the log lines carry JAX's keys,
    the report is JAX's text, and the resumed run continues the count."""
    monkeypatch.chdir(tmp_path)
    cfg = tree_config(tmp_path, nuscenes_tree, modality="camera+radar", num_epochs=2)
    cfg["debug"]["check_gradients"] = True
    trainer = train_detect.main(config=cfg, device="cpu")
    ckpts = tmp_path / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["best_model.msgpack", "checkpoint_epoch_1.msgpack"]
    lines = [json.loads(s) for s in (tmp_path / "logs" / "train_log.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4]  # 4 train samples, batch 2, 2 epochs
    assert set(lines[0]) == _jax_log_keys() | {"grad_norm", "grads_finite"}
    assert all(np.isfinite(ln["total_loss"]) and ln["grads_finite"] == 1.0 for ln in lines)
    # the report is JAX's text for the last validation's metrics
    val = DataLoader(NuScenesDataset(split="val", config=cfg, seed=42, emit_uint8=True), batch_size=2)
    jax_metrics.save_and_print_metrics(trainer.evaluate(val), str(tmp_path / "jax_report.txt"))
    assert (tmp_path / "metrics_output.txt").read_text() == (tmp_path / "jax_report.txt").read_text()

    cfg = tree_config(tmp_path, nuscenes_tree, modality="camera+radar", num_epochs=3)
    cfg["train"]["resume"]["enable"] = True  # no checkpoint_path: the newest epoch checkpoint
    capsys.readouterr()
    resumed = train_detect.main(config=cfg, device="cpu")
    assert f"Resumed from {ckpts / 'checkpoint_epoch_1.msgpack'} at epoch 2" in capsys.readouterr().out
    assert resumed.step == 6 and resumed.optimizer.updates == 6
    assert sorted(p.name for p in ckpts.iterdir()) == ["best_model.msgpack", "checkpoint_epoch_2.msgpack"]
    lines = (tmp_path / "logs" / "train_log.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in lines[4:]] == [5, 6]


def test_cli_refuses_unported_options(nuscenes_tree, tmp_path, monkeypatch, capsys):
    """C7: ``bev_spatial`` without a view axis trains exactly as without the
    key (JAX builds its BEV sharding only with view_parallel > 1, root
    train_detect.py:121-137). ``train.checkpoint.backend: orbax_async``,
    once refused, trains: two epochs with keep_last 1 leave the committed
    directories of the last epoch and the best model and no staging
    directory, a resume takes the newest, and the eval CLI and the engine
    restore ``best_model/``."""
    monkeypatch.chdir(tmp_path)
    runs = {}
    for bev_spatial in (False, True):
        cfg = tree_config(tmp_path / str(bev_spatial), nuscenes_tree, modality="camera+radar")
        cfg["parallel"]["bev_spatial"] = bev_spatial
        trainer = train_detect.main(config=cfg, device="cpu")
        runs[bev_spatial] = (export_jax_variables(trainer.model),
                             (tmp_path / str(bev_spatial) / "logs" / "train_log.jsonl").read_text())
    got, want = (dict(tree_leaves(runs[k][0])) for k in (True, False))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    strip = lambda log: [{k: v for k, v in json.loads(ln).items() if k != "step_seconds"} for ln in log.splitlines()]
    assert strip(runs[True][1]) == strip(runs[False][1])
    work = tmp_path / "orbax_async"
    cfg = tree_config(work, nuscenes_tree, modality="camera+radar", num_epochs=2, batch_size=4)  # a step an epoch
    cfg["train"]["checkpoint"].update(backend="orbax_async", keep_last=1)
    (work / "configs").mkdir(parents=True)
    for name in ("configs/base.yaml", "cfg.yaml"):  # the eval CLI's model config (Q10) and its loader's
        (work / name).write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(work)
    train_detect.main(config=cfg, device="cpu")
    ckpts = work / "checkpoints"
    names = lambda: sorted(p.name for p in ckpts.iterdir())
    assert names() == ["best_model", "checkpoint_epoch_1"]
    assert all(p.is_dir() and is_committed_checkpoint(p) for p in ckpts.iterdir())
    cfg["train"].update(num_epochs=3)
    cfg["train"]["resume"]["enable"] = True
    capsys.readouterr()
    resumed = train_detect.main(config=cfg, device="cpu")
    assert f"Resumed from {ckpts / 'checkpoint_epoch_1'} at epoch 2" in capsys.readouterr().out
    assert resumed.step == 3 and resumed.optimizer.updates == 3
    assert names() == ["best_model", "checkpoint_epoch_2"]
    port_eval.main("cfg.yaml", device="cpu")
    assert "Loaded checkpoint checkpoints/best_model\n" in capsys.readouterr().out
    engine = InferenceEngine(model_path=str(ckpts / "best_model"), config=cfg, fold_bn=False, device="cpu")
    saved = read_directory(ckpts / "best_model", ("params", "batch_stats"))
    for part in ("params", "batch_stats"):
        got, want = dict(tree_leaves(engine.variables[part])), dict(tree_leaves(saved[part]))
        assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)


def test_evaluate_matches_jax_trainer():
    """The same variables in both Trainers: every batch's decoded
    detections within 1e-4, and the metrics within 1e-4 (the error terms
    average box differences of that order)."""
    spec = narrow_spec()
    ds = SyntheticNuScenesDataset(num_samples=4, image_size=spec.camera.image_size,
                                  max_points=spec.lidar.max_points,
                                  max_radar_points=spec.radar.max_points_per_sensor, seed=3)
    batches = [collate_fn([ds[2 * i], ds[2 * i + 1]], max_objects=16) for i in range(2)]
    jax_model = JaxDetector(spec=spec)
    variables = random_variables(jax_model.init(
        {"params": jax.random.PRNGKey(0)},
        *(jnp.asarray(batches[0][k][:1]) for k in ("camera_imgs", "lidar_points", "radar_points")),
        train=False), seed=12)
    jtrainer = JaxTrainer(jax_model, jax_config.TrainSpec(batch_size=2), jax_config.CompatFlags())
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=None)
    trainer = Trainer(MultiModal3DDetector(to_port_spec(spec)), TrainSpec(batch_size=2), CompatFlags(),
                      device="cpu").init_state()
    load_jax_variables(trainer.model, variables)

    decoded = {"jax": [], "port": []}
    for side, t in (("jax", jtrainer), ("port", trainer)):
        step = t.eval_step
        t.eval_step = lambda *a, _step=step, _side=side: decoded[_side].append(_step(*a)) or decoded[_side][-1]
    want = jtrainer.evaluate(batches)
    got = trainer.evaluate(batches)
    for g, w in zip(decoded["port"], decoded["jax"]):
        for k in ("scores", "boxes", "velocities"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_array_equal(g["labels"].numpy(), np.asarray(w["labels"]))
    assert set(got) == set(want) and got["AP_per_class"].keys() == want["AP_per_class"].keys()
    for k in ("mAP", "NDS", "mATE", "mASE", "mAOE"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k


@pytest.mark.parametrize("fold_bn", [False, True], ids=["unfolded", "folded"])
def test_server_serves_the_trainers_checkpoint(nuscenes_tree, tmp_path, fold_bn):
    """A checkpoint the Trainer wrote, served by InferenceServer(model_path=)
    in f32, gives what the trainer's model predicts on the same samples
    (scores 1e-4 of their scale); a failed restore raises."""
    cfg = tree_config(tmp_path, nuscenes_tree)
    spec, compat = DetectorSpec.from_config(cfg), CompatFlags.from_config(cfg)
    trainer = Trainer(MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding),
                      TrainSpec.from_config(cfg), compat, device="cpu").init_state()
    ds = NuScenesDataset(split="val", config=cfg, seed=1, emit_uint8=True)
    batch = collate_fn([ds[0], ds[1]])
    trainer.train_step(batch)  # moved off the seeded init, BatchNorm statistics updated
    path = str(tmp_path / "best_model.msgpack")
    trainer.save_checkpoint(path, epoch=0)

    want = decode_to_host(make_eval_step(trainer.model, compat, eval_path_decode=True, device="cpu")(batch),
                          score_thresh=0.0)
    server = InferenceServer(config=cfg, model_path=path, batch_size=2, score_threshold=0.0,
                             use_bf16=False, fold_bn=fold_bn, device="cpu")
    got = server._run_batch([{k: ds[i][k] for k in ("camera_imgs", "lidar_points", "radar_points")}
                             for i in range(2)])
    for g, w in zip(got, want):
        scale = float(np.abs(w["scores"]).max())
        assert len(g["scores"]) == len(w["scores"]) > 0
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-4 * scale)
        np.testing.assert_allclose(g["boxes"][:, :7], w["boxes"], rtol=0, atol=1e-3)
    # a missing file raises by either route (a .pth is a reference-framework
    # checkpoint, tests/test_torch_reference_pth.py)
    for absent in ("absent.msgpack", "reference.pth"):
        with pytest.raises(FileNotFoundError):
            InferenceServer(config=cfg, model_path=str(tmp_path / absent), device="cpu")


def _torchvision_state_dict(seed):
    """A torchvision ResNet-18 state_dict with seeded values (the trunk's
    layers 1-3, and layer4 / fc / num_batches_tracked, which are skipped)."""
    g = torch.Generator().manual_seed(seed)
    sd = {"conv1.weight": torch.randn(64, 3, 7, 7, generator=g) * 0.05}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{prefix}.bias"] = torch.randn(c, generator=g) * 0.1
        sd[f"{prefix}.running_mean"] = torch.randn(c, generator=g) * 0.1
        sd[f"{prefix}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)

    bn("bn1", 64)
    cin = 64
    for layer, c in ((1, 64), (2, 128), (3, 256), (4, 512)):
        for block in (0, 1):
            p = f"layer{layer}.{block}"
            first = cin if block == 0 else c
            sd[f"{p}.conv1.weight"] = torch.randn(c, first, 3, 3, generator=g) * (first * 9) ** -0.5
            sd[f"{p}.conv2.weight"] = torch.randn(c, c, 3, 3, generator=g) * (c * 9) ** -0.5
            bn(f"{p}.bn1", c)
            bn(f"{p}.bn2", c)
            if block == 0 and layer > 1:
                sd[f"{p}.downsample.0.weight"] = torch.randn(c, cin, 1, 1, generator=g) * cin ** -0.5
                bn(f"{p}.downsample.1", c)
        cin = c
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_pretrained_camera_matches_jax(tmp_path, capsys):
    weights = tmp_path / "resnet18.pth"
    torch.save(_torchvision_state_dict(seed=2), weights)
    jspec = narrow_spec()
    jax_model = JaxDetector(spec=jspec)
    x = np.random.RandomState(3).randn(1, 6, 32, 64, 3).astype(np.float32)
    variables = random_variables(jax_model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.zeros((1, 256, 4)), jnp.zeros((1, 5, 16, 7)),
        train=False), seed=4)
    want = numpy_tree(jax_torch_convert.load_torch_resnet18_into(variables, str(weights)))

    spec = to_port_spec(jspec)
    spec = type(spec)(**{**spec.__dict__, "camera": types.SimpleNamespace(
        **{**spec.camera.__dict__, "pretrained": True, "pretrained_path": str(weights)})})
    model = load_jax_variables(MultiModal3DDetector(to_port_spec(jspec)), variables)
    assert torch_convert.maybe_load_pretrained_camera(model, spec)
    got = export_jax_variables(model)
    for coll in ("params", "batch_stats"):
        for a, b in zip(jax.tree_util.tree_leaves(got[coll]), jax.tree_util.tree_leaves(want[coll])):
            assert a.shape == b.shape and np.array_equal(a, b)
    # through the forward: the JAX camera encoder on the loaded trunk
    enc_vars = {c: want[c]["camera_encoder"] for c in ("params", "batch_stats")}
    from bevfusion_multimodal_3d_object_detection_tpu.models.encoders import ResNetCameraEncoder

    ref = np.asarray(ResNetCameraEncoder(spec=jspec.camera).apply(enc_vars, jnp.asarray(x)))
    with torch.no_grad():
        out = model.eval().camera_encoder(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).numpy()
    np.testing.assert_allclose(out, np.transpose(ref, (0, 1, 4, 2, 3)), rtol=0, atol=1e-4)

    # no file: one loud warning, weights untouched
    missing = types.SimpleNamespace(use_camera=True, camera=types.SimpleNamespace(
        pretrained=True, pretrained_path=str(tmp_path / "absent.pth")))
    torch_convert._warned_missing_pretrained = False
    before = model.camera_encoder.trunk.conv1.weight.clone()
    capsys.readouterr()
    assert not torch_convert.maybe_load_pretrained_camera(model, missing)
    assert "WARNING: camera_encoder.pretrained=true" in capsys.readouterr().out
    assert torch.equal(model.camera_encoder.trunk.conv1.weight, before)
