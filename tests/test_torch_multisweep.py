"""Multi-sweep LiDAR and radar loading in the port against the JAX package:
the ego-motion transform, JAX tests/test_multisweep.py's dataset cases, a
tree with sweeps (num_sweeps and radar_num_sweeps 2, quirk Q4 off) equal
array for array, the LiDAR width that follows the data (5 channels) in both
packages' Trainers, 5-channel JAX variables in the port, and the training
and eval CLIs with every training-data option of this slice on."""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.data import converter as jax_converter
from bevfusion_multimodal_3d_object_detection_tpu.data import dataset as jax_dataset
from bevfusion_multimodal_3d_object_detection_tpu.models import detector as jax_det
from bevfusion_multimodal_3d_object_detection_tpu.train import loop as jax_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch import eval as eval_cli
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch import train_detect
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import converter as port_converter
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import dataset as port_dataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import detector as port_det
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as port_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    export_jax_variables,
    load_jax_variables,
)
from chip_smoke import add_sweeps, matrix_quat, ring_calibrate_infos, write_radar_pcd
from torch_port_helpers import narrow_spec, numpy_tree, random_variables, to_port_spec
from torch_trainer_helpers import jax_native_of_its_own  # noqa: F401 (autouse: JAX's LiDAR prep of the module's own)
from torch_trainer_helpers import tree_config, write_test_tree

IDENTITY = {"rotation": [1, 0, 0, 0], "translation": [0, 0, 0]}


def _pose(translation, yaw=0.0):
    return {"rotation": [np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], "translation": list(translation)}


@pytest.mark.parametrize("case", ["composition", "translation", "rotation", "random"])
def test_transform_matches_jax(case):
    """JAX test_multisweep.py's three transforms, and random poses with a
    mounted sensor: bit for bit (the same float64 numpy)."""
    rng = np.random.RandomState(0)
    pts = np.array([[5.0, 0.0, 0.0, 0.7], [1.0, 0.0, 0.0, 0.0]], np.float32)
    src, dst = (_pose([0, 0, 0]), IDENTITY), (_pose([2, 0, 0]), IDENTITY)
    if case == "composition":
        src = (_pose([10, 0, 0]), _pose([1, 0, 0]))
    elif case == "rotation":
        dst = (_pose([0, 0, 0], yaw=np.pi / 2), IDENTITY)
    elif case == "random":
        pts = (rng.randn(50, 5) * 20).astype(np.float32)
        src = (_pose(rng.randn(3) * 5, 0.3), {"rotation": matrix_quat(np.eye(3)), "translation": [0.9, 0, 1.8]})
        dst = (_pose(rng.randn(3) * 5, -0.2), _pose([1.0, 0.2, 1.5], 0.1))
    for a, b in zip(port_converter.sensor_to_global(*src), jax_converter.sensor_to_global(*src)):
        assert np.array_equal(a, b)
    got = port_converter.transform_points_between_sensors(pts, *src, *dst)
    want = jax_converter.transform_points_between_sensors(pts, *src, *dst)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got[:, 3:], pts[:, 3:])


def _one_sample_tree(tmp_path):
    """JAX test_multisweep.py's tree: one val sample with 32x64-able
    images and an all-zero LiDAR key sweep."""
    from PIL import Image

    port_converter.write_synthetic_infos(str(tmp_path), samples_per_split=1, splits=("val",))
    data = pickle.loads((tmp_path / "nuscenes_infos_val.pkl").read_bytes())
    rng = np.random.RandomState(0)
    for cam in data["infos"][0]["cams"].values():
        Image.fromarray(rng.randint(0, 255, (36, 60, 3), np.uint8)).save(tmp_path / cam["filename"])
    return data


def _both(tmp_path, flags, **kw):
    """Sample 0 of the port's and the JAX dataset's val split."""
    kw.update(data_root=str(tmp_path), split="val", max_points=16, max_radar_points=4,
              image_size=(32, 64), seed=0, use_native=False)
    return (port_dataset.NuScenesDataset(compat=port_config.CompatFlags(**flags), **kw)[0],
            jax_dataset.NuScenesDataset(compat=jax_config.CompatFlags(**flags), **kw)[0])


def test_dataset_lidar_sweeps_match_jax(tmp_path):
    """JAX's LiDAR case: the key point with dt 0, the prior point moved
    2 m back into the key frame with dt 0.05."""
    data = _one_sample_tree(tmp_path)
    info = data["infos"][0]
    np.array([[5.0, 1.0, 0.0, 0.5, 0.0]], np.float32).tofile(info["lidar_path"])
    np.array([[7.0, 1.0, 0.0, 0.9, 0.0]], np.float32).tofile(tmp_path / "sweep_prev.bin")
    info.update(lidar_pose=_pose([2, 0, 0]), lidar_calibrated_sensor=IDENTITY, sweeps=[
        {"lidar_path": str(tmp_path / "sweep_prev.bin"), "pose": _pose([0, 0, 0]), "calib": IDENTITY,
         "time_lag_s": 0.05},
        {"lidar_path": str(tmp_path / "missing.bin"), "pose": _pose([0, 0, 0]), "calib": IDENTITY}])
    (tmp_path / "nuscenes_infos_val.pkl").write_bytes(pickle.dumps(data))
    got, want = _both(tmp_path, {"lidar_four_float_parse": False}, num_sweeps=3)
    assert got["lidar_points"].shape == (16, 5) and np.array_equal(got["lidar_points"], want["lidar_points"])
    real = got["lidar_points"][np.abs(got["lidar_points"]).sum(axis=1) > 0]
    rows = {tuple(np.round(r, 4)) for r in real.tolist()}
    assert rows == {(5.0, 1.0, 0.0, 0.5, 0.0), (5.0, 1.0, 0.0, 0.9, 0.05)}


def test_dataset_radar_sweeps_match_jax(tmp_path):
    """JAX's radar case: the prior sweep's point and velocity turned 90
    degrees into the key frame, its time lag in channel 6."""
    data = _one_sample_tree(tmp_path)
    info = data["infos"][0]
    np.zeros((1, 5), np.float32).tofile(info["lidar_path"])
    front = info["radars"][port_config.RADAR_ORDER[0]]
    write_radar_pcd(tmp_path / front["filename"], np.array([[5.0, 1.0, 0.0, 1.0, 0.0, 0.5]], np.float32))
    write_radar_pcd(tmp_path / "radar_prev.pcd", np.array([[1.0, 0.0, 0.0, 1.0, 0.0, 0.9]], np.float32))
    front["pose"] = _pose([2, 0, 0])
    front["sweeps"] = [{"path": str(tmp_path / "radar_prev.pcd"), "pose": _pose([2, 0, 0], yaw=np.pi / 2),
                        "calib": IDENTITY, "time_lag_s": 0.07}]
    (tmp_path / "nuscenes_infos_val.pkl").write_bytes(pickle.dumps(data))
    got, want = _both(tmp_path, {"random_radar_points": False}, radar_num_sweeps=2)
    assert got["radar_points"].shape == (5, 4, 7) and np.array_equal(got["radar_points"], want["radar_points"])
    real = got["radar_points"][0][np.abs(got["radar_points"][0]).sum(axis=1) > 0]
    rows = {tuple(np.round(r, 4)) for r in real.tolist()}
    assert rows == {(5.0, 1.0, 0.0, 1.0, 0.0, 0.5, 0.0), (0.0, 1.0, 0.0, 0.0, 1.0, 0.9, 0.07)}


@pytest.fixture(scope="module")
def sweep_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweeps")
    write_test_tree(root, samples_per_split=3, n_points=400, radar_points=12)
    add_sweeps(root, ("train", "val"), lidar_points=400, radar_points=12, seed=1)
    ring_calibrate_infos(root, ("train", "val"), seed=2)
    return root


def _sweep_config(root, **model):
    cfg = tree_config(root, root, **model.pop("train", {}))
    cfg["dataset"].update(num_sweeps=2, radar_num_sweeps=2)
    cfg["compat"]["random_radar_points"] = False
    for block, values in model.items():
        cfg["model"][block].update(values)
    return cfg


@pytest.mark.parametrize("split", ["train", "val"])
def test_tree_sweeps_match_jax(sweep_tree, split):
    """Every sample's LiDAR and radar points equal the JAX dataset's; the
    LiDAR cloud is subsampled from both sweeps (dt 0 and 0.05), the radar
    from the key frame and its prior sweep (t 0 and 0.07)."""
    cfg = _sweep_config(sweep_tree)
    port_ds = port_dataset.NuScenesDataset(split=split, config=cfg, seed=3)
    jax_ds = jax_dataset.NuScenesDataset(split=split, config=cfg, seed=3)
    for i in range(3):
        got, want = port_ds[i], jax_ds[i]
        for k in ("lidar_points", "radar_points"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, k)
    assert got["lidar_points"].shape == (256, 5) and set(np.unique(got["lidar_points"][:, 4])) == {0.0, np.float32(0.05)}
    assert set(np.unique(got["radar_points"][..., 6])) == {0.0, np.float32(0.07)}


def test_trainer_lidar_width_follows_the_data(sweep_tree):
    """Both packages' Trainers build a 5-wide first LiDAR layer from a
    num_sweeps 2 batch although the yaml says input_channels 4; the port's
    init_state refuses a model of the other width."""
    cfg = _sweep_config(sweep_tree)
    assert cfg["model"]["lidar_encoder"].get("input_channels", 4) == 4
    batch = port_dataset.collate_fn([port_dataset.NuScenesDataset(split="train", config=cfg, seed=3)[0]])
    jax_spec = jax_config.DetectorSpec.from_config(cfg)
    trainer = jax_loop.Trainer(jax_det.MultiModal3DDetector(spec=jax_spec), jax_config.TrainSpec(),
                               jax_config.CompatFlags.from_config(cfg))
    state = trainer.init_state(jax_dataset.collate_fn([jax_dataset.NuScenesDataset(
        split="train", config=cfg, seed=3)[0]]))
    assert state.params["lidar_encoder"]["point_mlp"]["mlp1"]["kernel"].shape[0] == 5
    spec = port_config.DetectorSpec.from_config(cfg)
    model = port_det.MultiModal3DDetector(port_loop.with_data_widths(spec, batch))
    port_loop.Trainer(model, port_config.TrainSpec(), device="cpu").init_state(batch)
    assert model.lidar_encoder.point_mlp.mlp1.in_features == 5
    with pytest.raises(ValueError, match="5 channels.*takes 4"):
        port_loop.Trainer(port_det.MultiModal3DDetector(spec), port_config.TrainSpec(), device="cpu").init_state(batch)


def test_five_channel_variables_match_jax():
    """JAX variables from a 5-channel LiDAR init load into the port, give
    the same forward at 1e-5 and export back bit for bit."""
    spec = narrow_spec()
    rng = np.random.RandomState(4)
    cams = rng.randn(2, 6, 32, 64, 3).astype(np.float32)
    lidar = rng.randn(2, 256, 5).astype(np.float32)
    lidar[:, 200:] = 0.0
    radar = rng.randn(2, 5, 16, 7).astype(np.float32)
    model = jax_det.MultiModal3DDetector(spec=spec)
    variables = random_variables(model.init({"params": jax.random.PRNGKey(0)},
                                            *map(jnp.asarray, (cams, lidar, radar))), seed=5)
    want = model.apply(variables, *map(jnp.asarray, (cams, lidar, radar)))
    port_spec = port_loop.with_data_widths(to_port_spec(spec), {"lidar_points": lidar})
    port = load_jax_variables(port_det.MultiModal3DDetector(port_spec), variables).eval()
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (cams, lidar, radar)))
    for k, v in want.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-5 * float(np.abs(v).max()), err_msg=k)
    back = export_jax_variables(port)
    flat_a = jax.tree_util.tree_leaves_with_path(numpy_tree(variables))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(flat_b[path], leaf), path


@pytest.mark.parametrize("splat_mode,modality", [("culled", "camera+lidar+radar"), ("scatter", "camera+radar")])
def test_cli_with_every_training_data_option(sweep_tree, tmp_path, monkeypatch, splat_mode, modality):
    """train_detect.main and then eval.main from a yaml with the geometric
    splat, augmentation, LiDAR and radar sweeps (Q4 off) and freeze_bn: the
    LiDAR layer is 5 wide, the step augments with AugmentSpec's defaults
    whatever the yaml says (as the JAX CLI), the camera statistics keep
    their init, the eval CLI restores the checkpoint and writes its
    report."""
    cfg = _sweep_config(sweep_tree, bev_fusion={"camera_to_bev": "geometric", "splat_mode": splat_mode,
                                                "depth_bins": 8},
                        camera_encoder={"freeze_bn": True}, train={})
    cfg["model"]["modality_config"] = modality
    cfg["compat"]["skip_augmentation"] = False
    cfg["dataset"]["augmentation"]["radar"]["noise_std"] = 0.5  # a followed JAX quirk: the CLI ignores it
    cfg["train"]["checkpoint"]["save_dir"] = str(tmp_path / "checkpoints")
    monkeypatch.chdir(tmp_path)
    trainer = train_detect.main(config=copy.deepcopy(cfg), device="cpu")
    model = trainer.model
    if "lidar" in modality:
        assert model.lidar_encoder.point_mlp.mlp1.in_features == 5
    assert trainer.train_step.augment == port_config.AugmentSpec() and trainer.train_step.geometry_frozen
    for name, t in model.camera_encoder.state_dict().items():
        if name.endswith("running_mean"):
            assert not t.any(), name
        elif name.endswith("running_var"):
            assert bool((t == 1).all()), name
    assert not model.fusion.bev_fusion1_bn.running_mean.eq(0).all()
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "base.yaml").write_text(yaml.safe_dump(cfg))
    metrics = eval_cli.main("configs/base.yaml", device="cpu")
    assert "mAP" in metrics and (tmp_path / "eval_results" / "eval_metrics_output.txt").exists()
