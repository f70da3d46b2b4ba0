"""The port's offline data tools against the JAX package's.

- `ConfigDrivenNuScenesConverter` of both packages on one stub devkit
  (`StubNuScenes`: dict-backed `get`, `scene`, `dataroot`, `box_velocity`;
  five scenes of two samples, prior LiDAR and radar sweeps, categories the
  substring rule (Q20) keeps, drops and, with it off, aliases, a NaN
  velocity, boxes out of range and one sample whose LiDAR record is
  missing): `convert_split` gives equal infos in the ratio (Q11) and the
  official split modes, and `extract_sweeps` equal sweep lists. Equality is
  exact: the same float64 arithmetic on the same values.
- `ConfigDrivenDataValidator` and the three CLI mirrors (``data_converter``,
  ``data_validate``, ``validate_data_with_samples``) give the JAX verdicts,
  errors, warnings, printed reports and exit codes on the tree of
  `write_synthetic_infos`, and on the same tree with one corrupted info.
"""

import pickle
import sys
import types

import numpy as np
import pytest
import yaml

import data_converter as jax_converter_cli
import data_validate as jax_validate_cli
import validate_data_with_samples as jax_samples_cli
from bevfusion_multimodal_3d_object_detection_tpu.data import converter as jax_converter
from bevfusion_multimodal_3d_object_detection_tpu.data import validate as jax_validate
from bevfusion_multimodal_3d_object_detection_tpu_torch import data_converter as port_converter_cli
from bevfusion_multimodal_3d_object_detection_tpu_torch import data_validate as port_validate_cli
from bevfusion_multimodal_3d_object_detection_tpu_torch import validate_data_with_samples as port_samples_cli
from bevfusion_multimodal_3d_object_detection_tpu_torch.config import load_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import converter as port_converter
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import validate as port_validate
from torch_trainer_helpers import ROOT
from torch_trainer_helpers import jax_native_of_its_own  # noqa: F401 (autouse: JAX's LiDAR prep of the module's own)

CAMERAS = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]
RADARS = ["RADAR_FRONT", "RADAR_FRONT_LEFT", "RADAR_FRONT_RIGHT", "RADAR_BACK_LEFT", "RADAR_BACK_RIGHT"]
CATEGORIES = ["vehicle.car", "human.pedestrian.adult", "movable_object.trafficcone", "vehicle.construction",
              "vehicle.bus.rigid", "animal", "movable_object.barrier"]


def _unit_quat(rng):
    q = rng.randn(4)
    return (q / np.linalg.norm(q)).tolist()


class StubNuScenes:
    """The devkit's NuScenes as far as the converters read it."""

    def __init__(self, seed=0, scenes=5, samples=2, sweeps=3, dataroot="/data/nuscenes"):
        rng = np.random.RandomState(seed)
        self.dataroot = dataroot
        self.tables = {k: {} for k in ("sample", "sample_data", "ego_pose", "calibrated_sensor",
                                       "sample_annotation")}
        self.velocities = {}
        self.scene = []
        n = 0

        def put(table, rec):
            nonlocal n
            n += 1
            rec["token"] = f"{table}_{n}"
            self.tables[table][rec["token"]] = rec
            return rec["token"]

        def sensor_chain(channel, time, intrinsic):
            """A key frame of `channel` with `sweeps` prior sample_data."""
            calib = {"translation": rng.randn(3).tolist(), "rotation": _unit_quat(rng)}
            if intrinsic:
                calib["camera_intrinsic"] = (np.eye(3) * 800).tolist()
            calib_token = put("calibrated_sensor", calib)
            prev = ""
            for k in range(sweeps, -1, -1):
                pose = put("ego_pose", {"translation": (rng.randn(3) * 10).tolist(), "rotation": _unit_quat(rng)})
                prev = put("sample_data", {
                    "filename": f"sweeps/{channel}/{time}_{k}.bin", "ego_pose_token": pose,
                    "calibrated_sensor_token": calib_token, "timestamp": time - 50_000 * k, "prev": prev,
                })
            return prev

        for s in range(scenes):
            tokens = []
            for i in range(samples):
                time = 1_000_000 * (10 * s + i + 1)
                data = {"LIDAR_TOP": sensor_chain("LIDAR_TOP", time, False)}
                for cam in CAMERAS[: 6 - (i == 1)]:  # one sample lacks a camera
                    data[cam] = sensor_chain(cam, time, True)
                for radar in RADARS:
                    data[radar] = sensor_chain(radar, time, False)
                if s == 3 and i == 1:  # a missing LiDAR record: skipped with a warning
                    data["LIDAR_TOP"] = "no_such_token"
                lidar = self.tables["sample_data"][data["LIDAR_TOP"]] if s != 3 or i != 1 else None
                anns = []
                for a in range(8):
                    center = rng.uniform(-70, 70, 3) * [1, 1, 0.05]
                    if lidar is not None:  # near the ego pose, so most boxes are in range
                        center += self.tables["ego_pose"][lidar["ego_pose_token"]]["translation"]
                    ann = put("sample_annotation", {
                        "category_name": CATEGORIES[(a + s + i) % len(CATEGORIES)],
                        "translation": center.tolist(), "size": rng.uniform(0.5, 5, 3).tolist(),
                        "rotation": _unit_quat(rng), "num_lidar_pts": int(rng.randint(0, 50)),
                        "num_radar_pts": int(rng.randint(0, 5)),
                    })
                    v = rng.randn(3)
                    if a == 2:
                        v[1] = np.nan
                    self.velocities[ann] = v
                    anns.append(ann)
                tokens.append(put("sample", {"timestamp": time, "scene_token": f"scene_token_{s}",
                                             "data": data, "anns": anns, "next": ""}))
            for a, b in zip(tokens, tokens[1:]):
                self.tables["sample"][a]["next"] = b
            self.scene.append({"name": f"scene-{s + 1:04d}", "first_sample_token": tokens[0]})

    def get(self, table, token):
        return self.tables[table][token]

    def box_velocity(self, token):
        return self.velocities[token].copy()


def equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _config(tmp_path, name="cfg.yaml", **dataset):
    cfg = load_config(str(ROOT / "configs" / "base.yaml"))
    for key in ("ann_file_train", "ann_file_val", "ann_file_test"):
        cfg["dataset"].pop(key, None)
    cfg["dataset"].update(dataset)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture
def devkit(monkeypatch):
    """A stub `nuscenes` package: `NuScenes(...)` gives one StubNuScenes,
    `nuscenes.utils.splits` the official mini lists of its scenes."""
    nusc = StubNuScenes()
    pkg = types.ModuleType("nuscenes")
    mod = types.ModuleType("nuscenes.nuscenes")
    mod.NuScenes = lambda version, dataroot, verbose: nusc
    utils = types.ModuleType("nuscenes.utils")
    splits = types.ModuleType("nuscenes.utils.splits")
    splits.mini_train = ["scene-0002", "scene-0003", "scene-0005"]
    splits.mini_val = ["scene-0001", "scene-0004"]
    for name, m in (("nuscenes", pkg), ("nuscenes.nuscenes", mod), ("nuscenes.utils", utils),
                    ("nuscenes.utils.splits", splits)):
        monkeypatch.setitem(sys.modules, name, m)
    return nusc


@pytest.mark.parametrize("split_mode,substring", [("ratio", True), ("official", False)])
def test_converters_agree(tmp_path, devkit, capsys, split_mode, substring):
    cfg = _config(tmp_path, split_mode=split_mode, num_sweeps=3, radar_num_sweeps=2,
                  data_root=str(tmp_path / "out"))
    with open(cfg) as f:
        raw = yaml.safe_load(f)
    raw.setdefault("compat", {})["substring_class_matching"] = substring
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    port = port_converter.ConfigDrivenNuScenesConverter(cfg)
    jax = jax_converter.ConfigDrivenNuScenesConverter(cfg)
    n_boxes = 0
    for split in ("train", "val", "test"):
        capsys.readouterr()
        got = port.convert_split(split)
        got_out = capsys.readouterr().out
        want = jax.convert_split(split)
        assert capsys.readouterr().out == got_out
        assert equal(got, want), split
        n_boxes += sum(len(i["gt_boxes"]) for i in got)
        for info in got:
            assert len(info["sweeps"]) == 2 and all(len(r["sweeps"]) == 1 for r in info["radars"].values())
        if split == "val":  # scene-0004 holds the sample without its LiDAR record
            assert "Warning: Failed to process sample" in got_out
            assert len(got) == {"ratio": 1, "official": 3}[split_mode]
        port.out_dir, jax.out_dir = tmp_path / "port", tmp_path / "jax"
        port.save_infos(got, split)
        jax.save_infos(want, split)
        assert equal(pickle.loads((tmp_path / "port" / f"nuscenes_infos_{split}.pkl").read_bytes()),
                     pickle.loads((tmp_path / "jax" / f"nuscenes_infos_{split}.pkl").read_bytes()))
    assert n_boxes > 0
    names = {str(n) for split in ("train", "val") for i in port.convert_split(split) for n in i["gt_names"]}
    assert ("traffic_cone" in names) == (not substring)
    for channel in ("LIDAR_TOP", "RADAR_FRONT"):
        token = devkit.get("sample", devkit.scene[0]["first_sample_token"])["data"][channel]
        for num, key in ((2, "lidar_path"), (9, "path")):
            got = port_converter.extract_sweeps(devkit, token, num, path_key=key)
            assert equal(got, jax_converter.extract_sweeps(devkit, token, num, path_key=key))
            assert len(got) == min(num, 3)


def _cli(main, argv, monkeypatch, capsys, jax_cli=False):
    """(exit code, stdout) of one CLI run; the root CLIs read sys.argv."""
    capsys.readouterr()
    code = 0
    try:
        if jax_cli:
            monkeypatch.setattr(sys, "argv", ["cli"] + argv)
            main()
        else:
            main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    return code, capsys.readouterr().out


def test_converter_cli_agrees(tmp_path, devkit, monkeypatch, capsys):
    cfg_port = _config(tmp_path, "port.yaml", data_root=str(tmp_path / "port"))
    cfg_jax = _config(tmp_path, "jax.yaml", data_root=str(tmp_path / "jax"))
    got = _cli(port_converter_cli.main, ["--config", cfg_port, "--split", "val"], monkeypatch, capsys)
    want = _cli(jax_converter_cli.main, ["--config", cfg_jax, "--split", "val"], monkeypatch, capsys, True)
    assert got[0] == want[0] == 0
    assert got[1].replace("port", "jax") == want[1]
    assert equal(pickle.loads((tmp_path / "port" / "nuscenes_infos_val.pkl").read_bytes()),
                 pickle.loads((tmp_path / "jax" / "nuscenes_infos_val.pkl").read_bytes()))
    for argv in (["--config", cfg_port, "--show-config"], ["--config", str(tmp_path / "missing.yaml")]):
        got = _cli(port_converter_cli.main, argv, monkeypatch, capsys)
        assert got == _cli(jax_converter_cli.main, argv, monkeypatch, capsys, True)
    assert got[0] == 1


def test_converter_without_devkit_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "nuscenes", None)  # the import fails
    port = port_converter.ConfigDrivenNuScenesConverter(_config(tmp_path))
    with pytest.raises(ImportError, match="nuscenes-devkit"):
        port.convert_split("train")


def _tree(tmp_path, corrupt=None):
    root = tmp_path / "data"
    jax_converter.write_synthetic_infos(str(root), samples_per_split=4, seed=5)
    if corrupt is not None:
        path = root / "nuscenes_infos_val.pkl"
        data = pickle.loads(path.read_bytes())
        corrupt(data)
        path.write_bytes(pickle.dumps(data))
    return _config(tmp_path, data_root=str(root))


def _nan_box(data):
    data["infos"][1]["gt_boxes"][0, 2] = np.nan


def _bad_info(data):
    info = data["infos"][2]
    info["gt_boxes"] = info["gt_boxes"][:, :6]
    info["gt_names"] = np.array(["dragon"] * (len(info["gt_names"]) + 1))
    del info["cams"]["CAM_BACK"]


def _missing_split(data):
    del data["metadata"]


@pytest.mark.parametrize("corrupt", [None, _nan_box, _bad_info, _missing_split],
                         ids=["clean", "nan_box", "bad_info", "no_metadata"])
def test_validators_agree(tmp_path, monkeypatch, capsys, corrupt):
    cfg = _tree(tmp_path, corrupt)
    port, jax = port_validate.ConfigDrivenDataValidator(cfg), jax_validate.ConfigDrivenDataValidator(cfg)
    for split in ("train", "val", "test"):
        capsys.readouterr()
        got = port.validate_split(split, max_samples=3 if split == "test" else None)
        port.print_sample_boxes(split, num_samples=2)
        got_out = capsys.readouterr().out
        assert got == jax.validate_split(split, max_samples=3 if split == "test" else None)
        jax.print_sample_boxes(split, num_samples=2)
        assert capsys.readouterr().out == got_out
    assert (port.errors, port.warnings) == (jax.errors, jax.warnings)
    assert port.report() == jax.report() == (corrupt is None)

    for port_main, jax_main, extra in ((port_validate_cli.main, jax_validate_cli.main, []),
                                       (port_samples_cli.main, jax_samples_cli.main, ["--samples", "2"])):
        for argv in (["--config", cfg] + extra, ["--config", cfg, "--split", "train"] + extra):
            got = _cli(port_main, argv, monkeypatch, capsys)
            assert got == _cli(jax_main, argv, monkeypatch, capsys, True)
            assert got[0] == (0 if corrupt is None or argv[-1 - len(extra)] == "train" else 1)
    argv = ["--config", str(tmp_path / "missing.yaml")]
    assert _cli(port_validate_cli.main, argv, monkeypatch, capsys) == \
        _cli(jax_validate_cli.main, argv, monkeypatch, capsys, True)
