"""The port's input pipeline against the JAX package's, bit for bit, on
files written to a temporary directory: `write_synthetic_infos`,
`NuScenesDataset` (uint8 and float cameras, native and numpy LiDAR, quirk
Q5 on and off, parsed radar files, the geometric val split with chunk plans
and the train split without), `SyntheticNuScenesDataset`, `collate_fn`'s GT
padding and `DataLoader`'s seeded order and error re-raise."""

import copy
import pickle
import threading

import numpy as np
import pytest

from bevfusion_multimodal_3d_object_detection_tpu.data import converter as jax_converter
from bevfusion_multimodal_3d_object_detection_tpu.data import dataset as jax_dataset
from bevfusion_multimodal_3d_object_detection_tpu.data import native as jax_native
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import converter as port_converter
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import dataset as port_dataset
from torch_trainer_helpers import tree_config, write_test_tree


def assert_same(got, want, where="sample"):
    """Equal in type, dtype, shape and every value (dicts, lists, arrays)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, (
            where, getattr(got, "dtype", None), want.dtype)
        assert np.array_equal(got, want), where
    else:
        assert type(got) is type(want) and got == want, where


def test_write_synthetic_infos_matches_jax(tmp_path):
    infos = {}
    for side, mod in (("jax", jax_converter), ("port", port_converter)):
        mod.write_synthetic_infos(str(tmp_path), samples_per_split=3, seed=5)
        infos[side] = {s: pickle.loads((tmp_path / f"nuscenes_infos_{s}.pkl").read_bytes())
                       for s in ("train", "val", "test")}
    assert_same(infos["port"], infos["jax"], "infos")


@pytest.fixture(scope="module")
def nuscenes_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes")
    write_test_tree(root, samples_per_split=3, n_points=1500, radar_points=20)
    return root


def _config(root, **compat):
    cfg = tree_config(root, root)
    cfg["compat"].update(compat)
    return cfg


def _datasets(cfg, split, **kw):
    return (jax_dataset.NuScenesDataset(split=split, config=cfg, seed=3, **kw),
            port_dataset.NuScenesDataset(split=split, config=cfg, seed=3, **kw))


@pytest.mark.parametrize("emit_uint8", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("q5", [True, False], ids=["q5-4float", "5float"])
def test_nuscenes_dataset_matches_jax(nuscenes_tree, emit_uint8, native, q5):
    if native:
        assert jax_native.get_lib() is not None  # else JAX would silently take numpy
    jax_ds, port_ds = _datasets(_config(nuscenes_tree, lidar_four_float_parse=q5), "train",
                                emit_uint8=emit_uint8, use_native=native)
    for i in range(len(port_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert_same(got, want, f"sample {i}")
    # the LiDAR cloud was subsampled (more points in range than max_points)
    assert (got["lidar_points"] != 0).any(axis=1).all()
    assert got["camera_imgs"].dtype == (np.uint8 if emit_uint8 else np.float32)


def test_parsed_radar_matches_jax(nuscenes_tree):
    """Q4 off: the five radar .pcd files parsed, padded to 16 points."""
    jax_ds, port_ds = _datasets(_config(nuscenes_tree, random_radar_points=False), "val")
    got = port_ds[1]
    assert_same(got, jax_ds[1])
    assert (got["radar_points"][:, :16, :6] != 0).all() and not got["radar_points"][..., 6].any()
    assert port_dataset.parse_radar_pcd(nuscenes_tree / "absent.pcd").shape == (0, 7)


@pytest.mark.parametrize("split", ["val", "train"])
def test_geometric_split_matches_jax(nuscenes_tree, split):
    """camera_to_bev: geometric with splat_mode: pallas: frustum cells on
    both splits, chunk plans only on val."""
    cfg = _config(nuscenes_tree)
    cfg["model"]["bev_fusion"].update(camera_to_bev="geometric", splat_mode="pallas", depth_bins=8)
    jax_ds, port_ds = _datasets(cfg, split)
    got = port_ds[0]
    assert_same(got, jax_ds[0])
    assert ("camera_point_idx" in got) == (split == "val") and "camera_cells" in got
    want_batch = jax_dataset.collate_fn([jax_ds[0], jax_ds[2]], max_objects=12)
    assert_same(port_dataset.collate_fn([got, port_ds[2]], max_objects=12), want_batch, "batch")


def test_unported_options_raise(nuscenes_tree):
    cfg = _config(nuscenes_tree)
    cfg["model"]["bev_fusion"].update(camera_to_bev="geometric", splat_mode="culled")
    with pytest.raises(NotImplementedError, match="A10"):
        port_dataset.NuScenesDataset(split="val", config=cfg)
    cfg = _config(nuscenes_tree)
    cfg["dataset"]["num_sweeps"] = 3
    with pytest.raises(NotImplementedError, match="A8"):
        port_dataset.NuScenesDataset(split="val", config=cfg)
    with pytest.raises(NotImplementedError, match="A13"):
        port_dataset.DataLoader([], process_index=1, process_count=2)


def test_synthetic_dataset_matches_jax():
    kw = dict(num_samples=3, image_size=(8, 16), max_points=32, max_radar_points=4, seed=2)
    jax_ds = jax_dataset.SyntheticNuScenesDataset(**kw)
    port_ds = port_dataset.SyntheticNuScenesDataset(**kw)
    assert len(port_ds) == 3 and port_ds.classes == jax_ds.classes
    for i in range(3):
        assert_same(port_ds[i], jax_ds[i])


def test_collate_pads_gt_as_jax():
    ds = port_dataset.SyntheticNuScenesDataset(num_samples=3, image_size=(4, 8), max_points=8,
                                               max_radar_points=2, max_gt=9, seed=4)
    samples = [ds[i] for i in range(3)]
    got = port_dataset.collate_fn(samples, max_objects=6)  # one sample has more boxes than rows
    assert max(len(s["gt_labels"]) for s in samples) > 6
    assert_same(got, jax_dataset.collate_fn(copy.deepcopy(samples), max_objects=6), "batch")
    n0 = len(samples[0]["gt_labels"])
    assert got["gt_boxes"].shape == (3, 6, 7) and (got["gt_labels"][0, n0:] == -1).all()
    assert got["tokens"] == ["synthetic_0", "synthetic_1", "synthetic_2"]


@pytest.mark.parametrize("prefetch,workers", [(2, 0), (0, 3)])
def test_dataloader_order_matches_jax(prefetch, workers):
    ds = port_dataset.SyntheticNuScenesDataset(num_samples=7, image_size=(4, 8), max_points=8,
                                               max_radar_points=2, seed=1)
    kw = dict(batch_size=2, shuffle=True, drop_last=True, max_objects=4, seed=9, prefetch=prefetch,
              num_workers=workers)
    port_loader = port_dataset.DataLoader(ds, **kw)
    jax_loader = jax_dataset.DataLoader(ds, **kw)
    assert len(port_loader) == len(jax_loader) == 3
    for epoch in range(2):  # the shuffle draws anew each epoch, from one seeded stream
        got, want = list(port_loader), list(jax_loader)
        assert [b["tokens"] for b in got] == [b["tokens"] for b in want]
        assert_same(got, want, f"epoch {epoch}")


def test_dataloader_reraises_and_releases_its_thread():
    class Failing:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise ValueError("bad sample 4")
            return {"camera_imgs": np.zeros((1, 2, 2, 3), np.uint8), "lidar_points": np.zeros((2, 4)),
                    "radar_points": np.zeros((1, 2, 7))}

    loader = port_dataset.DataLoader(Failing(), batch_size=2)
    seen = []
    with pytest.raises(ValueError, match="bad sample 4"):
        for batch in loader:
            seen.append(batch)
    assert len(seen) == 2  # the epoch did not end early without a word
    before = threading.active_count()
    it = iter(port_dataset.DataLoader(Failing(), batch_size=1, prefetch=1))
    next(it)
    it.close()  # a consumer that stops early does not leave the thread blocked
    assert threading.active_count() <= before
