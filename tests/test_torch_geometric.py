"""The geometric lift-splat eval path of the PyTorch port against the JAX
package: the splats, `GeometricCameraBEV`, the whole geometric detector and
the eval step, on seeded weights carried over by `load_jax_variables`, plus
the calibration-to-plan functions of the port's dataset module.

f32 on the CPU with jax_default_matmul_precision="highest" (conftest). The
JAX side runs kernel B2 in interpret mode (models/fusion.py:140 picks it on
the CPU); the port runs B2's plain version. Tolerance 1e-5: the same f32
arithmetic summed in another order.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.data import dataset as jax_dataset
from bevfusion_multimodal_3d_object_detection_tpu.models import detector as jax_det
from bevfusion_multimodal_3d_object_detection_tpu.models import fusion as jax_fusion
from bevfusion_multimodal_3d_object_detection_tpu.ops import bev_splat as jax_splat
from bevfusion_multimodal_3d_object_detection_tpu.train import loop as jax_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import dataset as port_dataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import detector as port_det
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import fusion as port_fusion
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import bev_splat as port_splat
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as port_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables
from chip_smoke import ring_camera_cells
from torch_port_helpers import detector_inputs, narrow_spec, random_variables, to_port_spec

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
CHUNK_KEYS = ("camera_point_idx", "camera_local_ids", "camera_block_idx")


def _geo_spec(mode, bev=10, depth_bins=4):
    """The narrow test detector (32x64 images -> 2x4 features) with
    camera_to_bev: geometric over `depth_bins` depths and a bev x bev grid."""
    return narrow_spec(bev=bev, camera_to_bev="geometric", depth_bins=depth_bins, splat_mode=mode)


def _cells_and_plans(cells, num_cells):
    """(B, N, D, H', W') cells -> the JAX-layout chunk tuple (B, N, ...)."""
    plans = [port_dataset.chunk_plans(c, num_cells) for c in cells]
    return tuple(np.stack([p[k] for p in plans]) for k in ("point_idx", "local_ids", "block_idx"))


def _random_cells(rng, shape, num_cells):
    return rng.randint(-1, num_cells, shape).astype(np.int32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def test_lift_splat_matmul_matches_jax():
    rng = np.random.RandomState(0)
    x, fh, fw, c, d, num_cells = 6, 8, 16, 16, 8, 2500
    feats = rng.randn(x, fh, fw, c).astype(np.float32)
    logits = rng.randn(x, fh, fw, d).astype(np.float32)
    cells = ring_camera_cells((128, 256), (50, 50), d, 1.0, 60.0, PC_RANGE).reshape(x, -1)
    want = np.asarray(jax_splat.lift_splat_matmul_rows(
        jnp.asarray(feats), jnp.asarray(logits), jnp.asarray(cells), num_cells))
    got = port_splat.lift_splat_matmul_rows(
        _nchw(feats), _nchw(logits), torch.from_numpy(cells), num_cells)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert np.abs(want).max() > 0.5


def test_lift_splat_pallas_matches_jax():
    """Kernel B2's path on the ring calibration at 8x16 features, D = 8."""
    rng = np.random.RandomState(1)
    x, fh, fw, c, d, num_cells = 6, 8, 16, 16, 8, 2500
    feats = rng.randn(x, fh, fw, c).astype(np.float32)
    logits = rng.randn(x, fh, fw, d).astype(np.float32)
    cells = ring_camera_cells((128, 256), (50, 50), d, 1.0, 60.0, PC_RANGE)
    pi, li, bi = (a[0] for a in _cells_and_plans(cells[None], num_cells))
    want = np.asarray(jax_splat.lift_splat_pallas_rows(
        jnp.asarray(feats), jnp.asarray(logits), jnp.asarray(pi), jnp.asarray(li),
        jnp.asarray(bi), num_cells=num_cells, num_cells_pad=2560, interpret=True))
    got = port_splat.lift_splat_pallas_rows(
        _nchw(feats), _nchw(logits), *(torch.from_numpy(a) for a in (pi, li, bi)),
        num_cells, 2560)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _module_case(mode, seed=2):
    spec = _geo_spec(mode).bev
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, 6, 2, 4, 24).astype(np.float32)
    cells = _random_cells(rng, (2, 6, spec.depth_bins, 2, 4), spec.bev_h * spec.bev_w)
    return spec, feats, cells


@pytest.mark.parametrize("mode", ["pallas", "matmul"])
def test_geometric_camera_bev_matches_jax(mode):
    spec, feats, cells = _module_case(mode)
    chunks = _cells_and_plans(cells, spec.bev_h * spec.bev_w)
    jax_mod = jax_fusion.GeometricCameraBEV(spec=spec)
    variables = random_variables(
        jax_mod.init({"params": KEY}, jnp.asarray(feats), jnp.asarray(cells)), seed=3)
    want = np.asarray(jax_mod.apply(
        variables, jnp.asarray(feats), jnp.asarray(cells),
        camera_chunks=tuple(jnp.asarray(a) for a in chunks)))
    port = load_jax_variables(port_fusion.GeometricCameraBEV(to_port_spec(spec), 24), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(feats).permute(0, 1, 4, 2, 3), torch.from_numpy(cells),
                   tuple(torch.from_numpy(a) for a in chunks))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 1), rtol=TOL, atol=TOL)


def _detector_case(mode, seed=4):
    spec = _geo_spec(mode)
    inputs = detector_inputs(spec, seed=seed)
    cells = _random_cells(np.random.RandomState(seed), (2, 6, 4, 2, 4), 100)
    jax_model = jax_det.MultiModal3DDetector(spec=spec)
    variables = random_variables(jax_model.init(
        {"params": KEY}, *(jnp.asarray(a) for a in inputs), camera_cells=jnp.asarray(cells)), seed=5)
    port = load_jax_variables(port_det.MultiModal3DDetector(to_port_spec(spec)), variables).eval()
    return spec, inputs, cells, jax_model, variables, port


@pytest.mark.parametrize("mode", ["pallas", "matmul"])
def test_geometric_detector_matches_jax(mode):
    spec, inputs, cells, jax_model, variables, port = _detector_case(mode)
    chunks = _cells_and_plans(cells, 100)
    want = jax_model.apply(
        variables, *(jnp.asarray(a) for a in inputs), camera_cells=jnp.asarray(cells),
        camera_chunks=tuple(jnp.asarray(a) for a in chunks))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in inputs), camera_cells=torch.from_numpy(cells),
                   camera_chunks=tuple(torch.from_numpy(a) for a in chunks))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=TOL, atol=TOL, err_msg=k)


def _info(seed):
    """A nuScenes-style sample info: six cameras around the car with their
    intrinsics (at the native 1600x900) and poses, and a LiDAR pose."""
    rng = np.random.RandomState(seed)
    base = np.array([[0, 0, 1.0], [-1.0, 0, 0], [0, -1.0, 0]])  # z-forward -> x-forward

    def quat(m):
        return Rotation.from_matrix(m).as_quat(scalar_first=True).tolist()

    cams = {}
    for k, name in enumerate(port_dataset.CAMERA_ORDER):
        yaw = k * np.pi / 3 + rng.uniform(-0.1, 0.1)
        rz = Rotation.from_euler("z", yaw).as_matrix()
        cams[name] = {"calibrated_sensor": {
            "camera_intrinsic": [[1260.0, 0, 815.0], [0, 1260.0, 452.0], [0, 0, 1]],
            "rotation": quat(rz @ base),
            "translation": (rng.randn(3) * [1.0, 0.5, 0.2] + [0, 0, 1.5]).tolist(),
        }}
    return {
        "lidar_calibrated_sensor": {
            "rotation": quat(Rotation.from_euler("z", rng.uniform(-0.05, 0.05)).as_matrix()),
            "translation": [0.9, 0.0, 1.8],
        },
        "cams": cams,
    }


def _dataset_attrs(spec):
    return dict(image_size=spec.camera.image_size, bev_h=spec.bev.bev_h, bev_w=spec.bev.bev_w,
                depth_bins=spec.bev.depth_bins, depth_min=spec.bev.depth_min,
                depth_max=spec.bev.depth_max, pc_range=spec.bev.pc_range)


def _port_frustum_cells(info, spec):
    a = _dataset_attrs(spec)
    return port_dataset.frustum_cells(
        info, a["image_size"], (a["bev_h"], a["bev_w"]), a["depth_bins"], a["depth_min"],
        a["depth_max"], a["pc_range"])


@pytest.mark.parametrize("image_size,bev", [((448, 800), 50), ((32, 64), 10)])
def test_frustum_cells_match_dataset(image_size, bev):
    spec = dataclasses.replace(
        _geo_spec("pallas", bev=bev, depth_bins=40),
        camera=jax_config.CameraEncoderSpec(image_size=image_size))
    info = _info(6)
    want = jax_dataset.NuScenesDataset._frustum_cells(
        types.SimpleNamespace(**_dataset_attrs(spec)), info)
    got = _port_frustum_cells(info, spec)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert 0.1 < (got >= 0).mean() < 1


def test_chunk_plans_and_collate_match_dataset():
    spec = _geo_spec("pallas", bev=50, depth_bins=40)
    spec = dataclasses.replace(spec, camera=jax_config.CameraEncoderSpec(image_size=(448, 800)))
    jax_ds = types.SimpleNamespace(bev_h=50, bev_w=50, _chunk_cache={})
    samples = {"jax": [], "port": []}
    rng = np.random.RandomState(7)
    cache = {}
    for seed in (8, 9, 8):  # the repeated calibration comes from the cache
        cells = _port_frustum_cells(_info(seed), spec)
        base = {"camera_imgs": rng.randint(0, 256, (6, 4, 8, 3), np.uint8),
                "lidar_points": rng.randn(16, 4).astype(np.float32),
                "radar_points": rng.randn(5, 4, 7).astype(np.float32),
                "camera_cells": cells}
        for side, plans in (("jax", jax_dataset.NuScenesDataset._chunk_plans(jax_ds, cells)),
                            ("port", port_dataset.chunk_plans(cells, 2500, cache))):
            sample = dict(base, **{f"camera_{k}": v for k, v in plans.items()})
            samples[side].append(dict(sample, gt_boxes=np.zeros((1, 7), np.float32),
                                      gt_labels=np.zeros(1, np.int64),
                                      gt_velocities=np.zeros((1, 2), np.float32), token="t"))
    want = jax_dataset.collate_fn(samples["jax"])
    got = port_dataset.collate_fn(samples["port"])
    # the JAX collate's keys: inputs, cells, plans, GT padded to 500 rows, tokens
    assert set(got) == set(want) == {"camera_imgs", "lidar_points", "radar_points", "camera_cells",
                                     *CHUNK_KEYS, "gt_boxes", "gt_labels", "gt_velocities", "tokens"}
    assert got.pop("tokens") == want.pop("tokens") == ["t"] * 3
    for k, v in got.items():
        assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k
    # one plan per distinct camera, and a repeated calibration reads the cache
    assert len(cache) == 12
    for key, plan in cache.items():
        cache[key] = dict(plan, block_idx=np.full_like(plan["block_idx"], 7))
    assert np.all(port_dataset.chunk_plans(cells, 2500, cache)["block_idx"] == 7)


@pytest.mark.parametrize("eval_path_decode", [False, True], ids=["per-axis", "Q3-0.512"])
def test_eval_step_matches_jax(eval_path_decode):
    """Collated batch (uint8 cameras, frustum cells from a calibration,
    chunk plans) -> decoded boxes. max_detections 4 keeps only heatmap peaks
    with distinct non-zero scores, so top-k ties cannot reorder."""
    spec, inputs, _, jax_model, variables, port = _detector_case("pallas", seed=10)
    rng = np.random.RandomState(11)
    samples = []
    for i in range(2):
        cells = _port_frustum_cells(_info(12 + i), spec)
        plans = port_dataset.chunk_plans(cells, spec.bev.bev_h * spec.bev.bev_w)
        samples.append({
            "camera_imgs": rng.randint(0, 256, (6, 32, 64, 3), np.uint8),
            "lidar_points": inputs[1][i], "radar_points": inputs[2][i], "camera_cells": cells,
            **{f"camera_{k}": v for k, v in plans.items()},
        })
    batch = port_dataset.collate_fn(samples)
    assert (batch["camera_cells"] >= 0).mean() > 0.1
    compat = jax_config.CompatFlags()
    state = types.SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
    want = jax_loop.make_eval_step(
        jax_model, compat, max_detections=4, eval_path_decode=eval_path_decode)(state, batch)
    step = port_loop.make_eval_step(
        port, compat, max_detections=4, eval_path_decode=eval_path_decode, device="cpu")
    got = step(batch)
    scores = np.asarray(want["scores"])
    assert scores.min() > 0 and all(len(set(row)) == len(row) for row in scores.tolist())
    for k in ("scores", "boxes", "labels", "velocities"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL, err_msg=k)


def test_pallas_splat_is_inference_only():
    """In train mode the pallas splat falls back to the matmul splat (B2 has
    no backward), as the JAX module does with train=True."""
    spec, feats, cells = _module_case("pallas", seed=13)
    mod = port_fusion.GeometricCameraBEV(to_port_spec(spec), 24)
    chunks = tuple(torch.from_numpy(a) for a in _cells_and_plans(cells, 100))
    x, c = torch.from_numpy(feats).permute(0, 1, 4, 2, 3), torch.from_numpy(cells)
    mod.train()
    with torch.no_grad():
        trained = mod(x, c, chunks)
        matmul = mod(x, c, None)
    torch.testing.assert_close(trained, matmul, rtol=0, atol=0)
    with pytest.raises(ValueError, match="camera_cells"):
        mod(x, None, None)
