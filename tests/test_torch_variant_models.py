"""The detector's fusion and head variants in the PyTorch port against the
JAX package: forward parity of attention and late fusion with the MLP head
(tri-modal and lidar+radar), of ``bev`` with the VoxelNet LiDAR encoder and
of ``bev`` with the MLP head; the ablation grid (7 modality sets x 3 fusion
types) by parameter count and output signature; the port's ablation CLI.

Forward limit, f32 on the CPU (jax_default_matmul_precision="highest"):
1e-5 of each output's largest magnitude. The port runs the point encoders
as the fused PointNet's plain version with BatchNorm folded into the
weights, JAX unfolded, so the two round differently; the outputs here are
a few dense layers past the encoders and stay within 1e-5 of their scale.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.models import detector as jax_det
from bevfusion_multimodal_3d_object_detection_tpu_torch import ablation
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import detector as port_det
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import detector_inputs, narrow_spec, random_variables, to_port_spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
MODALITIES = ["camera_only", "lidar_only", "radar_only", "camera+lidar", "camera+radar", "lidar+radar",
              "camera+lidar+radar"]
FUSIONS = ["bev", "attention", "late"]


def variant_spec(modality="camera+lidar+radar", fusion="attention", **kw):
    """narrow_spec with the global fusions at test width (hidden 64, 2
    heads), and an MLP head of 32 hidden units."""
    return dataclasses.replace(
        narrow_spec(modality), fusion_type=fusion,
        attention=jax_config.AttentionFusionSpec(hidden_dim=64, num_heads=2),
        late=jax_config.LateFusionSpec(output_dim=48, hidden_dim=96),
        mlp=jax_config.MLPHeadSpec(hidden_dim=32), **kw)


def voxelnet_spec(**kw):
    spec = narrow_spec(**kw)
    return dataclasses.replace(spec, lidar=dataclasses.replace(spec.lidar, encoder_type="VoxelNet", feat_dim=64))


def _inputs(spec, seed=0):
    cams, lidar, radar = detector_inputs(spec, seed=seed)
    lidar[..., :3] *= 20.0  # spread the points over the voxel grid
    return tuple(x if on else None for x, on in zip((cams, lidar, radar),
                                                    (spec.use_camera, spec.use_lidar, spec.use_radar)))


def _parity(spec, seed=7):
    inputs = _inputs(spec)
    args = [None if a is None else jnp.asarray(a) for a in inputs]
    jax_model = jax_det.MultiModal3DDetector(spec=spec)
    variables = random_variables(jax_model.init({"params": KEY}, *args), seed)
    want = jax_model.apply(variables, *args)
    port = load_jax_variables(port_det.MultiModal3DDetector(to_port_spec(spec)), variables).eval()
    with torch.no_grad():
        got = port(*(None if a is None else torch.from_numpy(a) for a in inputs))
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert tuple(got[k].shape) == v.shape, k
        if v.size:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-5 * np.abs(v).max(), err_msg=k)
    return port, want


@pytest.mark.parametrize("fusion", ["attention", "late"])
@pytest.mark.parametrize("modality", ["camera+lidar+radar", "lidar+radar"])
def test_global_fusion_detector_forward(modality, fusion):
    port, want = _parity(variant_spec(modality, fusion))
    assert isinstance(port.det_head, torch.nn.Module) and set(want) == {"cls", "box"}
    assert want["cls"].shape == (2, 10) and want["box"].shape == (2, 7)
    assert port.get_config_str() == f"{modality}_{fusion}_centernet"


def test_voxelnet_detector_forward():
    """``bev`` fusion with the VoxelNet LiDAR encoder and the CenterNet head
    (the radar still runs through B1's plain version). lidar+radar: the
    camera trunk is held by the tests above and in test_torch_model.py."""
    _, want = _parity(voxelnet_spec(modality="lidar+radar"))
    assert want["heatmap"].shape == (2, 16, 16, 10)


def test_bev_fusion_with_mlp_head():
    """``fusion_type: bev`` with ``detection_head: mlp``: the JAX head gets
    the NHWC BEV map and its ``x[:, :num_classes]`` slices the BEV rows, so
    'cls' is (B, 10, W, 17) and 'box' (B, H - 10, W, 17). The port returns
    the same arrays (ROADMAP C: a quirk it follows)."""
    spec = dataclasses.replace(narrow_spec("lidar+radar"), detection_head="mlp",
                               mlp=jax_config.MLPHeadSpec(hidden_dim=32))
    _, want = _parity(spec)
    assert want["cls"].shape == (2, 10, 16, 17) and want["box"].shape == (2, 6, 16, 17)


def test_unknown_fusion_type_raises():
    spec = to_port_spec(variant_spec(fusion="mid"))
    with pytest.raises(ValueError, match="Unknown fusion type"):
        port_det.MultiModal3DDetector(spec)


@pytest.fixture(scope="module")
def ablation_config(tmp_path_factory):
    """base.yaml at test size: 32x64 cameras, 256 LiDAR and 16 radar points
    per sensor, narrow point MLPs and global fusions; the ablation block as
    base.yaml has it (7 modality sets x 3 fusion types)."""
    cfg = yaml.safe_load((ROOT / "configs" / "base.yaml").read_text())
    model = cfg["model"]
    model["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    model["lidar_encoder"]["mlp_layers"] = [16, 32, 64]
    model["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    model["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    model["centernet_head"].update(in_channels=32, head_conv=16)
    model["attention_fusion"].update(hidden_dim=64, num_heads=2)
    model["late_fusion"].update(output_dim=48, hidden_dims=[96])
    assert cfg["ablation"]["modality_ablation"]["configs"] == MODALITIES
    assert cfg["ablation"]["fusion_ablation"]["fusion_types"] == FUSIONS
    path = tmp_path_factory.mktemp("ablation") / "ablation.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


@pytest.fixture(scope="module")
def port_ablation(ablation_config, tmp_path_factory):
    path, _ = ablation_config
    out = tmp_path_factory.mktemp("ablation_out") / "ablation_results.txt"
    rows = ablation.main(["--config", str(path), "--out", str(out), "--device", "cpu", "--eval"])
    return {(r[0], r[1]): r for r in rows}, out


def _jax_variant(cfg, modality, fusion):
    """(parameter count, output signature) of the JAX runner's variant, by
    `jax.eval_shape` of its init and forward (nothing is compiled)."""
    compat = jax_config.CompatFlags.from_config(cfg)
    spec = jax_config.DetectorSpec.from_config(cfg, modality_config=modality, fusion_type=fusion)
    model = jax_det.MultiModal3DDetector(spec=spec, mask_padding=not compat.unmasked_point_padding)
    h, w = spec.camera.image_size
    shape = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    args = (shape(1, 6, h, w, 3) if spec.use_camera else None,
            shape(1, spec.lidar.max_points, 4) if spec.use_lidar else None,
            shape(1, spec.radar.num_radars, spec.radar.max_points_per_sensor, 7) if spec.use_radar else None)

    def init_apply(*a):
        variables = model.init({"params": KEY}, *a, train=False)
        return variables, model.apply(variables, *a, train=False)

    variables, out = jax.eval_shape(init_apply, *args)
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(variables["params"]))
    return n_params, ", ".join(f"{k}{tuple(v.shape)}" for k, v in sorted(out.items()))


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("modality", MODALITIES)
def test_ablation_grid_matches_jax(port_ablation, ablation_config, modality, fusion):
    """Every variant of the ablation block builds and runs in the port with
    JAX's parameter count and output signature."""
    rows, _ = port_ablation
    _, cfg = ablation_config
    _, _, status, n_params, sig, _ = rows[(modality, fusion)]
    assert status == "PASS"
    assert (n_params, sig) == _jax_variant(cfg, modality, fusion)


def test_ablation_cli_writes_the_jax_format(port_ablation):
    """The result file in the JAX runner's format: a title, a header and one
    line per variant in the block's order (root ablation.py:111-118)."""
    rows, out = port_ablation
    lines = out.read_text().splitlines()
    assert lines[:2] == ["===== Ablation Study =====",
                         f"{'modality':22s} {'fusion':10s} {'status':6s} {'params':>14s}  outputs"]
    want = [f"{m:22s} {f:10s} {'PASS':6s} {rows[(m, f)][3]:>14,}  {rows[(m, f)][4]}"
            for m in MODALITIES for f in FUSIONS]
    assert lines[2:] == want
