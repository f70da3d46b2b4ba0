"""BatchNorm folding of the point MLPs in the PyTorch port against the JAX
package, with the serving model cast to bf16.

The JAX fused path folds BatchNorm into the Dense weights from the f32
variables (`extract_folded_pointnet_weights`) and rounds each folded weight
to bf16 once, inside the kernel. The port's server casts the whole model to
bf16, so the point encoders must still fold from f32: their folded bf16
weights equal JAX's, bit for bit. The fold is the same eager elementwise f32
arithmetic on both sides (inv = scale / sqrt(var + eps), kernel * inv,
(bias - mean) * inv + shift), but XLA's f32 sqrt on the CPU is not always
correctly rounded (about 0.7 % of its results are one f32 ulp from
PyTorch's), so an f32 folded bias may differ by a few f32 ulps of its
terms' magnitude (one ulp of inv, carried through a sum that may cancel). A
bf16 weight
flips only where the f32 product lies within one f32 ulp of a bf16
rounding boundary, which these seeded weights never hit.
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.config import DetectorSpec, load_config
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu.ops.pointnet_pallas import (
    extract_folded_pointnet_weights,
    fused_pointnet,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.config import CompatFlags
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import detector as port_det
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import make_eval_step
from torch_port_helpers import detector_inputs, narrow_spec, random_variables, to_port_spec

# the encoder's subtree in the JAX variables, and its module in the port
ENCODERS = {
    "lidar": (("lidar_encoder", "point_mlp"), lambda m: m.lidar_encoder),
    "radar": (("radar_encoder", "shared_radar", "point_mlp"), lambda m: m.radar_encoder.shared_radar),
}


@pytest.fixture(scope="module")
def narrow_config():
    cfg = load_config(str(pathlib.Path(__file__).parents[1] / "configs" / "base.yaml"))
    model = cfg["model"]
    model["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    model["lidar_encoder"]["mlp_layers"] = [16, 32, 64]
    model["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    model["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    model["centernet_head"].update(in_channels=32, head_conv=16)
    return cfg


@pytest.fixture(scope="module")
def variables(narrow_config):
    spec = DetectorSpec.from_config(narrow_config)
    args = tuple(jnp.asarray(a[:1]) for a in detector_inputs(spec))
    init = MultiModal3DDetector(spec=spec).init({"params": jax.random.PRNGKey(0)}, *args)
    return random_variables(init, seed=13)


@pytest.fixture(scope="module")
def bf16_server(narrow_config, variables):
    """The model as the server casts it: bf16, camera BN folded."""
    return InferenceServer(config=narrow_config, batch_size=2, use_bf16=True, fold_bn=True,
                           variables=variables, device="cpu")


def _subtree(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _jax_folded(variables, path, num_layers):
    return extract_folded_pointnet_weights(
        _subtree(variables["params"], path), _subtree(variables["batch_stats"], path), num_layers
    )


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_bf16_model_folds_from_f32(bf16_server, variables, name):
    """Folded weights of the bf16 model == JAX's f32 fold cast once to bf16,
    bit for bit; folded f32 biases as close as XLA's sqrt allows."""
    path, module = ENCODERS[name]
    enc = module(bf16_server.model)
    weights, biases = enc._folded(torch.bfloat16, torch.device("cpu"))
    want = _jax_folded(variables, path, enc.point_mlp.num_layers)
    assert len(weights) == len(want)
    params, stats = _subtree(variables["params"], path), _subtree(variables["batch_stats"], path)
    for i, (w, b, (wk, wb)) in enumerate(zip(weights, biases, want)):
        assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
        want_w = torch.from_numpy(np.array(wk, np.float32)).to(torch.bfloat16)
        n_diff = int((w.view(torch.int16) != want_w.view(torch.int16)).sum())
        assert n_diff == 0, f"{name} layer {i}: {n_diff} of {w.numel()} weights differ"
        # one f32 ulp of inv carried through (bias - mean) * inv + shift,
        # whose sum may cancel: a few f32 ulps of the terms' magnitude
        bn, mean = params[f"bn{i + 1}"], stats[f"bn{i + 1}"]["mean"]
        inv = bn["scale"] / np.sqrt(stats[f"bn{i + 1}"]["var"].astype(np.float64) + 1e-5)
        mag = np.abs(params[f"mlp{i + 1}"]["bias"] - mean) * inv + np.abs(bn["bias"])
        assert np.all(np.abs(b.numpy() - np.asarray(wb, np.float32)) <= 2.0 ** -21 * mag)


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_bf16_encoder_matches_pallas_kernel(bf16_server, variables, name):
    """The bf16 encoder (plain path) against JAX's fused_pointnet in
    interpret mode on the f32 fold, at an N that is a multiple of the Pallas
    block, so no zero rows are added on the JAX side. The products are exact
    in f32 on both sides and only the summation order differs, so a layer's
    bf16 rounding can flip and carry into the next layers: per element
    |port - jax| <= 2^-5 (|jax| + 2^-4 mean |jax|), 4-8 bf16 ulps."""
    path, module = ENCODERS[name]
    enc = module(bf16_server.model)
    rng = np.random.RandomState(7)
    c_in = enc.in_channels
    x = rng.randn(3, 128, c_in).astype(np.float32)
    x[0, 64:] = 0.0  # zero padding
    xb = torch.from_numpy(x).bfloat16()
    with torch.inference_mode():
        got = enc(xb)
    assert got.dtype == torch.bfloat16
    folded = _jax_folded(variables, path, enc.point_mlp.num_layers)
    want = fused_pointnet(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), [w for w, _ in folded], [b for _, b in folded],
        mask_padding=enc.mask_padding, block_points=64, interpret=True,
    )
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    err = (got.float() - want).abs()
    limit = 2.0 ** -5 * (want.abs() + 2.0 ** -4 * want.abs().mean())
    assert torch.all(err <= limit), f"{name}: worst {(err / limit).max().item():.3g} of the limit"


def test_cast_keeps_point_mlp_in_f32(bf16_server):
    """The rest of the model is bf16 and the point MLPs stay f32; the
    training path still runs on bf16 points and gives bf16 features."""
    model = bf16_server.model
    assert model.camera_encoder.channel_proj.weight.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in model.det_head.parameters())
    for enc in (model.lidar_encoder, model.radar_encoder.shared_radar):
        assert all(t.dtype == torch.float32 for t in enc.point_mlp.parameters())
        assert all(t.dtype == torch.float32 for t in enc.point_mlp.buffers() if t.is_floating_point())
    enc = copy.deepcopy(model.lidar_encoder).train()
    x = torch.from_numpy(detector_inputs(bf16_server.spec, batch=2)[1]).bfloat16()
    out = enc(x)
    assert out.dtype == torch.bfloat16 and out.shape == (2, enc.out_channels)
    assert torch.isfinite(out.float()).all()


def test_eval_step_reads_working_dtype_without_camera():
    """A LiDAR + radar model cast to bf16: its first parameter is a point
    MLP's (f32), and the eval step still feeds the model bf16."""
    spec = to_port_spec(narrow_spec("lidar+radar"))
    model = port_det.MultiModal3DDetector(spec).to(torch.bfloat16)
    assert next(model.parameters()).dtype == torch.float32
    _, lidar, radar = detector_inputs(spec, batch=2)
    step = make_eval_step(model, CompatFlags(), max_detections=10, device="cpu")
    out = step({"lidar_points": lidar, "radar_points": radar})
    assert out["scores"].shape == (2, 10) and torch.isfinite(out["scores"]).all()
