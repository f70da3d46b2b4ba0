"""Reference-framework `.pth` checkpoints in the port: its own
`convert_reference_checkpoint` gives the JAX package's tree leaf for leaf,
bit for bit, on a reference-layout state_dict of `TorchReferenceDetector`
(renamed as tests/test_reference_checkpoint.py does); the port's engine and
InferenceServer restore the `.pth` and agree with the JAX engine restoring
it; a module the state_dict holds only in part raises in both packages
(the attention, late-fusion and MLP-head mappings are held in
test_torch_variant_entry.py).

Tolerance of the restored models: the prediction maps and the decoded
scores within 1e-4 of each output's largest magnitude (the port folds the
point encoders' BatchNorms into B1's weights, JAX does not)."""

import copy
import pathlib

import jax
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.config import load_config
from bevfusion_multimodal_3d_object_detection_tpu.inference_engine import InferenceEngine as JaxEngine
from bevfusion_multimodal_3d_object_detection_tpu.ops.decode import decode_centernet_predictions as jax_decode
from bevfusion_multimodal_3d_object_detection_tpu.utils import reference_convert as jax_convert
from bevfusion_multimodal_3d_object_detection_tpu.utils.torch_baseline import TorchReferenceDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.inference_engine import InferenceEngine
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import reference_convert as port_convert
from test_reference_checkpoint import _reference_style_state_dict
from torch_port_helpers import detector_inputs

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAP_KEYS = ("heatmap", "offset", "size", "rot", "vel")


@pytest.fixture(scope="module")
def state_dict():
    torch.manual_seed(1)
    model = TorchReferenceDetector().eval()
    # non-trivial BatchNorm statistics, so that the restore of every one shows
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return _reference_style_state_dict(model)


@pytest.fixture(scope="module")
def pth(state_dict, tmp_path_factory):
    path = tmp_path_factory.mktemp("pth") / "reference_model.pth"
    torch.save({"model_state_dict": state_dict, "epoch": 3}, path)
    return path


@pytest.fixture(scope="module")
def config():
    """base.yaml (full widths, a 50x50 BEV) with 32x64 cameras, 64 LiDAR and
    16 radar points per sensor."""
    cfg = load_config(str(ROOT / "configs" / "base.yaml"))
    cfg["model"]["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["cameras"]["image_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 64, "radar_per_sensor": 16}
    return cfg


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_conversion_is_bit_exact(state_dict):
    got = port_convert.convert_reference_checkpoint(state_dict)
    want = jax_convert.convert_reference_checkpoint(state_dict)
    for g, w in zip(got, want):  # params, batch_stats
        g, w = dict(_leaves(g)), dict(_leaves(w))
        assert set(g) == set(w)
        for path, a in w.items():
            b = g[path]
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert np.array_equal(a, b), path
    assert len(dict(_leaves(got[0]))) > 100


def test_engine_and_server_restore_pth_like_jax(pth, config):
    jx = JaxEngine(model_path=str(pth), config=config)
    port = InferenceEngine(model_path=str(pth), config=config, device="cpu")
    assert jax.tree_util.tree_structure(port.variables) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jx.variables))

    cams, lidar, radar = detector_inputs(port.spec, batch=1, seed=4)
    sample = {"camera_imgs": cams[0], "lidar_points": lidar[0], "radar_points": radar[0]}
    preds, decoded = port._forward(sample)
    want = jx._apply(jx.variables, *jx._inputs(sample, batch=True))
    for k in MAP_KEYS:
        w = np.asarray(want[k])
        np.testing.assert_allclose(preds[k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
    want_dec = jax_decode(want, max_detections=100, voxel_size=jx.voxel_size, pc_range=jx.spec.bev.pc_range,
                          class_always_zero=jx.compat.decode_class_always_zero)
    want_scores = np.asarray(want_dec["scores"][0])
    scale = np.abs(want_scores).max()
    np.testing.assert_allclose(decoded["scores"][0].numpy(), want_scores, rtol=0, atol=1e-4 * scale)

    # the server restores the same file (f32, BatchNorms unfolded)
    server = InferenceServer(config=config, model_path=str(pth), batch_size=1, score_threshold=0.0,
                             use_bf16=False, fold_bn=False, device="cpu")
    served = server._run_batch([sample])[0]
    np.testing.assert_allclose(np.sort(served["scores"])[::-1], want_scores[want_scores > 0.0], rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("key,what", [
    ("fusion.output_proj.0.weight", "attention fusion"),
    ("fusion.fusion_mlp.0.weight", "late fusion"),
    ("det_head.head.0.weight", "MLP head"),
])
def test_unported_modules_raise(state_dict, key, what, tmp_path, config):
    """The first weight of a module alone (no bias, no other layer): the
    port's conversion raises the KeyError of JAX's, and the engine's
    restore fails naming the missing key."""
    sd = dict(state_dict, **{key: torch.zeros(4, 4)})
    missing = key.replace(".weight", ".bias")
    with pytest.raises(KeyError, match=missing):
        jax_convert.convert_reference_checkpoint(sd)
    with pytest.raises(KeyError, match=missing):
        port_convert.convert_reference_checkpoint(sd)
    path = tmp_path / "other.pth"
    torch.save(sd, path)  # a bare state_dict
    with pytest.raises(RuntimeError, match=f"failed to restore.*{missing}"):
        InferenceEngine(model_path=str(path), config=copy.deepcopy(config), device="cpu")
