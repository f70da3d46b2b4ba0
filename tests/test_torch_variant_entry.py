"""The MLP-head variants through the port's entry points, against the JAX
package: the engine's MLP branch, the eval CLI (which decodes CenterNet
maps only, in both packages), reference-layout `.pth` state_dicts with
attention-fusion, late-fusion and MLP-head keys, and `InferenceServer`
refusing an MLP head.

Limits: the engine's `cls`/`box` within 1e-5 of their largest magnitude and
the same label (the argmax's margin is checked to exceed that); the
converted trees equal leaf for leaf, bit for bit; the restored models'
outputs within 1e-4 of their largest magnitude (full-width encoders; the
port folds the point encoders' BatchNorms into B1's weights, JAX does not).
"""

import copy
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bevfusion_multimodal_3d_object_detection_tpu import inference_engine as jax_engine
from bevfusion_multimodal_3d_object_detection_tpu.config import DetectorSpec as JaxSpec
from bevfusion_multimodal_3d_object_detection_tpu.config import load_config
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector as JaxDetector
from bevfusion_multimodal_3d_object_detection_tpu.utils import reference_convert as jax_convert
from bevfusion_multimodal_3d_object_detection_tpu.utils.torch_baseline import TorchReferenceDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch import eval as port_eval
from bevfusion_multimodal_3d_object_detection_tpu_torch import inference_engine as port_engine
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import SyntheticNuScenesDataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import reference_convert as port_convert
from test_reference_checkpoint import _reference_style_state_dict
from torch_port_helpers import detector_inputs, random_variables
from torch_trainer_helpers import jax_native_of_its_own  # noqa: F401 (autouse: JAX's LiDAR prep of the module's own)
from torch_trainer_helpers import tree_config, write_test_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _late_config(tmp_path, fusion="late", modality="camera+lidar+radar"):
    cfg = tree_config(tmp_path, tmp_path / "data", modality=modality)
    cfg["model"]["fusion_type"] = fusion
    cfg["model"]["attention_fusion"].update(hidden_dim=64, num_heads=2)
    cfg["model"]["late_fusion"].update(output_dim=48, hidden_dims=[96])
    cfg["model"]["mlp_head"]["hidden_dims"] = [32]
    return cfg


@pytest.mark.parametrize("fusion", ["late", "attention"])
def test_engine_mlp_branch_matches_jax(tmp_path, fusion, capsys):
    """One detection: the box, the softmax probability of the most probable
    class and zero velocities, as JAX's engine gives it (inference_engine.py
    :288-299), and the same P/R/F1."""
    cfg = _late_config(tmp_path, fusion)
    spec = JaxSpec.from_config(cfg)
    args = tuple(jnp.asarray(a[:1]) for a in detector_inputs(spec, batch=1))
    variables = random_variables(JaxDetector(spec=spec).init({"params": jax.random.PRNGKey(0)}, *args), seed=4)
    sample = SyntheticNuScenesDataset(num_samples=1, image_size=spec.camera.image_size,
                                      max_points=spec.lidar.max_points,
                                      max_radar_points=spec.radar.max_points_per_sensor, seed=2)[0]
    jx = jax_engine.InferenceEngine(config=cfg)
    jx.variables = variables
    port = port_engine.InferenceEngine(config=cfg, device="cpu")
    port._set_variables(variables)

    preds, decoded = port._forward(sample)
    assert decoded is None
    want = jx._apply(jx.variables, *jx._inputs(sample, batch=True))
    for k in ("cls", "box"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(preds[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    logits = np.sort(np.asarray(want["cls"][0]))
    assert logits[-1] - logits[-2] > 1e-5 * np.abs(logits).max()  # the argmax is not a tie

    got, ref = port.run_inference(sample, visualize=False), jx.run_inference(sample, visualize=False)
    g, w = got["detections"], ref["detections"]
    assert set(g) == set(w) and g["labels"].tolist() == w["labels"].tolist()
    assert g["boxes"].shape == w["boxes"].shape == (1, 7) and not g["velocities"].any()
    np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-5 * np.abs(w["boxes"]).max())
    np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-6)
    for k in ("precision", "recall", "f1", "tp", "fp", "fn"):
        assert got[k] == ref[k], k
    assert got["latency_s"] > 0


def test_eval_cli_refuses_the_mlp_head_like_jax(tmp_path, monkeypatch):
    """The eval CLI decodes CenterNet maps. JAX's runs its MLP-head model
    and then fails in `decode_to_host` on {'cls', 'box'} (KeyError); the
    port raises before loading anything, naming the reason."""
    cfg = _late_config(tmp_path, modality="lidar+radar")
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "base.yaml").write_text(yaml.safe_dump(cfg))  # Q10: the model config
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="MLP head"):
        port_eval.main("configs/base.yaml", device="cpu")
    write_test_tree(tmp_path / "data", samples_per_split=2, splits=("val",))
    monkeypatch.setenv("BMOD_ALLOW_RANDOM_INIT", "1")
    spec = importlib.util.spec_from_file_location("jax_eval_cli", ROOT / "eval.py")
    jax_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval)
    with pytest.raises(KeyError, match="boxes"):
        jax_eval.main("configs/base.yaml")


def test_server_refuses_the_mlp_head(tmp_path):
    with pytest.raises(ValueError, match="JAX server has only the CenterNet decode"):
        InferenceServer(config=_late_config(tmp_path), device="cpu")


@pytest.fixture(scope="module")
def reference_encoders():
    """The encoders' keys of a reference-layout state_dict
    (`TorchReferenceDetector`, full width, seeded BatchNorm statistics)."""
    torch.manual_seed(1)
    model = TorchReferenceDetector().eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    sd = _reference_style_state_dict(model)
    return {k: v.numpy() for k, v in sd.items() if k.startswith(("camera_encoder.", "lidar_encoder.",
                                                                 "radar_encoder."))}


def _global_fusion_keys(fusion, rng, hid=64, ffn=256, layers=2, late=(96, 48), mlp=32):
    """Seeded reference keys of attention or late fusion over the full-width
    encoders (camera 512, LiDAR 1024, radar 256) and of the MLP head
    (utils/reference_convert.py:22-32 of the JAX package)."""
    widths = {"camera": 512, "lidar": 1024, "radar": 256}
    sd = {}

    def linear(name, out, inp):
        sd[f"{name}.weight"] = (rng.randn(out, inp) / np.sqrt(inp)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.randn(out)).astype(np.float32)

    if fusion == "attention":
        for mod, embed in (("camera", "cam"), ("lidar", "lidar"), ("radar", "radar")):
            linear(f"fusion.{mod}_proj", hid, widths[mod])
            sd[f"fusion.{embed}_pos_embed"] = rng.randn(1, 1, hid).astype(np.float32)
        for i in range(layers):
            base = f"fusion.self_attention_layers.{i}"
            for part in ("query", "key", "value", "out"):
                linear(f"{base}.self_attn.{part}", hid, hid)
            linear(f"{base}.ffn.0", ffn, hid)
            linear(f"{base}.ffn.3", hid, ffn)
            for norm in ("norm1", "norm2"):
                sd[f"{base}.{norm}.weight"] = rng.uniform(0.5, 1.5, hid).astype(np.float32)
                sd[f"{base}.{norm}.bias"] = (0.1 * rng.randn(hid)).astype(np.float32)
        linear("fusion.output_proj.0", hid, hid)
        linear("fusion.output_proj.3", hid, hid)
        fused = hid
    else:
        linear("fusion.fusion_mlp.0", late[0], sum(widths.values()))
        linear("fusion.fusion_mlp.3", late[1], late[0])
        fused = late[1]
    linear("det_head.head.0", mlp, fused)
    linear("det_head.head.3", 17, mlp)
    return sd


def _pth_config(fusion):
    """base.yaml at full encoder widths with 32x64 cameras, 64 LiDAR and 16
    radar points per sensor, and the fusion and MLP head at test width."""
    cfg = load_config(str(ROOT / "configs" / "base.yaml"))
    m = cfg["model"]
    m["fusion_type"] = fusion
    m["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["cameras"]["image_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 64, "radar_per_sensor": 16}
    m["attention_fusion"].update(hidden_dim=64, num_heads=2)
    m["late_fusion"].update(output_dim=48, hidden_dims=[96])
    m["mlp_head"]["hidden_dims"] = [32]
    return cfg


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("fusion", ["attention", "late"])
def test_reference_pth_with_global_fusion(reference_encoders, fusion, tmp_path):
    """A reference-layout state_dict with the fusion's and the MLP head's
    keys: the port's and JAX's conversions are equal bit for bit (the
    fusion's statistics an empty subtree in both, never merged), and the
    port's engine restoring the `.pth` agrees with JAX's model on the
    merged tree."""
    sd = dict(reference_encoders, **_global_fusion_keys(fusion, np.random.RandomState(3)))
    got = port_convert.convert_reference_checkpoint(sd)
    want = jax_convert.convert_reference_checkpoint(sd)
    for g, w in zip(got, want):  # params, batch_stats
        g, w = dict(_leaves(g)), dict(_leaves(w))
        assert set(g) == set(w)
        for path, a in w.items():
            assert a.dtype == g[path].dtype and np.array_equal(a, g[path]), path
    assert got[1]["fusion"] == {} and want[1]["fusion"] == {}

    path = tmp_path / "reference.pth"
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    cfg = _pth_config(fusion)
    port = port_engine.InferenceEngine(model_path=str(path), config=copy.deepcopy(cfg), device="cpu")
    assert "fusion" not in port.variables["batch_stats"]
    for leaf_path, value in _leaves(got[0]):  # every mapped leaf was restored
        v = port.variables["params"]
        for k in leaf_path:
            v = v[k]
        assert np.array_equal(v, value), leaf_path
    spec = JaxSpec.from_config(cfg)
    cams, lidar, radar = detector_inputs(spec, batch=1, seed=4)
    sample = {"camera_imgs": cams[0], "lidar_points": lidar[0], "radar_points": radar[0]}
    preds, _ = port._forward(sample)
    want_out = JaxDetector(spec=spec).apply(port.variables, *map(jnp.asarray, (cams, lidar, radar)))
    for k in ("cls", "box"):
        w = np.asarray(want_out[k])
        np.testing.assert_allclose(preds[k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
