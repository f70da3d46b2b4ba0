"""PyTorch-port modules and the whole detector against the JAX package, on
the same seeded weights carried over by `load_jax_variables`.

f32 on the CPU with jax_default_matmul_precision="highest" (conftest):
tolerance 1e-4 absolute on O(1) activations (convolutions summed in another
order through up to ~15 layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.models import detector as jax_det
from bevfusion_multimodal_3d_object_detection_tpu.models import encoders as jax_enc
from bevfusion_multimodal_3d_object_detection_tpu.models import fusion as jax_fusion
from bevfusion_multimodal_3d_object_detection_tpu.models import heads as jax_heads
from bevfusion_multimodal_3d_object_detection_tpu.utils.fold_bn import (
    fold_bn_params as jax_fold_bn_params,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import detector as port_det
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import encoders as port_enc
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import fusion as port_fusion
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import heads as port_heads
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    load_jax_variables,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.device import (
    resolve_device,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.fold_bn import (
    fold_bn_params,
)
from torch_port_helpers import (
    detector_inputs,
    narrow_spec,
    nchw,
    numpy_tree,
    random_variables,
    to_port_spec,
)

ATOL = 1e-4
KEY = jax.random.PRNGKey(0)


def _init(module, *args, seed=0, **kw):
    return random_variables(module.init({"params": KEY}, *args, **kw), seed)


def _port(module, variables):
    return load_jax_variables(module, variables).eval()


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_camera_encoder(fold):
    spec = narrow_spec()
    x = np.random.RandomState(0).randn(2, 6, 32, 64, 3).astype(np.float32)
    jax_mod = jax_enc.ResNetCameraEncoder(spec=spec.camera)
    variables = _init(jax_mod, jnp.asarray(x))
    want = np.asarray(jax_mod.apply(variables, jnp.asarray(x)))
    if fold:
        folded = {"params": jax_fold_bn_params(variables["params"], variables["batch_stats"])}
        want_folded = np.asarray(
            jax_enc.ResNetCameraEncoder(spec=spec.camera, fold_bn=True).apply(
                folded, jnp.asarray(x)
            )
        )
        np.testing.assert_allclose(want_folded, want, atol=ATOL)
        variables = {"params": fold_bn_params(variables["params"], variables["batch_stats"])}
    port = _port(port_enc.ResNetCameraEncoder(to_port_spec(spec.camera), fold_bn=fold), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).numpy()
    np.testing.assert_allclose(got, np.transpose(want, (0, 1, 4, 2, 3)), atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mask_padding", [False, True])
def test_lidar_encoder(mask_padding, train):
    """Eval runs the fused PointNet's plain version with BN folded; train
    runs the plain MLP with BatchNorm batch statistics."""
    spec = narrow_spec().lidar
    x = np.random.RandomState(1).randn(2, 256, 4).astype(np.float32)
    x[0, 100:] = 0.0
    jax_mod = jax_enc.PointNetLiDAREncoder(spec=spec, mask_padding=mask_padding)
    variables = _init(jax_mod, jnp.asarray(x))
    if train:
        want, _ = jax_mod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jax_mod.apply(variables, jnp.asarray(x))
    port = _port(port_enc.PointNetLiDAREncoder(to_port_spec(spec), mask_padding), variables)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        # the (B, C, N) layout is accepted too
        got_cn = port(torch.from_numpy(x).transpose(1, 2)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_cn, got, atol=1e-6)


@pytest.mark.parametrize("method", ["concat", "max", "mean"])
def test_multi_radar_encoder(method):
    import dataclasses

    spec = dataclasses.replace(narrow_spec().radar, fusion_method=method)
    x = np.random.RandomState(2).randn(2, 5, 16, 7).astype(np.float32)
    jax_mod = jax_enc.MultiRadarEncoder(spec=spec)
    variables = _init(jax_mod, jnp.asarray(x))
    want = np.asarray(jax_mod.apply(variables, jnp.asarray(x)))
    port = _port(port_enc.MultiRadarEncoder(to_port_spec(spec)), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_point_encoder_folds_once_until_weights_change():
    """Eval folds BN into the weights once per dtype; an in-place update, a
    train-mode step (running stats) or a dtype change folds again."""
    enc = port_enc.PointNetLiDAREncoder(to_port_spec(narrow_spec().lidar)).eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 4).astype(np.float32))

    def plain():  # the unfused MLP with BN running statistics
        return enc.point_mlp(x).amax(dim=1)

    with torch.inference_mode():
        first = enc(x)
        cached = enc._fold_cache[1][0]
        enc(x)
        assert enc._fold_cache[1][0] is cached
    torch.testing.assert_close(first, plain(), atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        enc.point_mlp.bn1.running_var.mul_(2.0)
        enc.point_mlp.mlp2.bias.add_(0.5)
    torch.testing.assert_close(enc(x), plain(), atol=1e-5, rtol=1e-5)
    enc.train()
    enc(x)  # updates the running statistics
    enc.eval()
    torch.testing.assert_close(enc(x), plain(), atol=1e-5, rtol=1e-5)
    got = enc(x.bfloat16())
    assert got.dtype == torch.bfloat16 and enc._fold_cache[1][0].dtype == torch.bfloat16
    enc.double().float()  # replaces every tensor
    assert enc._fold_cache is None
    torch.testing.assert_close(enc(x), plain(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bev", [16, 8], ids=["upsample", "downsample"])
def test_bev_fusion_pseudo(bev):
    """bev 8: the LiDAR branch shrinks 10x10 -> 8x8, where
    jax.image.resize antialiases."""
    spec = narrow_spec(bev=bev).bev
    rng = np.random.RandomState(3)
    cam = rng.randn(2, 6, 2, 4, 512).astype(np.float32)
    lidar = rng.randn(2, 64).astype(np.float32)
    radar = rng.randn(2, 32).astype(np.float32)
    jax_mod = jax_fusion.FlexibleBEVFusion(spec=spec)
    args = tuple(jnp.asarray(a) for a in (cam, lidar, radar))
    variables = _init(jax_mod, *args)
    want = np.asarray(jax_mod.apply(variables, *args))
    port = _port(
        port_fusion.FlexibleBEVFusion(
            to_port_spec(spec), camera_channels=512, lidar_channels=64, radar_channels=32
        ),
        variables,
    )
    with torch.no_grad():
        got = port(
            torch.from_numpy(cam).permute(0, 1, 4, 2, 3), torch.from_numpy(lidar),
            torch.from_numpy(radar),
        ).numpy()
    np.testing.assert_allclose(got, nchw(want), atol=ATOL)


@pytest.mark.parametrize("size", [(8, 8), (3, 5), (20, 7)], ids=["same", "down", "mixed"])
def test_bilinear_resize(size):
    x = np.random.RandomState(4).randn(2, 10, 6, 3).astype(np.float32)
    want = np.asarray(jax_fusion.bilinear_resize(jnp.asarray(x), *size))
    got = port_fusion.bilinear_resize(torch.from_numpy(nchw(x)), *size).numpy()
    np.testing.assert_allclose(got, nchw(want), atol=1e-5)


def test_centernet_head():
    spec = narrow_spec().centernet
    x = np.random.RandomState(5).randn(2, 16, 16, 32).astype(np.float32)
    jax_mod = jax_heads.CenterNetHead(spec=spec)
    variables = _init(jax_mod, jnp.asarray(x))
    want = jax_mod.apply(variables, jnp.asarray(x))
    port = _port(port_heads.CenterNetHead(to_port_spec(spec)), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(nchw(x)))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), nchw(np.asarray(v)), atol=ATOL, err_msg=k)


def test_centernet_head_init():
    head = port_heads.CenterNetHead(to_port_spec(narrow_spec().centernet))
    head.reset_parameters(torch.Generator().manual_seed(0))
    w = head.heatmap_head.conv1.weight
    assert abs(w.std().item() - 0.001) < 2e-4
    assert torch.all(head.offset_head.conv2.bias == 0)
    torch.testing.assert_close(
        head.heatmap_head.conv2.bias, torch.full((10,), -np.log(99.0), dtype=torch.float32)
    )


@pytest.mark.parametrize(
    "modality", ["camera+lidar+radar", "lidar+radar", "camera"]
)
def test_detector_forward(modality):
    spec = narrow_spec(modality)
    inputs = detector_inputs(spec)
    jax_model = jax_det.MultiModal3DDetector(spec=spec)
    args = tuple(jnp.asarray(a) for a in inputs)
    variables = _init(jax_model, *args, seed=7)
    want = jax_model.apply(variables, *args)
    port = _port(port_det.MultiModal3DDetector(to_port_spec(spec)), variables)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in inputs))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape  # NHWC at the public boundary
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=ATOL, err_msg=k)


def test_load_jax_variables_is_strict():
    spec = narrow_spec("radar")
    inputs = detector_inputs(spec)
    variables = numpy_tree(
        jax_det.MultiModal3DDetector(spec=spec).init(
            {"params": KEY}, None, None, jnp.asarray(inputs[2])
        )
    )
    model = port_det.MultiModal3DDetector(to_port_spec(spec))
    load_jax_variables(model, variables)  # the full tree loads
    extra = {
        "params": dict(variables["params"], bogus={"kernel": np.zeros((2, 2))}),
        "batch_stats": variables["batch_stats"],
    }
    with pytest.raises(KeyError, match="bogus"):
        load_jax_variables(model, extra)
    missing = {"params": dict(variables["params"]), "batch_stats": {}}
    with pytest.raises(KeyError, match="running_mean"):
        load_jax_variables(model, missing)
    shape = numpy_tree(variables)
    shape["params"]["det_head"]["size_head"]["conv2"]["bias"] = np.zeros(4)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(model, shape)


def test_unported_options_raise():
    import dataclasses

    spec = to_port_spec(narrow_spec())
    for mode in ("scatter", "culled"):  # geometric splats not ported yet
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_det.MultiModal3DDetector(dataclasses.replace(spec, bev=dataclasses.replace(
                spec.bev, camera_to_bev="geometric", splat_mode=mode)))


def test_seeded_init_is_reproducible():
    spec = to_port_spec(narrow_spec("lidar"))
    a = port_det.MultiModal3DDetector(spec).init_weights(torch.Generator().manual_seed(3))
    b = port_det.MultiModal3DDetector(spec).init_weights(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_missing_gpu_raises_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
