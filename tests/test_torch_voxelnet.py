"""`VFELayer` and `VoxelNetLiDAREncoder` of the PyTorch port against the JAX
package, on the same seeded weights carried over by `load_jax_variables`.

The points: 2 samples of 256, xyz inside `pc_range` plus a few outside it
(clamped to the border voxels), the second half of the second sample zero
padding (sent to the trash voxel); most of the 10x32x32 voxels stay empty.

Limits, f32 on the CPU (jax_default_matmul_precision="highest"): outputs
1e-5 of their largest magnitude; BatchNorm running statistics after a
train-mode forward relative 1e-5 (means 1e-5 of their largest); the
gradients of a train-mode loss 1e-4 of each tensor's largest (a bias right
before a BatchNorm has a zero gradient: below 1e-5 of the largest gradient
anywhere, as in test_torch_train.py). In train mode
the reference is JAX's encoder in float64 (un-jitted, as the train-step
tests run it): flax's f32 BatchNorm computes the batch variance as
E[x^2] - E[x]^2, and over the last conv's 64 values per channel that puts
JAX's own f32 output 2.4e-5 of its largest from float64, while the port's
two-pass variance stays within 1e-6 (measured on the CPU). The scatter-max
gives a voxel's gradient to its largest point, and JAX's ``.at[].max`` and
torch's ``scatter_reduce("amax")`` may split a tie differently, so the
gradients are held on points with distinct features (random coordinates;
after the ReLU the tied zeros carry no gradient in either package). In
bf16 (the model cast; JAX computes in its dtype over f32 parameters, the
port casts its parameters, so each weight is rounded once more) the outputs
agree within 3e-2 of their largest magnitude, the limit of the bf16 train
step in test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.models import encoders as jax_enc
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import encoders as port_enc
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    export_jax_variables,
    load_jax_variables,
)
from torch_port_helpers import random_variables, to_port_spec

KEY = jax.random.PRNGKey(0)
SPEC = jax_config.LidarEncoderSpec(encoder_type="VoxelNet", max_points=256, feat_dim=48)
PC_RANGE = jax_config.BEVFusionSpec().pc_range


def _points(seed=0, b=2, n=256):
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., :2] = rng.uniform(-55.0, 55.0, (b, n, 2))  # a few beyond +-51.2
    pts[..., 2] = rng.uniform(-5.5, 3.5, (b, n))
    pts[..., 3] = rng.uniform(0.0, 1.0, (b, n))
    pts[1, n // 2:] = 0.0
    return pts


def _modules(seed=3, dtype=jnp.float32):
    jax_mod = jax_enc.VoxelNetLiDAREncoder(spec=SPEC, pc_range=PC_RANGE, dtype=dtype)
    variables = random_variables(jax_mod.init({"params": KEY}, jnp.asarray(_points())), seed)
    port = load_jax_variables(port_enc.VoxelNetLiDAREncoder(to_port_spec(SPEC), PC_RANGE), variables)
    return jax_mod, variables, port


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=rel * np.abs(want).max(),
                               err_msg=what)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_voxel_ids_and_empty_voxels():
    """Padding goes to the trash voxel, points outside the range to the
    border voxels, and most voxels stay empty."""
    pts = _points()
    enc = port_enc.VoxelNetLiDAREncoder(to_port_spec(SPEC), PC_RANGE)
    x = torch.from_numpy(pts)
    vid = enc.voxel_ids(x, port_enc.points_validity_mask(x))
    d, h, w = enc.grid
    assert bool((vid[1, 128:] == d * h * w).all()) and bool((vid[:, :128] < d * h * w).all())
    ix = vid % w
    assert int(ix[0].min()) == 0 and int(ix[0].max()) == w - 1
    assert len(torch.unique(vid[0])) < d * h * w // 10


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_voxelnet_encoder(train):
    jax_mod, variables, port = _modules()
    pts = _points()
    port.train(train)
    weights = np.random.RandomState(5).randn(2, SPEC.feat_dim).astype(np.float32)
    if train:
        with jax.enable_x64(True), jax.disable_jit():
            exact = jax_enc.VoxelNetLiDAREncoder(spec=SPEC, pc_range=PC_RANGE, dtype=jnp.float64)
            v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

            def loss(params):
                out, mutated = exact.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                           jnp.asarray(pts, jnp.float64), train=True, mutable=["batch_stats"])
                return jnp.sum(out * weights), (out, mutated["batch_stats"])

            grads, (want, stats) = jax.grad(loss, has_aux=True)(v64["params"])
            grads, want, stats = jax.tree_util.tree_map(np.asarray, (grads, want, stats))
    else:
        want = jax_mod.apply(variables, jnp.asarray(pts))
    got = port(torch.from_numpy(pts))
    _close(got.detach().numpy(), want, 1e-5)
    if not train:
        return
    (got * torch.from_numpy(weights)).sum().backward()
    mine = export_jax_variables(port)
    for name, v in _leaves(stats).items():
        got_v = _leaves(mine["batch_stats"])[name]
        if name.endswith("['var']"):
            np.testing.assert_allclose(got_v, v, rtol=1e-5, err_msg=name)
        else:
            _close(got_v, v, 1e-5, name)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(p.grad)
    port_grads = _leaves(export_jax_variables(port)["params"])
    grads = _leaves(grads)
    largest = max(np.abs(g).max() for g in grads.values())
    for name, g in grads.items():
        if np.abs(g).max() < 1e-9 * largest:  # a bias right before a BatchNorm: zero gradient
            assert np.abs(port_grads[name]).max() <= 1e-5 * largest, name
        else:
            _close(port_grads[name], g, 1e-4, name)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_voxelnet_bf16_cast(train):
    """The model cast to bf16: the point MLP follows the cast (it is never
    folded into B1), against JAX's encoder in bf16 over the same f32
    parameters."""
    jax_mod, variables, port = _modules(dtype=jnp.bfloat16)
    port = port.to(torch.bfloat16).train(train)
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    pts = _points(seed=1)
    if train:
        want, _ = jax_mod.apply(variables, jnp.asarray(pts, jnp.bfloat16), train=True, mutable=["batch_stats"])
    else:
        want = jax_mod.apply(variables, jnp.asarray(pts, jnp.bfloat16))
    with torch.no_grad():
        got = port(torch.from_numpy(pts).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), 3e-2)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vfe_layer(train, masked):
    """Dense + BatchNorm + ReLU, then the per-voxel max concatenated onto
    each point (unused by the JAX detector too)."""
    rng = np.random.RandomState(7)
    x = rng.randn(6, 5, 4).astype(np.float32)
    mask = rng.rand(6, 5, 1) > 0.4
    mask[0] = False  # a voxel with no point: its max is 0
    jax_mod = jax_enc.VFELayer(out_channels=16)
    jmask = jnp.asarray(mask) if masked else None
    variables = random_variables(jax_mod.init({"params": KEY}, jnp.asarray(x), jmask), 8)
    port = load_jax_variables(port_enc.VFELayer(4, 16), variables).train(train)
    if train:
        want, _ = jax_mod.apply(variables, jnp.asarray(x), jmask, train=True, mutable=["batch_stats"])
    else:
        want = jax_mod.apply(variables, jnp.asarray(x), jmask)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask) if masked else None)
    assert got.shape == (6, 5, 16)
    _close(got.numpy(), want, 1e-5)
