"""Fused PointNet (kernel B1) in the PyTorch port against the JAX package.

The port's plain version runs on the CPU; the JAX side is the Pallas kernel
in interpret mode (as tests/test_pallas_pointnet.py runs it) or, at a ragged
N, the XLA encoder path. f32 throughout, tolerance 1e-5 (the same f32
arithmetic in another summation order). tests/test_torch_kernels_cuda.py
holds the kernel against its plain version on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.config import (
    LidarEncoderSpec as JaxLidarSpec,
)
from bevfusion_multimodal_3d_object_detection_tpu.models.encoders import (
    PointNetLiDAREncoder as JaxPointNet,
)
from bevfusion_multimodal_3d_object_detection_tpu.ops.pointnet_pallas import (
    fused_pointnet,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.pointnet_fused import (
    pointnet_flops,
    pointnet_fused,
    pointnet_fused_reference,
)

ATOL = 1e-5


def _chain(rng, widths):
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.randn(b) * 0.1).astype(np.float32) for b in widths[1:]]
    return ws, bs


def _points(rng, b, n, c):
    x = rng.randn(b, n, c).astype(np.float32)
    x[0, n // 2:] = 0.0  # zero padding
    x[-1] = 0.0  # a row with every point masked
    return x


@pytest.mark.parametrize("mask_padding", [False, True])
@pytest.mark.parametrize(
    "widths,n,block",
    [((4, 16, 32, 64), 128, 64), ((7, 8, 16, 32), 128, 128)],
    ids=["lidar-like", "radar-like"],
)
def test_reference_matches_pallas_kernel(mask_padding, widths, n, block):
    """N divisible by the block: no padding rows on the JAX side."""
    rng = np.random.RandomState(0)
    ws, bs = _chain(rng, widths)
    x = _points(rng, 3, n, widths[0])
    want = np.asarray(
        fused_pointnet(
            jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
            mask_padding=mask_padding, block_points=block, interpret=True,
        )
    )
    got = pointnet_fused(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], mask_padding=mask_padding,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    if mask_padding:
        assert np.all(got[-1] == 0.0)  # all-masked row -> 0


@pytest.mark.parametrize("mask_padding", [False, True])
def test_ragged_n_matches_xla_encoder(mask_padding):
    """At N = 125 the Pallas wrapper would add zero rows; the port takes the
    max over exactly the N points, like the encoder's own XLA path."""
    import jax

    spec = JaxLidarSpec(max_points=125, mlp_layers=(16, 32), input_channels=4)
    enc = JaxPointNet(spec=spec, mask_padding=mask_padding)
    rng = np.random.RandomState(1)
    x = _points(rng, 2, 125, 4)
    variables = enc.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    want = np.asarray(enc.apply(variables, jnp.asarray(x), train=False))
    p = variables["params"]["point_mlp"]
    s = variables["batch_stats"]["point_mlp"]
    ws, bs = [], []
    for i in (1, 2):
        inv = np.asarray(p[f"bn{i}"]["scale"]) / np.sqrt(np.asarray(s[f"bn{i}"]["var"]) + 1e-5)
        ws.append(torch.from_numpy(np.asarray(p[f"mlp{i}"]["kernel"]) * inv))
        bs.append(torch.from_numpy(
            (np.asarray(p[f"mlp{i}"]["bias"]) - np.asarray(s[f"bn{i}"]["mean"])) * inv
            + np.asarray(p[f"bn{i}"]["bias"])
        ))
    got = pointnet_fused(torch.from_numpy(x), ws, bs, mask_padding).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_bf16_rounds_between_layers():
    """bf16 inputs: every layer's output is rounded to bf16 before the next
    (the Pallas kernel's cast), and the result comes back in bf16."""
    rng = np.random.RandomState(2)
    ws, bs = _chain(rng, (4, 16, 32))
    x = torch.from_numpy(_points(rng, 2, 64, 4)).bfloat16()
    wt = [torch.from_numpy(w).bfloat16() for w in ws]
    bt = [torch.from_numpy(b) for b in bs]
    got = pointnet_fused(x, wt, bt)
    assert got.dtype == torch.bfloat16
    h = torch.relu(x.float() @ wt[0].float() + bt[0]).bfloat16()
    h = torch.relu(h.float() @ wt[1].float() + bt[1]).bfloat16()
    torch.testing.assert_close(got, h.amax(dim=1), atol=0, rtol=0)
    want = np.asarray(
        fused_pointnet(
            jnp.asarray(x.float().numpy(), jnp.bfloat16),
            [jnp.asarray(w.float().numpy(), jnp.bfloat16) for w in wt],
            [jnp.asarray(b) for b in bs], block_points=64, interpret=True,
        ).astype(jnp.float32)
    )
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)


def test_wrapper_checks_inputs():
    x = torch.zeros(2, 8, 4)
    w = [torch.zeros(4, 8)]
    b = [torch.zeros(8)]
    with pytest.raises(TypeError):
        pointnet_fused(x.double(), [w[0].double()], b)
    with pytest.raises(TypeError):
        pointnet_fused(x, w, [b[0].bfloat16()])
    with pytest.raises(ValueError):
        pointnet_fused(x, [torch.zeros(5, 8)], b)  # does not chain
    with pytest.raises(ValueError):
        pointnet_fused(x[0], w, b)  # not (B, N, C)
    with pytest.raises(ValueError):
        pointnet_fused(x, w * 9, b * 9)  # more than 8 layers


def test_cpu_path_does_not_count_launches():
    before = pointnet_fused.launches
    pointnet_fused(torch.ones(1, 4, 4), [torch.ones(4, 8)], [torch.zeros(8)])
    assert pointnet_fused.launches == before


def test_flop_count_matches_issue_figure():
    # 35,000 points through 4->64->128->256->512->1024: ~48.8 GFLOP per sample
    assert round(pointnet_flops(1, 35000, (4, 64, 128, 256, 512, 1024)) / 1e9, 1) == 48.8
