"""The port's point preprocessing against the JAX package's
(ops/preprocess.py:53-107).

`filter_pad_points` without a generator equals JAX's exactly (the same f32
values, so no tolerance): padding, truncation, the strict range test on
boundary points and the original order of the valid points. With a
generator the draw differs from JAX's key by design, so the checks are of
the contract: every row a valid input point, each at most once, as many as
`max_points` allows, the same rows under one seed. The radar noise: shape,
dtype, standard-normal moments within 0.05, repeatable under one seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.ops import preprocess as jax_pre
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import preprocess as port_pre

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


def _points(seed, b, n, c=5):
    """Gaussian points about half in range, plus boundary rows on every
    face of the range (excluded: the test is strict)."""
    rng = np.random.RandomState(seed)
    pts = (rng.randn(b, n, c) * np.array([40, 40, 4] + [1] * (c - 3))).astype(np.float32)
    for i, (axis, v) in enumerate([(0, 51.2), (0, -51.2), (1, 51.2), (1, -51.2), (2, 3.0), (2, -5.0)]):
        pts[:, i, :3] = 1.0
        pts[:, i, axis] = v
    return pts


@pytest.mark.parametrize("n,max_points,out_channels", [(300, 512, 4), (300, 64, 4), (300, 300, 5), (7, 7, 3)])
def test_filter_pad_points_matches_jax(n, max_points, out_channels):
    pts = _points(0, 3, n)
    want = np.asarray(jax_pre.filter_pad_points(
        jnp.asarray(pts), max_points=max_points, out_channels=out_channels, pc_range=PC_RANGE))
    got = port_pre.filter_pad_points(
        torch.from_numpy(pts), max_points=max_points, out_channels=out_channels, pc_range=PC_RANGE).numpy()
    assert got.shape == want.shape == (3, max_points, out_channels) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not (got[:, :, :3] == 1.0).all(axis=-1).any()  # no boundary row kept


def test_filter_pad_points_packs_and_pads():
    """JAX's own case (tests/test_preprocess.py:32-50) on the port."""
    pts = np.zeros((1, 6, 5), np.float32)
    pts[0, 0] = [10, 10, 0, 1, 9]
    pts[0, 1] = [999, 0, 0, 2, 9]
    pts[0, 2] = [-20, 30, -1, 3, 9]
    pts[0, 3] = [0, 0, -10, 4, 9]
    pts[0, 4] = [51.2, 0, 0, 5, 9]
    pts[0, 5] = [1, 1, 1, 6, 9]
    out = port_pre.filter_pad_points(torch.from_numpy(pts), max_points=8, out_channels=4,
                                     pc_range=PC_RANGE).numpy()
    np.testing.assert_array_equal(out[0, :3], [[10, 10, 0, 1], [-20, 30, -1, 3], [1, 1, 1, 6]])
    np.testing.assert_array_equal(out[0, 3:], 0.0)


@pytest.mark.parametrize("max_points", [64, 1024])
def test_filter_pad_points_subsample_with_generator(max_points):
    pts = _points(1, 2, 500)
    x = torch.from_numpy(pts)
    out = port_pre.filter_pad_points(x, max_points=max_points, out_channels=4, pc_range=PC_RANGE,
                                     generator=torch.Generator().manual_seed(0)).numpy()
    again = port_pre.filter_pad_points(x, max_points=max_points, out_channels=4, pc_range=PC_RANGE,
                                       generator=torch.Generator().manual_seed(0)).numpy()
    other = port_pre.filter_pad_points(x, max_points=max_points, out_channels=4, pc_range=PC_RANGE,
                                       generator=torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_array_equal(out, again)
    ordered = port_pre.filter_pad_points(x, max_points=500, out_channels=4, pc_range=PC_RANGE).numpy()
    for b in range(2):
        valid = {tuple(r) for r in ordered[b].tolist() if any(r)}
        rows = [tuple(r) for r in out[b].tolist()]
        real = [r for r in rows if any(r)]
        assert len(real) == min(max_points, len(valid))
        assert len(set(real)) == len(real) and set(real) <= valid
        assert all(not any(r) for r in rows[len(real):])  # zeros after the real rows
    if max_points < 200:
        assert not np.array_equal(out, other)


def test_radar_noise_shape_and_seed():
    g = lambda seed: torch.Generator().manual_seed(seed)
    out = port_pre.preprocess_radar_noise(g(0), batch=3)
    want_shape = jax_pre.preprocess_radar_noise(jnp.asarray(np.array([0, 0], np.uint32)), batch=3).shape
    assert out.shape == want_shape == (3, 5, 125, 7) and out.dtype == torch.float32
    torch.testing.assert_close(out, port_pre.preprocess_radar_noise(g(0), batch=3), rtol=0, atol=0)
    assert not torch.equal(out, port_pre.preprocess_radar_noise(g(1), batch=3))
    small = port_pre.preprocess_radar_noise(g(2), batch=2, num_radars=1, max_points=4, channels=3)
    assert small.shape == (2, 1, 4, 3)
    assert abs(out.mean().item()) < 0.05 and abs(out.std().item() - 1.0) < 0.05
