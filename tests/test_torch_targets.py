"""The port's CenterNet targets and losses against the JAX package's.

Targets on seeded boxes plus the edge cases the JAX code handles: a box at
world (0, 0) (pixel exactly 25 on the 50x50 grid, just below it in f32
before the snap), one just inside the outer border and one on it (in f32
its pixel lands just below the border, and JAX keeps it), padded
rows at the origin, out-of-range labels, 7- and 9-column boxes, and both
gaussian-radius forms (Q19). Integer outputs are equal and float outputs
within 1e-6, also through `prepare_centernet_targets_host` with M below, at
and above `max_objects` (padded with label -1, or cut). Losses: the focal loss with and without the Q2 double sigmoid,
a regression loss with an all-zero mask, and the whole CenterNet loss dict,
within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.ops import losses as jax_losses
from bevfusion_multimodal_3d_object_detection_tpu.ops import targets as jax_targets
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import losses as port_losses
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import targets as port_targets

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
INT_KEYS = ("ind", "mask", "reg_mask")


def _boxes(n_cols, seed=0):
    """(2, 12, n_cols) boxes and labels: 6 random real boxes per sample,
    then the edge cases, then padded rows."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((2, 12, n_cols), np.float32)
    labels = np.full((2, 12), -1, np.int64)
    for b in range(2):
        boxes[b, :6, 0:2] = rng.uniform(-50, 50, (6, 2))
        boxes[b, :6, 2] = rng.uniform(-2, 1, 6)
        boxes[b, :6, 3:6] = rng.uniform(0.3, 12, (6, 3))  # 12 m: radii differ by form
        boxes[b, :6, 6] = rng.uniform(-np.pi, np.pi, 6)
        boxes[b, :6, 7:] = rng.randn(6, n_cols - 7)
        labels[b, :6] = rng.randint(0, 10, 6)
    edge = {6: (0.0, 0.0), 7: (51.2 - 1e-5, -3.0), 8: (51.2, 2.0), 9: (-51.2, -51.2)}
    for row, (x, y) in edge.items():
        boxes[:, row, 0:2] = (x, y)
        boxes[:, row, 3:6] = (2.0, 4.0, 1.5)
        boxes[:, row, 6] = 0.3
        labels[:, row] = row - 6
    labels[1, 10] = 10  # out of range: treated as padding
    boxes[1, 10, 0:2] = (0.0, 0.0)
    return boxes, labels


@pytest.mark.parametrize("corrected", [False, True], ids=["compat_radius", "corrected_radius"])
@pytest.mark.parametrize("n_cols", [7, 9])
@pytest.mark.parametrize("bev", [(50, 50), (16, 24)])
def test_targets_match_jax(n_cols, corrected, bev):
    boxes, labels = _boxes(n_cols)
    kw = dict(pc_range=PC_RANGE, bev_size=bev, num_classes=10, corrected_gaussian_radius=corrected)
    want = jax_targets.prepare_centernet_targets(jnp.asarray(boxes), jnp.asarray(labels), **kw)
    got = port_targets.prepare_centernet_targets(torch.from_numpy(boxes), torch.from_numpy(labels), **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in INT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    mask = got["reg_mask"].numpy()
    assert mask[:, 6].all() and mask[:, 7].all() and mask[:, 9].all()
    assert not mask[:, 11].any() and not mask[1, 10]
    if bev == (50, 50):  # world (0, 0) is pixel (25, 25) exactly
        assert (got["ind"][:, 6] == 25 * 50 + 25).all()
        assert (got["heatmap"][:, 25, 25, 0] == 1.0).all()
    if n_cols == 7:
        assert not got["target_vel"].any() and not got["vel"].any()


@pytest.mark.parametrize("max_objects", [16, 12, 8])
def test_host_targets_match_jax(max_objects):
    boxes, labels = _boxes(7, seed=3)  # M = 12
    kw = dict(pc_range=PC_RANGE, bev_size=(16, 24), num_classes=10, max_objects=max_objects)
    batch = {"gt_boxes": boxes.astype(np.float64), "gt_labels": labels.tolist()}
    want = jax_targets.prepare_centernet_targets_host(batch, **kw)
    got = port_targets.prepare_centernet_targets_host(batch, **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in INT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    assert got["ind"].shape == (2, max_objects)
    assert int(got["reg_mask"].sum()) == int((labels[:, :max_objects] >= 0).sum()) - (max_objects > 10)


def test_gaussian_radius_forms_differ_for_large_boxes():
    h, w = np.float32([35.0, 2.0]), np.float32([20.0, 3.0])
    for corrected in (False, True):
        want = np.asarray(jax_targets.gaussian_radius(jnp.asarray(h), jnp.asarray(w), corrected=corrected))
        got = port_targets.gaussian_radius(torch.from_numpy(h), torch.from_numpy(w), corrected=corrected)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert int(port_targets.gaussian_radius(torch.tensor(35.0), torch.tensor(20.0))) != int(
        port_targets.gaussian_radius(torch.tensor(35.0), torch.tensor(20.0), corrected=True))


def _maps(rng, b=2, h=16, w=16, c=10):
    return {
        "heatmap": rng.uniform(0.01, 0.99, (b, h, w, c)).astype(np.float32),
        "offset": rng.randn(b, h, w, 2).astype(np.float32),
        "size": rng.randn(b, h, w, 3).astype(np.float32),
        "rot": rng.randn(b, h, w, 2).astype(np.float32),
        "vel": rng.randn(b, h, w, 2).astype(np.float32),
    }


@pytest.mark.parametrize("double_sigmoid", [True, False], ids=["q2", "single_sigmoid"])
def test_centernet_loss_matches_jax(double_sigmoid):
    rng = np.random.RandomState(1)
    preds = _maps(rng)
    boxes, labels = _boxes(9, seed=2)
    t_jax = jax_targets.prepare_centernet_targets(jnp.asarray(boxes), jnp.asarray(labels), bev_size=(16, 16))
    t_port = port_targets.prepare_centernet_targets(torch.from_numpy(boxes), torch.from_numpy(labels),
                                                    bev_size=(16, 16))
    want = jax_losses.centernet_loss({k: jnp.asarray(v) for k, v in preds.items()}, t_jax,
                                     double_sigmoid=double_sigmoid)
    # bf16 predictions are cast to f32 inside
    got = port_losses.centernet_loss({k: torch.from_numpy(v) for k, v in preds.items()}, t_port,
                                     double_sigmoid=double_sigmoid)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-6, err_msg=k)
    hm = torch.from_numpy(preds["heatmap"])
    np.testing.assert_allclose(
        float(port_losses.focal_loss(hm, t_port["heatmap"], double_sigmoid=double_sigmoid)),
        float(jax_losses.focal_loss(jnp.asarray(preds["heatmap"]), t_jax["heatmap"],
                                    double_sigmoid=double_sigmoid)), rtol=1e-6)
    # no positive pixel: the focal loss is the negatives' sum
    empty = torch.zeros_like(t_port["heatmap"])
    np.testing.assert_allclose(
        float(port_losses.focal_loss(hm, empty, double_sigmoid=double_sigmoid)),
        float(jax_losses.focal_loss(jnp.asarray(preds["heatmap"]), jnp.zeros(empty.shape),
                                    double_sigmoid=double_sigmoid)), rtol=1e-6)


def test_regression_loss_with_empty_mask():
    rng = np.random.RandomState(3)
    pred = rng.randn(2, 8, 8, 3).astype(np.float32)
    target = rng.randn(2, 5, 3).astype(np.float32)
    ind = rng.randint(0, 64, (2, 5)).astype(np.int32)
    for mask in (np.zeros((2, 5), np.uint8), np.array([[1, 0, 1, 0, 0], [0, 0, 0, 1, 1]], np.uint8)):
        want = float(jax_losses.regression_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(ind),
                                                jnp.asarray(mask)))
        got = float(port_losses.regression_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                                torch.from_numpy(ind), torch.from_numpy(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        if not mask.any():
            assert got == 0.0
    gathered = port_losses.gather_regression(torch.from_numpy(pred), torch.from_numpy(ind))
    np.testing.assert_array_equal(gathered.numpy(), np.asarray(
        jax_losses.gather_regression(jnp.asarray(pred), jnp.asarray(ind))))
